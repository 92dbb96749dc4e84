"""Stages 1-2, on-policy rollout with GPT-4V correction.  Port of
``opadpo_tpu/pipeline/online_generation.py``.

Reference: ``opadpo/online_generation.py`` + ``Online_Generator``
(``generator_models/online_generator.py``).  Per step: sample responses
on the GPU (temperature 1.0, top_k 30, top_p 0.95, response_len 896 --
run/online_generate.sh:75-77,115-116) with ``engine/sampler.Sampler``,
truncate after EOS / '?' tokens, decode, then one GPT-4V correction call
per sample (``correct_one``), and write ``rollouts/step{N}_rank{R}.json``
shards; a rerun resumes after the last shard of its rank
(``checkpoints.find_max_step``).  The corrections of step N run on a
thread pool while step N + 1 samples, and step N's shard is written then.

With no ``API_KEY0`` / ``API_KEY`` in the environment the responses pass
through uncorrected (the dry run).  Several processes split the rows
``RANK::WORLD_SIZE`` (``data/loading.ShardedDataset``).  Each step's draws
come from a generator seeded from (seed, step, rank), so a resumed run
samples what an uninterrupted one would.  With
``training.continuous_slots`` N > 0 the rows go through the slot-pool
engine (``engine/continuous.py``: N slots, int8 pool, or int4 at
``kv_bits`` 4, segments of ``continuous_seg_len``), whose draws come from
one generator seeded at seed + 1000 + rank.

    python -m opadpo_torch.pipeline.online_generation \\
        --config configs/llava_online_generation.yaml [key.path=value ...]

With ``mesh.model`` 1 the ranks need no process group: each process
takes its rows by ``RANK`` / ``WORLD_SIZE`` alone.  With ``mesh.model``
2 (the 13B config) the ranks run under ``torchrun`` as a ``data x model``
mesh (``parallel/mesh.py``): the rows are split over the data ranks only,
the ranks of a model group sample their rows together (tensor-parallel
decode, ``engine/sampler.py``) and only its model rank 0 calls GPT-4V and
writes ``step{N}_rank{R}.json``, R its data rank.  The continuous engine
runs there too: the ranks of a model group feed one pool the same rows in
the same order, its generator seeded at seed + 1000 + data rank on each.

One GPU a rank (``training.device``, default cuda; ``cpu`` runs the
plain versions).  ``run`` also takes the tokenizer and the data module as
arguments, for machines without ``transformers`` or ``datasets``.
"""

from __future__ import annotations

import argparse
import base64
import concurrent.futures
import json
import logging
import os
import re
import time
from typing import Dict, Optional

import numpy as np
import torch

from opadpo_torch.constants import LLAMA_NL_QMARK_TOKEN, LLAMA_QMARK_TOKEN
from opadpo_torch.data.char_tokenizer import CharTokenizer
from opadpo_torch.data.datasets import make_rollout_data_module
from opadpo_torch.data.image_processing import set_pil_preprocess
from opadpo_torch.data.loading import DataLoader, ShardedDataset
from opadpo_torch.engine.sampler import Sampler, truncate_after_tokens
from opadpo_torch.engine.serving_config import (
    make_continuous_engine, make_serving_sampling,
)
from opadpo_torch.models.loader import adapter_scaling, load_peft_adapter
from opadpo_torch.parallel.mesh import MeshConfig, make_mesh
from opadpo_torch.parallel.sharding import shard_lora
from opadpo_torch.pipeline import checkpoints as ckpt_lib
from opadpo_torch.pipeline.config import (
    Config, apply_overrides, load_config, save_config,
)
from opadpo_torch.pipeline.gpt4v_client import APIService, get_api_service
from opadpo_torch.pipeline.opadpo_train import rollout_generator
from opadpo_torch.pipeline.prompts import build_correction_messages
from opadpo_torch.pipeline import runtime
from opadpo_torch.pipeline.runtime import (
    StepTimer, batch_to_device, load_tokenizer,
)

logger = logging.getLogger("online_generation")

_JSON_FENCE_RE = re.compile(r"```(?:json)?\s*(.*?)\s*```", re.DOTALL)


def parse_correction_report(text: str, original_response: str) -> Dict:
    """GPT-4V output -> dict(report, AI_pseudo, copied, success): the
    rewritten sentences joined (the "Added" entry's too), the copied ones
    (not "Added"'s).  On any parse failure the raw response stands in for
    both (reference online_generator.py:214-224; the dataset filters drop
    such rows later)."""
    try:
        m = _JSON_FENCE_RE.search(text)
        payload = m.group(1) if m else text
        start, end = payload.find("{"), payload.rfind("}")
        report = json.loads(payload[start:end + 1])
        rewritten, copied = [], []
        for key, entry in report.items():
            if not isinstance(entry, dict):
                continue
            if key in ("image_description", "image description"):
                continue
            rw = entry.get("rewritten_content",
                           entry.get("rewritten content", ""))
            if rw:
                rewritten.append(rw.strip())
            if key != "Added":
                cp = entry.get("copied_content",
                               entry.get("copied content", ""))
                if cp:
                    copied.append(cp.strip())
        ai_pseudo = " ".join(rewritten).strip()
        copied_joined = " ".join(copied).strip()
        if not ai_pseudo:
            raise ValueError("empty rewritten content")
        return {"report": json.dumps(report), "AI_pseudo": ai_pseudo,
                "copied": copied_joined, "success": True}
    except Exception as e:
        logger.warning("report parse failed (%s); using raw response", e)
        return _uncorrected(original_response)


def _uncorrected(response: str) -> Dict:
    return {"report": "", "AI_pseudo": response, "copied": response,
            "success": False}


def correct_one(api: APIService, question: str, response: str,
                image_b64: str, standard_response: str = "") -> Dict:
    """One correction call; a failed call passes the response through."""
    try:
        messages = build_correction_messages(
            question, response, image_b64,
            standard_response=standard_response)
        text = api.call_llm_with_messages(messages)
        return parse_correction_report(text, response)
    except Exception as e:
        logger.warning("GPT-4V call failed: %s", e)
        return _uncorrected(response)


def _generate_continuous(engine, batch, response_len: int,
                         pad_id: int) -> np.ndarray:
    """A loader batch's rows through the slot-pool engine -> tokens [n,
    response_len], pad after each row's end, in row order."""
    n = len(batch["queries"])
    rids = [engine.add_request(np.asarray(batch["queries"][i]),
                               np.asarray(batch["query_attn_masks"][i]),
                               np.asarray(batch["images"][i]))
            for i in range(n)]
    order = {rid: i for i, rid in enumerate(rids)}
    tokens = np.full((n, response_len), pad_id, np.int64)
    while engine.has_work():
        for rid, toks in engine.step():
            tokens[order[rid], :len(toks)] = toks[:response_len]
    return tokens


def run(cfg: Config, tokenizer=None,
        data_module: Optional[dict] = None) -> StepTimer:
    """Run stages 1-2 as ``cfg`` says -> the step timer (one ``sample``
    entry per step sampled; none when every step's shard exists)."""
    t = cfg.training if "training" in cfg else Config()
    if bool(t.get("pil_preprocess", False)):
        # strict HF-numerics image path (native C++ JPEG pipeline off)
        set_pil_preprocess(True)
    fused = bool(t.get("fused_attention", True))
    runtime.check_fused_attention(fused, t.get("device", "cuda"))
    n_model = int(cfg.get_path("mesh.model", 1))
    output_dir = os.environ.get("OUTPUT_DIR", cfg.get_path(
        "training.output_dir", "./output"))
    rollout_dir = os.path.join(output_dir, "rollouts")
    logging.basicConfig(level=logging.INFO)

    tiny = bool(cfg.get_path("debug.tiny", False))
    seed = int(t.get("seed", 42))
    model_dir = os.environ.get("MODEL_DIR", cfg.get_path("base_model"))
    # the multi-rank fan-out: each data rank takes rows rank::world, picks
    # its API key as rank % API_NUM and writes step{N}_rank{R}.json shards
    # (reference generator.py:87-93 + record_step_stats); at mesh.model 1
    # the ranks share nothing and start no process group, a model group's
    # ranks share their rows and its model rank 0 writes
    llava_cfg, model, mesh = runtime.setup_model(
        model_dir,
        vision_dir=cfg.get_path("image_checkpoint"),
        skip_loading_weights=bool(cfg.get_path("model.skip_loading_weights",
                                               False)),
        tiny=tiny, seed=seed,
        bits=int(t.get("bits", 16)),
        act_bits=int(t.get("act_bits", 16)),
        act_outlier_cols=int(t.get("act_outlier_cols", 0)),
        act_bwd_int8=bool(t.get("act_bwd_int8", False)),
        fused_attention=fused,
        mesh=make_mesh(MeshConfig(model=n_model), t.get("device", "cuda"),
                       group=n_model > 1))
    dev, rank, world = mesh.device, mesh.data_rank, mesh.data
    writer = mesh.model_rank == 0
    if writer:
        os.makedirs(rollout_dir, exist_ok=True)
        save_config(cfg, output_dir)

    lora, lora_scaling = None, 1.0
    adapter_dir = os.environ.get("POLICY_LORA_DIR",
                                 cfg.get_path("policy_lora_dir"))
    if adapter_dir and os.path.isdir(adapter_dir):
        lora = load_peft_adapter(adapter_dir, llava_cfg.llama, device=dev)
        lora = shard_lora(lora, mesh)
        lora_scaling = adapter_scaling(adapter_dir)

    if tokenizer is None:
        if tiny or bool(cfg.get_path("debug.fake_tokenizer", False)):
            tokenizer = CharTokenizer()
        else:
            tokenizer = load_tokenizer(model_dir)
    query_len = int(t.get("query_len", 128))
    response_len = int(t.get("response_len", 896))
    sampling = make_serving_sampling(
        temperature=float(t.get("temperature", 1.0)),
        top_k=int(t.get("top_k", 30)),
        top_p=float(t.get("top_p", 0.95)),
        topk_impl=str(t.get("topk_impl", "sort")),
        eos_token_id=tokenizer.eos_token_id,
        pad_token_id=tokenizer.pad_token_id,
        max_new_tokens=response_len)

    if data_module is None:
        data_module = make_rollout_data_module(
            tokenizer, os.environ.get("DATA_DIR",
                                      cfg.get_path("data.data_path")),
            image_dir=os.environ.get("IMAGE_DIR"), query_len=query_len,
            image_size=llava_cfg.vision.image_size)
    dataset = data_module["train_dataset"]
    if world > 1:
        dataset = ShardedDataset(dataset, rank, world)
    loader = DataLoader(dataset, data_module["data_collator"],
                        batch_size=int(t.get("rollout_per_device_batch_size",
                                             8)),
                        shuffle=False, drop_last=False)
    start_step = ckpt_lib.find_max_step(rollout_dir, rank=rank)
    logger.info("rank %d/%d resuming at rollout step %d / %d", rank, world,
                start_step, len(loader))

    api = get_api_service(rank=rank, cache_path=os.path.join(
        output_dir, f"history_rank{rank}.sqlite" if world > 1
        else "history.sqlite")) if writer else None
    dry_run_api = not (os.environ.get("API_KEY0")
                       or os.environ.get("API_KEY")) or not writer
    if dry_run_api and writer:
        logger.warning("no API_KEY configured: responses pass through "
                       "uncorrected (degraded mode)")

    sampler = Sampler(sampling, lora_scaling=lora_scaling,
                      kv_bits=int(t.get("kv_bits", 16)),
                      head_bits=int(t.get("head_bits", 16)),
                      chunk=int(t.get("decode_chunk", 0)))
    # continuous_slots N > 0: generation through the slot-pool engine, so a
    # row that ends early frees its slot for the next query (one engine per
    # data rank; its draws from seed + 1000 + data rank, the same on each
    # model rank of the group, which feeds it the same rows)
    engine = None
    slots = int(t.get("continuous_slots", 0))
    if slots:
        engine = make_continuous_engine(
            model, sampling, lora=lora, lora_scaling=lora_scaling,
            slots=slots, qlen=query_len,
            seg_len=int(t.get("continuous_seg_len", 64)),
            kv_bits=4 if int(t.get("kv_bits", 16)) == 4 else 8,
            head_bits=int(t.get("head_bits", 16)),
            generator=torch.Generator(device=dev).manual_seed(
                seed + 1000 + rank))
    timer = StepTimer()

    def flush(step_idx: int, futures, records) -> None:
        for rec, fut in zip(records, futures):
            result = (fut.result() if fut is not None
                      else _uncorrected(rec["original_generate_response"]))
            rec["AI_pseudo_response"] = result["AI_pseudo"]
            rec["AI_json_report"] = result["report"]
            rec["API_success"] = result["success"]
        path = os.path.join(rollout_dir, f"step{step_idx}_rank{rank}.json")
        with open(path, "w") as f:
            json.dump(records, f)
        logger.info("wrote %s (%d records)", path, len(records))

    pool = concurrent.futures.ThreadPoolExecutor(
        max_workers=int(os.environ.get("API_WORKERS", "8")))
    pending = None       # (step_idx, futures, records)
    try:
        for step_idx, batch in enumerate(loader, start=1):
            if step_idx <= start_step:
                continue
            t0 = time.time()
            if engine is not None:
                tokens = _generate_continuous(engine, batch, response_len,
                                              tokenizer.pad_token_id)
            else:
                db = batch_to_device({k: batch[k] for k in
                                      ("queries", "query_attn_masks",
                                       "images")}, dev)
                with torch.inference_mode():
                    tokens = sampler.generate(
                        model, db["queries"], db["query_attn_masks"],
                        db["images"],
                        rollout_generator(dev, seed, step_idx, rank),
                        lora=lora).cpu().numpy()
            tokens = truncate_after_tokens(
                tokens, tokenizer.eos_token_id,
                tokenizer.pad_token_id,
                additional_tokens=(LLAMA_QMARK_TOKEN, LLAMA_NL_QMARK_TOKEN))
            texts = tokenizer.batch_decode(tokens, skip_special_tokens=True)
            ran = ({} if engine is not None else
                   {"decode_steps": sampler.stats[-1]["decode_steps"]})
            timer.record("sample", time.time() - t0, rows=len(texts), **ran)

            records, futures = [], []
            for i, text in enumerate(texts):
                # the reference rollout JSON's record schema, so either
                # package's dataset_ops merges either's shards
                rec = {
                    "query": batch["query_text"][i],
                    "image_id": batch["image_id"][i],
                    "standard_response": batch["standard_response_text"][i],
                    "original_generate_response": text.strip(),
                    "image_bytes": batch["image_bytes"][i],
                }
                records.append(rec)
                if dry_run_api:
                    futures.append(None)
                    continue
                img_b64 = rec["image_bytes"]
                if isinstance(img_b64, bytes):
                    img_b64 = base64.b64encode(img_b64).decode()
                futures.append(pool.submit(
                    correct_one, api, rec["query"],
                    rec["original_generate_response"], img_b64,
                    rec["standard_response"]))
            # the previous step's shard is written while this step's
            # corrections run and before the next step samples
            if pending is not None:
                flush(*pending)
            pending = (step_idx, futures, records) if writer else None
            logger.info("step %d sampled %d responses in %.1fs", step_idx,
                        len(texts), timer.history[-1]["seconds"])
        if pending is not None:
            flush(*pending)
    finally:
        pool.shutdown(wait=True)
    logger.info("rollout complete")
    return timer


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Online generation (one GPU)")
    p.add_argument("--config",
                   default="configs/llava_online_generation.yaml")
    p.add_argument("overrides", nargs="*", help="key.path=value overrides")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.overrides)
    run(cfg)


if __name__ == "__main__":
    main()
