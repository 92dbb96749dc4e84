"""The whole OPA-DPO pipeline rehearsed through the port's own entry
points, with per-stage seconds in one JSON record.  Counterpart of
``scripts/e2e_rehearsal.py``.

    python -m opadpo_torch.tools.e2e_rehearsal [--model 7b|tiny]
        [--n-prompts 8] [--response-len 128] [--dpo-steps 2]
        [--rollout-batch 4] [--pope-questions N] [--scale]
        [--bits 16|8|4] [--workdir DIR] [--bench-record PATH ...]
        [--device cuda|cpu] [--out PATH]

The stages, in order, each through its entry point:

1. ``rollout_generation``: ``pipeline/online_generation.run`` over
   ``--n-prompts`` seeded prompt rows, in the dry mode of the GPT-4V
   service (no ``API_KEY``: no network), then ``_inject_fake_reports``,
   the stub that writes schema-exact correction reports into the shards;
2. ``dataset_build``: ``pipeline/dataset_ops.build_opadpo_datasets``;
3. ``opa_sft``: ``pipeline/opa_train.train`` with the vision adapter;
4. ``opa_dpo``: ``pipeline/opadpo_train.train`` from stage 3's adapter
   (``policy_lora_dir``, as ``recipes/train_opa_dpo.sh`` chains them);
5. ``pope_eval``: ``eval/run_all.main --benchmarks pope`` over
   ``--pope-questions`` seeded questions (the same file for the three
   splits) with stage 4's adapter.

The stages share one model: random weights from a seed at ``--bits``
(LLaVA-1.5-7B, or the tiny one), or the model given to ``run``; each
entry point's set-up is handed it in place of a draw of its own.  The
base is frozen in every stage, so sharing it changes no stage's numbers.
The data helpers are copies of the JAX script's (``_make_prompt_dataset``,
``_inject_fake_reports``, ``_pope_questions``) and need PIL and
``datasets``; the tokenizer is the character-level one
(``data/char_tokenizer``).  The record holds the stages' seconds under the
JAX script's names, ``steady_state`` (the stages' step timers, the first
step left out), ``pope_num_examples``, ``total_seconds``, and where stage
3's checkpoint and stage 4's adapter were written.  ``projection_check``
holds each steady rate against the port's own bench records given by
``--bench-record`` (``bench_decode``, ``bench_train`` in its modes), the
ratio and whether it is off by more than 20 %.

Flags of the JAX script that steer only XLA or the TPU are not carried
over: ``--platform`` (``--device`` takes its place).
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import io
import json
import os
import shutil
import statistics
import tempfile
import time

from opadpo_torch.tools import common

TOOL = "e2e_rehearsal"
# environment variables the entry points read in place of their configs
STAGE_ENV = ("OUTPUT_DIR", "MODEL_DIR", "DATA_DIR", "IMAGE_DIR",
             "POLICY_LORA_DIR", "API_KEY", "API_KEY0", "API_NUM")
POPE_SPLITS = ("random", "popular", "adversarial")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--n-prompts", type=int, default=8)
    ap.add_argument("--response-len", type=int, default=128)
    ap.add_argument("--pope-questions", type=int, default=0,
                    help="POPE question count (default: --n-prompts)")
    ap.add_argument("--dpo-steps", type=int, default=2)
    ap.add_argument("--rollout-batch", type=int, default=4,
                    help="the rollout's per-device batch")
    ap.add_argument("--scale", action="store_true",
                    help="production scale: 64 prompts, 896-token rollouts "
                         "at batch 16, stage 4 at its recipe's shapes, "
                         "128 POPE questions")
    ap.add_argument("--bits", type=int, default=16, choices=(16, 8, 4),
                    help="the shared model's base when it is drawn")
    ap.add_argument("--bench-record", action="append", default=[],
                    help="a bench_decode / bench_train record for the "
                         "projection check (repeatable)")
    ap.add_argument("--seed", type=int, default=0)
    common.add_device_args(ap, TOOL, models=("7b", "tiny"))
    args = ap.parse_args(argv)
    if args.scale:
        args.n_prompts = max(args.n_prompts, 64)
        args.response_len = 896
        args.rollout_batch = 16
        args.pope_questions = max(args.pope_questions, 128)
    return args


# ---------------------------------------------------------------------------
# The JAX script's data helpers
# ---------------------------------------------------------------------------

def _make_prompt_dataset(path: str, n: int) -> None:
    import numpy as np
    from datasets import Dataset
    from PIL import Image

    rng = np.random.default_rng(0)
    imgs = []
    for _ in range(n):
        arr = rng.integers(0, 255, (224, 224, 3), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        imgs.append(base64.b64encode(buf.getvalue()).decode())
    Dataset.from_dict({
        "queries": [f"<image>\nDescribe scene number {i}." for i in range(n)],
        "image_bytes": imgs,
        "standard_response": [f"A standard description of scene {i}, "
                              "with several visible objects."
                              for i in range(n)],
        "image_id": [f"img{i}.png" for i in range(n)],
    }).save_to_disk(path)


def _inject_fake_reports(rollout_dir: str) -> None:
    """Stand-in for the GPT-4V correction API (dry mode leaves reports
    empty): write schema-exact reports so the dataset filters keep rows."""
    for name in sorted(os.listdir(rollout_dir)):
        p = os.path.join(rollout_dir, name)
        with open(p) as f:
            records = json.load(f)
        for rec in records:
            resp = rec["original_generate_response"] or "placeholder resp"
            rec["original_generate_response"] = resp
            rec["AI_pseudo_response"] = "A corrected, grounded answer."
            rec["AI_json_report"] = json.dumps({
                "sentence_1": {"copied content": resp, "score": 2,
                               "error type": "image_recognition_error",
                               "rewritten content":
                                   "A corrected, grounded answer."},
                "Added": {"rewritten content": ""},
            })
        with open(p, "w") as f:
            json.dump(records, f)


def _pope_questions(path: str, img_dir: str, n: int) -> None:
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(3)
    os.makedirs(img_dir, exist_ok=True)
    with open(path, "w") as f:
        for i in range(n):
            name = f"pope{i}.png"
            Image.fromarray(rng.integers(0, 255, (224, 224, 3),
                                         dtype=np.uint8)).save(
                os.path.join(img_dir, name))
            f.write(json.dumps({
                "question_id": i, "image": name,
                "text": f"Is there a dog in the image {i}?",
                "label": "yes" if i % 2 == 0 else "no",
            }) + "\n")


# ---------------------------------------------------------------------------
# The shared model and the clean environment
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def shared_model(model):
    """While open, ``pipeline.runtime.setup_model``, which every entry
    point calls through the module, hands out ``model`` (on the mesh the
    entry point made, which must be one process's)."""
    from opadpo_torch.parallel.mesh import single_mesh
    from opadpo_torch.pipeline import runtime

    def given(model_dir=None, vision_dir=None, *, mesh=None, device="cuda",
              **_):
        mesh = mesh or single_mesh(device)
        if mesh.model != 1 or mesh.data != 1:
            raise ValueError("the rehearsal runs one process (mesh 1 x 1)")
        return model.cfg, model, mesh

    saved = runtime.setup_model
    runtime.setup_model = given
    try:
        yield
    finally:
        runtime.setup_model = saved


@contextlib.contextmanager
def clean_env():
    """The entry points' environment overrides unset (no ``API_KEY``: the
    correction service runs dry, no network), restored after."""
    saved = {k: os.environ.pop(k) for k in STAGE_ENV if k in os.environ}
    try:
        yield
    finally:
        for k in STAGE_ENV:
            os.environ.pop(k, None)
        os.environ.update(saved)


def _steady(history, name):
    """Median seconds of a step timer's ``name`` entries, the first left
    out when there are more than two."""
    secs = [e["seconds"] for e in history if e["name"] == name]
    if len(secs) > 2:
        secs = secs[1:]
    return statistics.median(secs) if secs else None


def _bench(paths) -> dict:
    """The port's bench records by what they measured."""
    out = {}
    for path in paths:
        with open(path) as f:
            rec = json.load(f)
        tool = rec.get("tool")
        if tool == "bench_decode":
            out["rollout_tokens_per_sec"] = rec["tokens_per_sec"]
        elif tool == "bench_train":
            out[f"{rec['mode']}_seconds_per_step"] = rec["seconds_per_step"]
    return out


def _check(out, name, measured, bench_val):
    if measured is None or not bench_val:
        return
    ratio = measured / bench_val
    out[name] = {"composed": measured, "bench": bench_val, "ratio": ratio,
                 "off_by_gt_20pct": bool(abs(ratio - 1.0) > 0.20)}


# ---------------------------------------------------------------------------
# The rehearsal
# ---------------------------------------------------------------------------

def run(args, model=None) -> dict:
    """The rehearsal on ``model`` (drawn from ``--seed`` at ``--bits`` when
    None) -> the record."""
    import torch

    from opadpo_torch.data.char_tokenizer import CharTokenizer
    from opadpo_torch.eval import run_all
    from opadpo_torch.pipeline import (
        dataset_ops, online_generation, opa_train, opadpo_train,
    )
    from opadpo_torch.pipeline.checkpoints import ADAPTER_MODEL_DIR
    from opadpo_torch.pipeline.config import Config

    if model is None:
        dev = common.device_of(args)
        _, model, _ = common.make_model(args.model, args.bits, dev,
                                        args.seed)
    dev = common.model_device(model)
    tiny = model.cfg.llama.num_layers < 8
    own_work = args.workdir is None
    work = args.workdir or tempfile.mkdtemp(prefix="e2e_rehearsal_")
    os.makedirs(work, exist_ok=True)
    qlen = 64 if tiny else 128
    rlen = 8 if tiny else args.response_len
    lora = dict(lora_r=4 if tiny else 64, lora_alpha=8 if tiny else 128)
    rollout_numerics = ({} if tiny else
                        {"kv_bits": 8, "head_bits": 4, "decode_chunk": 256})
    n_pope = args.pope_questions or args.n_prompts

    def cfg(out_dir, data_path, top=(), **training):
        return Config({
            "debug": {"fake_tokenizer": True},
            "model": {"skip_loading_weights": True}, "mesh": {"model": 1},
            "data": {"data_path": data_path}, **dict(top),
            "training": {"output_dir": out_dir, "seed": args.seed,
                         "device": dev.type, **training}})

    stages, timers = {}, {}
    t_all = time.perf_counter()

    @contextlib.contextmanager
    def timed(name):
        print(f"=== stage: {name}", flush=True)
        t0 = time.perf_counter()
        ok = False
        try:
            yield
            ok = True
        finally:
            common.sync(dev)
            stages[name] = time.perf_counter() - t0
            print(f"=== stage {name}: {stages[name]:.1f} s "
                  f"({'ok' if ok else 'FAILED'})", flush=True)

    prompts = os.path.join(work, "prompts")
    _make_prompt_dataset(prompts, args.n_prompts)
    gen_out = os.path.join(work, "gen")
    opa_data = os.path.join(work, "opa_data")
    dpo_data = os.path.join(work, "dpo_data")
    opa_out = os.path.join(work, "opa_out")
    dpo_out = os.path.join(work, "dpo_out")
    rollout_dir = os.path.join(gen_out, "rollouts")
    with clean_env(), shared_model(model):
        with timed("rollout_generation"):
            timers["rollout"] = online_generation.run(cfg(
                gen_out, prompts, response_len=rlen, query_len=qlen,
                rollout_per_device_batch_size=(1 if tiny
                                               else args.rollout_batch),
                top_k=30, top_p=0.95, **rollout_numerics))
            _inject_fake_reports(rollout_dir)
        with timed("dataset_build"):
            dataset_ops.build_opadpo_datasets([rollout_dir], opa_data,
                                              dpo_data)
        with timed("opa_sft"):
            timers["sft"] = opa_train.train(cfg(
                opa_out, opa_data, num_train_epochs=1,
                per_device_train_batch_size=1 if tiny else 4,
                gradient_accumulation_steps=1, save_steps=1000,
                query_len=qlen, response_len=max(rlen, 32), logging_steps=1,
                tune_vision_tower=True, **lora))
        opa_adapter = os.path.join(opa_out, "checkpoint-final",
                                   ADAPTER_MODEL_DIR, "lora_policy")
        n_batch = min(args.n_prompts, 32)
        per_dev = 1 if tiny else 2
        nopt = 1 if tiny else 2
        with timed("opa_dpo"):
            timers["dpo"] = opadpo_train.train(cfg(
                dpo_out, dpo_data, top={"policy_lora_dir": opa_adapter},
                total_epochs=1, max_step=args.dpo_steps,
                rollout_batch_size=n_batch, step_batch_size=n_batch,
                rollout_per_device_batch_size=per_dev,
                step_per_device_batch_size=per_dev, noptepochs=nopt,
                save_steps=1000,
                query_len=qlen if args.scale else 256,
                response_len=rlen if args.scale else max(rlen // 2, 16),
                CoPO=True, CoPO_method="random", AncPO=True, warmup_steps=0,
                **lora))
        dpo_steps = [e for e in timers["dpo"].history
                     if e["name"] == "train"] if timers["dpo"] else []
        dpo_adapter = os.path.join(dpo_out, f"checkpoint-{len(dpo_steps)}",
                                   ADAPTER_MODEL_DIR, "lora_policy")
        if not os.path.isdir(dpo_adapter):
            raise RuntimeError(f"stage 4 wrote no adapter at {dpo_adapter} "
                               f"({len(dpo_steps)} steps)")

        data_root = os.path.join(work, "eval")
        img_dir = os.path.join(work, "pope_imgs")
        os.makedirs(os.path.join(data_root, "pope"), exist_ok=True)
        first = os.path.join(data_root, "pope", "coco_pope_random.jsonl")
        _pope_questions(first, img_dir, n_pope)
        for split in POPE_SPLITS[1:]:
            shutil.copyfile(first, os.path.join(
                data_root, "pope", f"coco_pope_{split}.jsonl"))
        with timed("pope_eval"):
            results, runs = run_all.main(
                ["--model-path", work, "--adapter-path", dpo_adapter,
                 "--data-root", data_root, "--image-root", img_dir,
                 "--output-dir", os.path.join(work, "eval_out"),
                 "--benchmarks", "pope", "--batch-size", "4",
                 "--device", str(dev)], tokenizer=CharTokenizer())

    steady = {}
    samples = [e for e in timers["rollout"].history if e["name"] == "sample"]
    roll_s = _steady(samples, "sample")
    if roll_s:
        rows = samples[-1].get("rows", 1 if tiny else args.rollout_batch)
        steady["rollout_tokens_per_sec"] = rlen * rows / roll_s
    sft_s = _steady(timers["sft"].history, "sft_step")
    if sft_s:
        steady["sft_seconds_per_microstep"] = sft_s
    if dpo_steps:
        steady["dpo_seconds_per_logged_step"] = (
            _steady(timers["dpo"].history, "rollout")
            + _steady(timers["dpo"].history, "train"))
    bench = _bench(args.bench_record)
    projection = {}
    _check(projection, "rollout_tokens_per_sec",
           steady.get("rollout_tokens_per_sec"),
           bench.get("rollout_tokens_per_sec"))
    _check(projection, "sft_seconds_per_step",
           steady.get("sft_seconds_per_microstep"),
           bench.get("sft_seconds_per_step"))
    if bench.get("dpo_seconds_per_step") and \
            bench.get("rollout_seconds_per_step") is not None:
        micro = n_batch // per_dev
        _check(projection, "dpo_seconds_per_step",
               steady.get("dpo_seconds_per_logged_step"),
               micro * (bench["rollout_seconds_per_step"]
                        + nopt * bench["dpo_seconds_per_step"]))
    pope = [results[f"pope_{s}"]["num_examples"] for s in POPE_SPLITS]
    n_steps = len(dpo_steps)
    ran = {"rollout_samples": [{k: e[k] for k in ("rows", "decode_steps")
                                if k in e} for e in samples],
           "sft_micro_steps": sum(e["name"] == "sft_step"
                                  for e in timers["sft"].history),
           "dpo_rollout_scores": n_steps * (n_batch // per_dev),
           "dpo_train_steps": n_steps * nopt * (n_batch // per_dev),
           "pope_batches": [{k: b[k] for k in ("batch_rows", "decode_steps",
                                               "prompt_positions")}
                            for s in POPE_SPLITS
                            for b in runs[f"pope_{s}"]["batches"]]}
    record = {
        "tool": TOOL, "card": common.card_line(dev), "model": args.model,
        "device": dev.type, "n_prompts": args.n_prompts,
        "response_len": rlen, "dpo_steps": len(dpo_steps),
        "pope_questions": n_pope,
        "numerics": {"bits": common.base_bits(model)},
        "rollout_numerics": {"bits": common.base_bits(model),
                             **rollout_numerics},
        "stage_seconds": stages, "steady_state": steady,
        "projection_check": projection,
        "total_seconds": time.perf_counter() - t_all,
        "pope_num_examples": pope[0], "pope_num_examples_by_split": pope,
        "pope_seconds_by_split": {s: runs[f"pope_{s}"]["seconds"]
                                  for s in POPE_SPLITS},
        "stage3_checkpoint": os.path.relpath(
            os.path.join(opa_out, "checkpoint-final"), work),
        "stage4_adapter": os.path.relpath(dpo_adapter, work),
        "workdir": None if own_work else work, "ran": ran,
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "note": "random-init weights; rehearses the composed pipeline's "
                "set-up, memory and time, not model quality",
    }
    if own_work:
        shutil.rmtree(work, ignore_errors=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return record


def main(argv=None) -> int:
    args = parse_args(argv)
    rec = run(args)
    print(json.dumps(rec), flush=True)
    common.write_record(rec, args.out or common.default_out(TOOL))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
