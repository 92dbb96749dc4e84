"""Stage 4, the OPA-DPO training driver.  Port of
``opadpo_tpu/pipeline/opadpo_train.py``.

Per step: (a) draw ``rollout_accumulation_steps`` query batches and score
them under the frozen reference adapter (``engine/dpo.rollout_score``, in
``reward_model_per_device_batch_size`` sub-batches), keeping the results on
the device; (b) ``noptepochs`` passes of minibatch ``dpo_train_step``s over
the cached rollouts, in a numpy permutation per (seed, step, epoch), the
optimizer averaging ``grad_accum`` micro-steps; (c) every ``save_steps``
a ``checkpoint-N`` (``pipeline/checkpoints``), and the ``completed``
marker at the end.  A resumed run fast-forwards the data loader and
restores the adapter and optimizer.  ``profile_start_step`` N > 0 traces
steps N+1 ... N+3 to ``output_dir/profile/`` (``runtime.
maybe_start_profiler``; a trace still open at the end is written then).

The rollout's random draws (the CoPO masks) come from one
``torch.Generator`` per (seed, step, chunk), seeded from those three
numbers (and the data rank, over several), so a resumed run repeats an
uninterrupted one exactly (the JAX package folds the same three numbers
into its key).

    python -m opadpo_torch.pipeline.opadpo_train --config configs/llava_dpo.yaml \\
        [key.path=value ...]
    torchrun --nproc-per-node N -m opadpo_torch.pipeline.opadpo_train ...

Under ``torchrun`` (``parallel/mesh.py``) the ranks form a ``data x model``
mesh with ``mesh.model`` as the config says: the loader yields the JAX
package's global batch of ``per_device x n_data`` rows and data rank d
takes rows ``[d per_device, (d + 1) per_device)``; each rank scores its
rows and permutes its own rollouts for the minibatches (the reference's
DDP recipe does the same; the JAX program permutes the global rows, so a
step whose one minibatch is the whole rollout is the same step in both);
the optimizer averages the gradients over the data group with ZeRO-1
moments; global rank 0 logs and writes the checkpoints.

One GPU a rank (``training.device``, default cuda: ``cuda:{LOCAL_RANK}``;
``cpu`` runs the plain versions over gloo).  ``train`` also takes the
tokenizer and the data module as arguments, for machines without
``transformers`` or ``datasets``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from opadpo_torch.data.char_tokenizer import CharTokenizer
from opadpo_torch.data.datasets import make_dpo_data_module
from opadpo_torch.data.image_processing import set_pil_preprocess
from opadpo_torch.data.loading import DataLoader, InfiniteLoader
from opadpo_torch.engine import dpo as dpo_engine
from opadpo_torch.engine.dpo import DpoConfig
from opadpo_torch.engine.train_state import AdamW, OptimizerConfig, TrainState
from opadpo_torch.models import llava as llava_model
from opadpo_torch.models.loader import load_peft_adapter
from opadpo_torch.models.lora import LoraConfig, make_trainable, tree_map
from opadpo_torch.parallel import comm
from opadpo_torch.parallel.mesh import MeshConfig, make_mesh
from opadpo_torch.parallel.sharding import shard_lora
from opadpo_torch.pipeline import checkpoints as ckpt_lib
from opadpo_torch.pipeline.config import (
    Config, apply_overrides, load_config, save_config,
)
from opadpo_torch.pipeline import runtime
from opadpo_torch.pipeline.runtime import (
    StepTimer, batch_to_device, load_tokenizer,
)
from opadpo_torch.utils.metrics import MetricsLogger

logger = logging.getLogger("opadpo_train")


def rollout_generator(device: torch.device, seed: int, step: int,
                      chunk: int, data_rank: Optional[int] = None
                      ) -> torch.Generator:
    """The generator of one rollout chunk, seeded from (seed, step, chunk)
    alone, and the data rank when there are several (the ranks of one
    model group draw the same masks)."""
    key = (seed, step, chunk) if data_rank is None else \
        (seed, step, chunk, data_rank)
    state = np.random.SeedSequence(key).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def _dpo_config(t: Config, scaling: float) -> DpoConfig:
    return DpoConfig(
        beta=float(t.get("beta", 0.1)),
        label_smoothing=float(t.get("label_smoothing", 0.0)),
        temperature=float(t.get("temperature", 1.0)),
        reference_free=bool(t.get("reference_free", False)),
        f_divergence_type=str(t.get("f_divergence_type", "reverse_kl")),
        standard_pair_coef=float(t.get("standard_pair_coef", 1.0)),
        AI_pair_coef=float(t.get("AI_pair_coef", 1.0)),
        CoPO=bool(t.get("CoPO", True)),
        CoPO_method=str(t.get("CoPO_method", "random")),
        CoPO_mask_ratio=float(t.get("CoPO_mask_ratio", 0.3)),
        CoPO_coef=float(t.get("CoPO_coef", 0.2)),
        AncPO=bool(t.get("AncPO", True)),
        mDPO_anchor=bool(t.get("mDPO_anchor", True)),
        Anchor_value=float(t.get("Anchor_value", 0.0)),
        Anchor_coef=float(t.get("Anchor_coef", 1.0)),
        detailed_report=bool(t.get("detailed_report", True)),
        response_score=bool(t.get("response_score", True)),
        response_image_relation=bool(t.get("response_image_relation", True)),
        response_len=int(t.get("response_len", 896)),
        query_len=int(t.get("query_len", 128)),
        lora_scaling=scaling,
        shared_prefix=bool(t.get("shared_prefix", True)),
    )


def train(cfg: Config, tokenizer=None, data_module: Optional[dict] = None
          ) -> Optional[StepTimer]:
    """Run stage 4 as ``cfg`` says -> the step timer (None when the output
    directory already holds a completed run, which returns at once)."""
    t = cfg.training
    if bool(t.get("pil_preprocess", False)):
        # strict HF-numerics image path (native C++ JPEG pipeline off)
        set_pil_preprocess(True)
    fused = bool(t.get("fused_attention", True))
    runtime.check_fused_attention(fused, t.get("device", "cuda"))
    output_dir = os.environ.get("OUTPUT_DIR", t.get("output_dir", "./output"))
    logging.basicConfig(level=logging.INFO)
    last_ckpt, completed = ckpt_lib.get_last_checkpoint(output_dir)
    if completed:
        logger.info("training already completed")
        return None

    tiny = bool(cfg.get_path("debug.tiny", False))
    seed = int(t.get("seed", 42))
    model_dir = os.environ.get("MODEL_DIR", cfg.get_path("base_model"))
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
        mesh=make_mesh(MeshConfig(model=int(cfg.get_path("mesh.model", 1))),
                       t.get("device", "cuda")))
    dev, n_data, main = mesh.device, mesh.data, mesh.is_main
    if main:
        os.makedirs(output_dir, exist_ok=True)
        save_config(cfg, output_dir)

    lora_cfg = LoraConfig(rank=int(t.get("lora_r", 256)),
                          alpha=float(t.get("lora_alpha", 512)))
    dpo_cfg = _dpo_config(t, lora_cfg.scaling)

    # --- adapters: policy (trainable) + frozen reference, shared base ---
    policy_lora_dir = os.environ.get("POLICY_LORA_DIR",
                                     cfg.get_path("policy_lora_dir"))
    if policy_lora_dir and os.path.isdir(policy_lora_dir) and not tiny:
        logger.info("loading OPA adapter from %s", policy_lora_dir)
        policy_lora = load_peft_adapter(policy_lora_dir, llava_cfg.llama,
                                        device=dev)
    else:
        logger.info("bootstrapping fresh init adapter (reference "
                    "opadpo_train.py:735-763)")
        policy_lora = llava_model.init_lora(
            llava_cfg, lora_cfg,
            torch.Generator(device=dev).manual_seed(seed))
    policy_lora = shard_lora(policy_lora, mesh)
    ref_lora = tree_map(lambda x: x.detach().clone(), policy_lora)

    # --- batch math (reference opadpo_train.py:383-439) ---
    rollout_batch = int(t.get("rollout_batch_size", 64))
    step_batch = int(t.get("step_batch_size", 32))
    rollout_per_dev = int(t.get("rollout_per_device_batch_size", 2))
    step_per_dev = int(t.get("step_per_device_batch_size", 2))
    noptepochs = int(t.get("noptepochs", 1))
    rollout_global = rollout_per_dev * n_data
    step_global = step_per_dev * n_data
    assert rollout_batch % rollout_global == 0
    assert step_batch % step_global == 0
    assert rollout_batch % step_batch == 0
    rollout_accum = rollout_batch // rollout_global
    grad_accum = step_batch // step_global

    opt = AdamW(OptimizerConfig(
        learning_rate=float(t.get("learning_rate", 1e-6)),
        lr_scheduler_type=str(t.get("lr_scheduler_type", "cosine")),
        warmup_steps=int(t.get("warmup_steps", 5)),
        total_steps=int(t.get("max_step", 500)),
        weight_decay=float(t.get("weight_decay", 0.0)),
        max_grad_norm=float(t.get("max_grad_norm", 1.0)),
        grad_accum_steps=grad_accum,
    ), mesh)
    state = TrainState.create(make_trainable(policy_lora), opt.cfg, mesh)

    # --- data ---
    if tokenizer is None:
        if tiny or bool(cfg.get_path("debug.fake_tokenizer", False)):
            tokenizer = CharTokenizer()
        else:
            tokenizer = load_tokenizer(model_dir,
                                       int(t.get("model_max_length", 2048)))
    if data_module is None:
        data_module = make_dpo_data_module(
            tokenizer, os.environ.get("DATA_DIR",
                                      cfg.get_path("data.data_path")),
            image_dir=os.environ.get("IMAGE_DIR"),
            query_len=dpo_cfg.query_len, response_len=dpo_cfg.response_len,
            detailed_report=dpo_cfg.detailed_report,
            image_size=llava_cfg.vision.image_size)
    loader = InfiniteLoader(DataLoader(
        data_module["train_dataset"], data_module["data_collator"],
        batch_size=rollout_global, shuffle=True, drop_last=True, seed=seed))

    # --- resume ---
    start_step = 1
    if last_ckpt is not None and bool(t.get("resume_from_training", True)):
        ckpt_lib.restore_train_state(last_ckpt, state, llava_cfg.llama,
                                     mesh=mesh)
        start_step = ckpt_lib.parse_checkpoint_step(last_ckpt) + 1
        logger.info("resumed from %s at step %d", last_ckpt, start_step)

    total_epochs = int(t.get("total_epochs", 4))
    dataset_len = len(data_module["train_dataset"])
    total_steps = min((dataset_len * total_epochs) // rollout_batch,
                      int(t.get("max_step", 500)))
    save_steps = int(t.get("save_steps", 100))
    sub_bs = t.get("reward_model_per_device_batch_size")
    sub_bs = int(sub_bs) if sub_bs else rollout_per_dev
    assert rollout_per_dev % sub_bs == 0
    rows = slice(mesh.data_rank * rollout_per_dev,
                 (mesh.data_rank + 1) * rollout_per_dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    timer = StepTimer()
    metrics = MetricsLogger(output_dir, run_name="opadpo",
                            report_to=str(t.get("report_to", "jsonl"))) \
        if main else None

    profile_at = int(t.get("profile_start_step", 0))

    for step_idx in range(1, total_steps + 1):
        if step_idx < start_step:
            for _ in range(rollout_accum):
                next(loader)                 # dataloader fast-forward
            continue

        # -- rollout: reference scoring, cached on the device --
        t0 = time.time()
        chunk_idx = 0
        rollouts: List[Dict[str, torch.Tensor]] = []
        for _ in range(rollout_accum):
            host_batch = {k: v[rows] if isinstance(v, np.ndarray) else v
                          for k, v in next(loader).items()}
            for start in range(0, rollout_per_dev, sub_bs):
                chunk = {k: (v[start:start + sub_bs]
                             if isinstance(v, np.ndarray) else v)
                         for k, v in host_batch.items()}
                batch = batch_to_device(chunk, dev)
                gen = rollout_generator(
                    dev, seed, step_idx, chunk_idx,
                    mesh.data_rank if n_data > 1 else None)
                chunk_idx += 1
                scored = dpo_engine.rollout_score(model, dpo_cfg, ref_lora,
                                                  batch, gen)
                rollouts.append({**batch, **scored})
        rollouts_all = {k: torch.cat([r[k] for r in rollouts])
                        for k in rollouts[0]}
        sync()
        timer.record("rollout", time.time() - t0)

        # -- policy updates over cached rollouts --
        t0 = time.time()
        n = rollouts_all["queries"].shape[0]
        stats = {}
        for ep in range(noptepochs):
            order = np.random.default_rng(
                (seed, step_idx, ep)).permutation(n)
            for mb_start in range(0, n - step_per_dev + 1, step_per_dev):
                idxs = torch.from_numpy(
                    order[mb_start:mb_start + step_per_dev]).to(dev)
                mb = {k: v[idxs] for k, v in rollouts_all.items()}
                state, stats = dpo_engine.dpo_train_step(state, model, mb,
                                                         opt, dpo_cfg)
        sync()
        timer.record("train", time.time() - t0)

        if stats:
            line = {k: float(v) for k, v in stats.items()}
            # rollout entropy means per response type over the global
            # batch (reference record_step_stats, dpo_trainer.py:804-835)
            ent = comm.global_stats(
                {f"objective/{key}": ((val * (val != 0.0)).sum(),
                                      torch.clamp((val != 0.0).sum(), min=1))
                 for key, val in rollouts_all.items()
                 if key.endswith("_entropies")}, mesh)
            line.update({k: float(v) for k, v in ent.items()})
            line["objective/rollout_seconds"] = timer.history[-2]["seconds"]
            line["objective/train_seconds"] = timer.history[-1]["seconds"]
            if main:
                metrics.log(line, step=step_idx)
                logger.info("step %d loss=%.4f", step_idx,
                            line.get("loss/total", 0.0))

        if profile_at:
            runtime.maybe_start_profiler(output_dir, step_idx, profile_at)

        if step_idx % save_steps == 0 or step_idx == total_steps:
            ckpt_dir = os.path.join(output_dir, f"checkpoint-{step_idx}")
            ckpt_lib.save_train_state(ckpt_dir, state, lora_cfg,
                                      extra={"step": step_idx,
                                             "timers": timer.summary()},
                                      mesh=mesh)
            logger.info("saved %s", ckpt_dir)
    # a trace still open when the run ends is written, not lost
    runtime.stop_profiler()

    if main:
        metrics.close()
        ckpt_lib.mark_completed(output_dir)
    logger.info("training complete: %s", json.dumps(timer.summary()))
    return timer


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="OPA-DPO training (GPUs)")
    p.add_argument("--config", default="configs/llava_dpo.yaml")
    p.add_argument("overrides", nargs="*", help="key.path=value overrides")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.overrides)
    train(cfg)


if __name__ == "__main__":
    main()
