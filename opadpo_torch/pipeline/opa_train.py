"""Stage 3, the OPA (LoRA-SFT) training entry point.  Port of
``opadpo_tpu/pipeline/opa_train.py``.

Production recipe (run/train_opa.sh:31-50): LoRA r 256 alpha 512 over all
the decoder's linears and, with ``tune_vision_tower``, the CLIP blocks'
and the projector's; bf16; per-device batch 4, gradient accumulation 8,
2 epochs, lr 2e-5 cosine with 3 % warmup.  Each micro-step is one
``engine/sft.sft_train_step`` (the optimizer averages ``grad_accum`` of
them); ``checkpoint-<N>`` every ``save_steps`` optimizer steps, then
``checkpoint-final`` and the ``completed`` marker.

    python -m opadpo_torch.pipeline.opa_train --config configs/llava_opa.yaml \\
        [key.path=value ...]

    torchrun --nproc-per-node N -m opadpo_torch.pipeline.opa_train ...

Under ``torchrun`` the ranks form a ``data x model`` mesh (``mesh.model``
from the config, ``parallel/mesh.py``): the loader yields the JAX
package's global batch of ``per_device x n_data`` rows in its shuffled
order and data rank d takes rows ``[d per_device, (d + 1) per_device)``;
the optimizer averages the gradients over the data group once per update
and keeps ZeRO-1 moments; global rank 0 logs and writes the checkpoints.
One GPU a rank (``training.device``, default cuda: ``cuda:{LOCAL_RANK}``;
``cpu`` runs the plain versions over gloo).  ``train`` also takes the
tokenizer and the data module as arguments, for machines without
``transformers`` or ``datasets``.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from opadpo_torch.data.char_tokenizer import CharTokenizer
from opadpo_torch.data.datasets import make_sft_data_module
from opadpo_torch.data.image_processing import set_pil_preprocess
from opadpo_torch.data.loading import DataLoader
from opadpo_torch.engine.sft import SftConfig, sft_train_step
from opadpo_torch.engine.train_state import AdamW, OptimizerConfig, TrainState
from opadpo_torch.models import llava as llava_model
from opadpo_torch.models.lora import LoraConfig, make_trainable
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

logger = logging.getLogger("opa_train")


def train(cfg: Config, tokenizer=None,
          data_module: Optional[dict] = None) -> StepTimer:
    """Run stage 3 as ``cfg`` says -> the step timer."""
    t = cfg.training
    if bool(t.get("pil_preprocess", False)):
        # strict HF-numerics image path (native C++ JPEG pipeline off)
        set_pil_preprocess(True)
    fused = bool(t.get("fused_attention", True))
    runtime.check_fused_attention(fused, t.get("device", "cuda"))
    output_dir = os.environ.get("OUTPUT_DIR", t.get("output_dir", "./output"))
    logging.basicConfig(level=logging.INFO)

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
    dev, main = mesh.device, mesh.is_main
    if main:
        os.makedirs(output_dir, exist_ok=True)
        save_config(cfg, output_dir)

    lora_cfg = LoraConfig(rank=int(t.get("lora_r", 256)),
                          alpha=float(t.get("lora_alpha", 512)))
    lora = llava_model.init_lora(
        llava_cfg, lora_cfg, torch.Generator(device=dev).manual_seed(seed),
        include_vision=bool(t.get("tune_vision_tower", True)))
    lora = shard_lora(lora, mesh)
    sft_cfg = SftConfig(
        entropy_loss=bool(t.get("entropy_loss", False)),
        entropy_mask_method=str(t.get("entropy_mask_method", "random")),
        entropy_mask_ratio=float(t.get("entropy_mask_ratio", 0.3)),
        entropy_loss_coef=float(t.get("entropy_loss_coef", 0.0)),
        lora_scaling=lora_cfg.scaling)

    per_dev = int(t.get("per_device_train_batch_size", 4))
    grad_accum = int(t.get("gradient_accumulation_steps", 8))
    if tokenizer is None:
        if tiny or bool(cfg.get_path("debug.fake_tokenizer", False)):
            tokenizer = CharTokenizer()
        else:
            tokenizer = load_tokenizer(model_dir,
                                       int(t.get("model_max_length", 2048)))
    if data_module is None:
        data_module = make_sft_data_module(
            tokenizer, os.environ.get("DATA_DIR",
                                      cfg.get_path("data.data_path")),
            image_dir=os.environ.get("IMAGE_DIR"),
            query_len=int(t.get("query_len", 128)),
            response_len=int(t.get("response_len", 896)),
            image_size=llava_cfg.vision.image_size)
    # the JAX loader's global batch; data rank d takes its rows
    loader = DataLoader(data_module["train_dataset"],
                        data_module["data_collator"],
                        batch_size=per_dev * mesh.data, shuffle=True,
                        drop_last=True, seed=seed)
    rows = slice(mesh.data_rank * per_dev, (mesh.data_rank + 1) * per_dev)

    epochs = int(t.get("num_train_epochs") or 2)
    total_opt_steps = max(1, (len(loader) * epochs) // grad_accum)
    opt = AdamW(OptimizerConfig(
        learning_rate=float(t.get("learning_rate", 2e-5)),
        lr_scheduler_type=str(t.get("lr_scheduler_type", "cosine")),
        warmup_steps=int(float(t.get("warmup_ratio", 0.03))
                         * total_opt_steps),
        total_steps=total_opt_steps,
        weight_decay=float(t.get("weight_decay", 0.0)),
        max_grad_norm=(float(t["max_grad_norm"])
                       if t.get("max_grad_norm") else 1.0),
        grad_accum_steps=grad_accum), mesh)
    state = TrainState.create(make_trainable(lora), opt.cfg, mesh)

    save_steps = int(t.get("save_steps", 100))
    log_steps = int(t.get("logging_steps", 10))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    timer = StepTimer()
    # the entropy branch's masks; unused with it off (the recipe's default)
    gen = torch.Generator(device=dev).manual_seed(seed)
    metrics = MetricsLogger(output_dir, run_name="opa",
                            report_to=str(t.get("report_to", "jsonl"))) \
        if main else None
    micro_step = 0
    for epoch in range(epochs):
        for host_batch in loader:
            micro_step += 1
            t0 = time.time()
            host_batch = {k: v[rows] for k, v in host_batch.items()
                          if isinstance(v, np.ndarray)}
            batch = batch_to_device(host_batch, dev)
            state, stats = sft_train_step(state, model, batch, opt, sft_cfg,
                                          gen)
            sync()
            timer.record("sft_step", time.time() - t0,
                         tokens=int(host_batch["input_ids"].size))
            if micro_step % log_steps == 0 and main:
                line = {"epoch": epoch,
                        **{k: float(v) for k, v in stats.items()},
                        "step_seconds": timer.history[-1]["seconds"]}
                metrics.log(line, step=micro_step)
                logger.info("epoch %d micro %d loss=%.4f", epoch, micro_step,
                            line["loss/total"])
            if micro_step % (save_steps * grad_accum) == 0:
                ckpt_lib.save_train_state(
                    os.path.join(output_dir,
                                 f"checkpoint-{micro_step // grad_accum}"),
                    state, lora_cfg, mesh=mesh)

    final_dir = os.path.join(output_dir, "checkpoint-final")
    ckpt_lib.save_train_state(final_dir, state, lora_cfg,
                              extra={"timers": timer.summary()}, mesh=mesh)
    if main:
        metrics.close()
        ckpt_lib.mark_completed(output_dir)
    logger.info("OPA training complete -> %s", final_dir)
    return timer


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="OPA LoRA-SFT training (GPUs)")
    p.add_argument("--config", default="configs/llava_opa.yaml")
    p.add_argument("overrides", nargs="*", help="key.path=value overrides")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.overrides)
    train(cfg)


if __name__ == "__main__":
    main()
