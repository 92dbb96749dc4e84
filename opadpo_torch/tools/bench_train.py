"""Train-step wall clock: the OPA-DPO step (CoPO + AncPO, 4 pairs), the
OPA SFT step with the vision adapter, or the reference scoring pass, on
LLaVA-1.5-7B (or ``--model 13b``) at full width with random weights and
adapters from a seed.  Counterpart of ``scripts/bench_train.py``.

    python -m opadpo_torch.tools.bench_train [--mode dpo|sft|rollout]
        [--bits 16|8|4] [--act-bits 16|8] [--bwd-int8] [--batch 2]
        [--lora-rank 64] [--iters 3] [--model 7b|13b|tiny]
        [--profile DIR] [--device cuda|cpu] [--out PATH]

- ``dpo``: ``engine/dpo.dpo_train_step`` over one ``rollout_score``'s
  outputs, queries of 128 tokens and three responses of 896 (the last 64
  padding), at batch ``--batch``;
- ``sft``: ``engine/sft.sft_train_step`` over 2 x ``--batch`` rows of 1600
  tokens (the first 128 unlabelled), the decoder, vision and projector
  adapters;
- ``rollout``: ``rollout_score`` alone.

The batches are the JAX script's (``numpy.random.default_rng(0)``, zero
images).  ``--act-bits 8`` (at ``--bits 8``) runs w8a8, ``--bwd-int8``
its int8 dx.  One warm-up iteration, then ``--iters`` timed ones (host
clock ending in a synchronise): it reports the seconds of each, their
median (``seconds_per_step``) and the peak GB; ``--profile DIR`` writes a
``torch.profiler`` Chrome trace of the timed iterations there.

Flags of the JAX script that steer only XLA or the TPU are not carried
over: ``--probe-memory`` (XLA's compile-time budget; ``peak_gb`` from
``torch.cuda.max_memory_allocated`` takes its place).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics

import numpy as np
import torch
from torch.profiler import profile

from opadpo_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from opadpo_torch.engine import dpo as dpo_engine
from opadpo_torch.engine.sft import SftConfig, sft_train_step
from opadpo_torch.engine.train_state import AdamW, OptimizerConfig, TrainState
from opadpo_torch.models import llava
from opadpo_torch.models.lora import LoraConfig, make_trainable
from opadpo_torch.ops.quant import QuantMode, set_quant_mode
from opadpo_torch.tools import common

TOOL = "bench_train"
SFT_SEQ = 1600


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", default="dpo", choices=("dpo", "sft", "rollout"))
    p.add_argument("--bits", type=int, default=8, choices=(16, 8, 4))
    p.add_argument("--act-bits", type=int, default=8, choices=(16, 8))
    p.add_argument("--bwd-int8", action="store_true",
                   help="the int8 dx of w8a8 (QuantMode bwd_int8)")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--lora-rank", type=int, default=64)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler Chrome trace of the timed "
                        "iterations into DIR (summarize_trace reads it)")
    p.add_argument("--seed", type=int, default=0)
    common.add_device_args(p, TOOL)
    return p.parse_args(argv)


def quant_mode(args) -> QuantMode:
    """w8a8 only on an int8 base, as the JAX script's ``set_act_quant``."""
    if args.bits == 8 and args.act_bits == 8:
        return QuantMode(act_bits=8, bwd_int8=args.bwd_int8)
    return QuantMode()


def dpo_batch(cfg, dpo, b: int) -> dict:
    """The JAX script's DPO batch (numpy, ``default_rng(0)``)."""
    rng = np.random.default_rng(0)
    v = cfg.llama.vocab_size
    q = rng.integers(5, v, (b, dpo.query_len)).astype(np.int32)
    q[:, 1] = IMAGE_TOKEN_INDEX
    sz = cfg.vision.image_size
    batch = {"queries": q, "queries_attention_mask": np.ones_like(q),
             "images": np.zeros((b, sz, sz, 3), np.float32)}
    for name in dpo_engine.RESPONSE_KEYS:
        ids = rng.integers(5, v, (b, dpo.response_len)).astype(np.int32)
        ids[:, -min(64, dpo.response_len // 2):] = 0
        batch[name] = ids
        batch[name + "_attention_mask"] = (ids != 0).astype(np.int32)
    batch["AI_pseudo_response_scores"] = np.full((b, dpo.response_len), 2.0,
                                                 np.float32)
    batch["original_generate_response_scores"] = np.ones(
        (b, dpo.response_len), np.float32)
    batch["AI_pseudo_response_image_relations"] = np.ones(
        (b, dpo.response_len), np.float32)
    return batch, rng


def sft_batch(cfg, rows: int, seq: int, rng) -> dict:
    """The JAX script's SFT batch: ``rows`` of ``seq`` ids from ``rng``
    (after the DPO batch's draws), the image token second, the first 128
    tokens unlabelled."""
    ids = rng.integers(5, cfg.llama.vocab_size, (rows, seq)).astype(np.int32)
    ids[:, 1] = IMAGE_TOKEN_INDEX
    labels = ids.copy()
    labels[:, :min(128, seq // 2)] = IGNORE_INDEX
    sz = cfg.vision.image_size
    return {"input_ids": ids, "attention_mask": np.ones_like(ids),
            "labels": labels,
            "images": np.zeros((rows, sz, sz, 3), np.float32)}


def run(args, model=None) -> dict:
    """The benchmark on ``model`` (drawn from ``--seed`` at ``--bits`` when
    None; a given quantized model takes ``--act-bits`` / ``--bwd-int8``)
    -> the record."""
    mode = quant_mode(args)
    if model is None:
        dev = common.device_of(args)
        _, model, _ = common.make_model(args.model, args.bits, dev,
                                        args.seed, mode)
    else:
        set_quant_mode(model, mode)
    dev = common.model_device(model)
    cfg, b = model.cfg, args.batch
    tiny = cfg.llama.num_layers < 8
    lcfg = LoraConfig(rank=args.lora_rank, alpha=2.0 * args.lora_rank)
    dpo = dpo_engine.DpoConfig(response_len=16 if tiny else 896,
                               query_len=8 if tiny else 128,
                               lora_scaling=lcfg.scaling)
    batch_np, rng = dpo_batch(cfg, dpo, b)
    batch = common.to_device(batch_np, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    rec = {"tool": TOOL, "card": common.card_line(dev), "model": args.model,
           "mode": args.mode, "bits": common.base_bits(model),
           "act_bits": mode.act_bits, "bwd_int8": mode.bwd_int8,
           "batch": b, "lora_rank": lcfg.rank, "iters": args.iters}

    if args.mode == "sft":
        seq = 24 if tiny else SFT_SEQ
        sb = common.to_device(sft_batch(cfg, 2 * b, seq, rng), dev)
        lora = make_trainable(llava.init_lora(cfg, lcfg, gen,
                                              include_vision=True))
        opt = AdamW(OptimizerConfig(learning_rate=1e-5, warmup_steps=0,
                                    total_steps=10))
        state = TrainState.create(lora, opt.cfg)
        scfg = SftConfig(lora_scaling=lcfg.scaling)

        def one():
            return sft_train_step(state, model, sb, opt, scfg)[1]
        rec.update(rows=2 * b, seq=seq,
                   positions=seq - 1 + cfg.num_patches)
        what = {"sft_steps": 1 + args.iters}
    else:
        ref = llava.init_lora(cfg, lcfg, gen)
        rollouts = dpo_engine.rollout_score(model, dpo, ref, batch, gen)
        rec.update(query_len=dpo.query_len, response_len=dpo.response_len)
        if args.mode == "rollout":
            def one():
                return dpo_engine.rollout_score(model, dpo, ref, batch, gen)
            what = {"rollouts": 2 + args.iters, "dpo_steps": 0}
        else:
            full = {**batch, **rollouts}
            opt = AdamW(OptimizerConfig(learning_rate=1e-6, warmup_steps=0,
                                        total_steps=10))
            state = TrainState.create(make_trainable(
                llava.init_lora(cfg, lcfg, gen)), opt.cfg)

            def one():
                return dpo_engine.dpo_train_step(state, model, full, opt,
                                                 dpo)[1]
            what = {"rollouts": 1, "dpo_steps": 1 + args.iters}

    common.reset_peak(dev)
    out, first = common.timed(one, dev)
    times = []
    ctx = (profile(activities=common.activities(dev)) if args.profile
           else contextlib.nullcontext())
    with ctx as prof:
        for _ in range(args.iters):
            out, s = common.timed(one, dev)
            times.append(s)
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        rec["trace"] = os.path.join(args.profile, f"{TOOL}_{args.mode}.json")
        prof.export_chrome_trace(rec["trace"])
    loss = out.get("loss/total") if isinstance(out, dict) else None
    rec.update(first_iter_s=first, iter_s=times,
               seconds_per_step=statistics.median(times),
               peak_gb=common.peak_gb(dev), ran=what,
               loss=None if loss is None else float(loss))
    if args.mode == "rollout":
        rec["finite"] = all(bool(torch.isfinite(v).all())
                            for v in out.values())
    else:
        rec["finite"] = loss is not None and bool(np.isfinite(rec["loss"]))
    return rec


def main(argv=None) -> int:
    args = parse_args(argv)
    rec = run(args)
    print(json.dumps(rec), flush=True)
    common.write_record(rec, args.out or common.default_out(TOOL))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
