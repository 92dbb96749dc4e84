"""What the quantized modes cost in numbers, against bf16 on the same
weights: counterpart of ``scripts/bench_quality.py``, inside the port.

On LLaVA-1.5-7B (or ``--model 13b``; tiny on the CPU) with random weights
from a seed, each quantized mode is made from the bf16 model's own
weights (``quantized_copy``: the bf16 model stays as it is) and scored on
the same inputs:

- **scoring** (``run_scoring_quality``): the per-token logprob MAE and
  max |diff| against bf16 over the valid response tokens, the DPO pair
  margins' mean |delta| (GT over generated, AI over generated), and the
  cosine of one CoPO + AncPO step's LoRA gradient (r 64) against bf16's,
  the reference logprobs held fixed across modes; bf16 against a second
  bf16 pass reads 0;
- **decode** (``run_decode_quality``): on the int8 weights, the first
  decode step's logit MAE, max |diff| and argmax agreement of the int8
  prompt cache, the packed int4 cache and the int4 decode head against
  the bf16 cache and head.

The modes are the JAX script's: int8, w8a8, w8a8 with 32 outlier
columns, w8a8 with the int8 backward, int4 (``--modes`` picks some).  The
batches come from the same numpy calls as the JAX script's ``_batch``, so
each field means what the JAX record's field means.

    python -m opadpo_torch.tools.bench_quality [--response-len 896]
        [--batch 1] [--modes int8,w8a8,w8a8_out32,w8a8_bwd8,int4]
        [--skip-decode] [--skip-scoring] [--model 7b|13b|tiny]
        [--device cuda|cpu] [--out PATH]

Flags of the JAX script that steer only XLA or the TPU are not carried
over: ``--tiny`` (``--device cpu --model tiny`` takes its place).  The
record is written whole each run (no merge into an earlier file).
"""

from __future__ import annotations

import argparse
import copy
import json
import time

import numpy as np
import torch

from opadpo_torch.constants import IMAGE_TOKEN_INDEX
from opadpo_torch.engine import dpo as dpo_engine
from opadpo_torch.models import llama as llama_model
from opadpo_torch.models import llava
from opadpo_torch.models.lora import (
    LoraConfig, make_trainable, named_leaves, tree_map,
)
from opadpo_torch.ops import quant
from opadpo_torch.tools import common

TOOL = "bench_quality"
MODES = {
    "int8": (8, quant.QuantMode()),
    "w8a8": (8, quant.QuantMode(act_bits=8)),
    "w8a8_out32": (8, quant.QuantMode(act_bits=8, outlier_cols=32)),
    "w8a8_bwd8": (8, quant.QuantMode(act_bits=8, bwd_int8=True)),
    "int4": (4, quant.QuantMode()),
}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--response-len", type=int, default=896)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--modes", default=",".join(MODES),
                   help="the quantized modes to score, of " + ", ".join(MODES))
    p.add_argument("--skip-decode", action="store_true")
    p.add_argument("--skip-scoring", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    common.add_device_args(p, TOOL)
    args = p.parse_args(argv)
    bad = set(args.modes.split(",")) - set(MODES)
    if bad:
        p.error(f"--modes: unknown {sorted(bad)}")
    return args


# ---------------------------------------------------------------------------
# The JAX script's helpers
# ---------------------------------------------------------------------------

def quality_batch(cfg, dpo, b: int, rng_seed: int = 0) -> dict:
    """``_batch``'s numpy draws: queries with the image token second,
    normal(0.5) images rounded to bf16 (held in f32), three responses with
    a pad tail of max(2, R // 14), constant scores."""
    rng = np.random.default_rng(rng_seed)
    v = cfg.llama.vocab_size
    sz = cfg.vision.image_size
    q = rng.integers(5, v, (b, dpo.query_len)).astype(np.int32)
    q[:, 1] = IMAGE_TOKEN_INDEX
    images = rng.normal(size=(b, sz, sz, 3)) * 0.5
    batch = {"queries": q, "queries_attention_mask": np.ones_like(q),
             "images": torch.from_numpy(images).to(torch.bfloat16).float()
             .numpy()}
    for name in dpo_engine.RESPONSE_KEYS:
        ids = rng.integers(5, v, (b, dpo.response_len)).astype(np.int32)
        ids[:, -max(2, dpo.response_len // 14):] = 0
        batch[name] = ids
        batch[name + "_attention_mask"] = (ids != 0).astype(np.int32)
    batch["AI_pseudo_response_scores"] = np.full((b, dpo.response_len), 2.0,
                                                 np.float32)
    batch["original_generate_response_scores"] = np.ones(
        (b, dpo.response_len), np.float32)
    batch["AI_pseudo_response_image_relations"] = np.full(
        (b, dpo.response_len), 1.0, np.float32)
    return batch


def masks_of(batch: dict) -> np.ndarray:
    """[3, B, R] f64 response masks, in ``RESPONSE_KEYS`` order."""
    return np.stack([np.asarray(batch[k + "_attention_mask"])
                     for k in dpo_engine.RESPONSE_KEYS]).astype(np.float64)


def logprob_metrics(lp, lp_ref, masks) -> dict:
    """Per-token |diff| over the valid tokens and the pair margins'
    deltas (``_logprob_metrics``)."""
    valid = masks.astype(bool)
    d = np.abs(lp - lp_ref)[valid]
    sums = (lp * masks).sum(axis=-1)          # [3, B]
    sums_ref = (lp_ref * masks).sum(axis=-1)
    m1 = (sums[0] - sums[1]) - (sums_ref[0] - sums_ref[1])
    m2 = (sums[2] - sums[1]) - (sums_ref[2] - sums_ref[1])
    return {
        "logprob_mae": float(d.mean()),
        "logprob_max_abs": float(d.max()),
        "pair_margin_abs_delta_std_gen": float(np.abs(m1).mean()),
        "pair_margin_abs_delta_ai_gen": float(np.abs(m2).mean()),
    }


def cosine(a, b) -> float:
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return float("nan")
    return float(np.dot(a, b) / (na * nb))


def quality_lora(cfg, lora_cfg, generator) -> dict:
    """A decoder adapter with every entry pushed 0.01 off its init, so the
    B factors contribute to the forward (``_lora``)."""
    lora = llava.init_lora(cfg, lora_cfg, generator)
    return tree_map(lambda x: x + torch.tensor(0.01, dtype=x.dtype), lora)


@torch.no_grad()
def score(model, dpo, batch: dict, lora=None) -> np.ndarray:
    """The three responses' logprobs -> host f64 [3, B, R] (``_score``)."""
    resp, rmask = dpo_engine._responses(batch)
    out = dpo_engine.score_responses(
        model, dpo, batch["queries"], batch["queries_attention_mask"],
        batch["images"], resp, rmask, lora=lora, remat=True)
    return np.stack([x.double().cpu().numpy() for x in out["logprobs"]])


def grads(model, dpo, full_batch: dict, lora) -> np.ndarray:
    """One CoPO + AncPO loss's LoRA gradient -> host flat f64 (``_grads``),
    in ``named_leaves`` order."""
    params = make_trainable(lora)
    leaves = [t for _, t in named_leaves(params)]
    loss, _ = dpo_engine.dpo_loss_and_stats(params, model, dpo, full_batch)
    g = torch.autograd.grad(loss, leaves)
    return np.concatenate([x.double().cpu().numpy().ravel() for x in g])


def _share(module):
    """A copy of a module tree whose containers are new and whose tensors
    are the original's."""
    c = copy.copy(module)
    c._modules = {k: None if m is None else _share(m)
                  for k, m in module._modules.items()}
    c._parameters = dict(module._parameters)
    c._buffers = dict(module._buffers)
    return c


def quantized_copy(model, bits: int, mode: quant.QuantMode):
    """``model`` with its quantizable linears quantized to ``bits`` (int8 /
    int4) under ``mode``, every other tensor shared: the bf16 model is not
    changed."""
    return quant.quantize_params(_share(model), bits=bits, mode=mode)


# ---------------------------------------------------------------------------
# The two sections
# ---------------------------------------------------------------------------

def _sizes(cfg, response_len: int):
    tiny = cfg.llama.num_layers < 8
    lora_cfg = LoraConfig(rank=4 if tiny else 64, alpha=8.0 if tiny else 128.0)
    qlen = 128                     # the JAX script's query length
    dpo = dpo_engine.DpoConfig(response_len=response_len, query_len=qlen,
                               lora_scaling=lora_cfg.scaling)
    grad_len = min(response_len, 32 if tiny else 128)
    dpo_g = dpo_engine.DpoConfig(response_len=grad_len, query_len=qlen,
                                 lora_scaling=lora_cfg.scaling)
    return lora_cfg, dpo, dpo_g, grad_len


def run_scoring_quality(model, args, modes) -> dict:
    """Each mode against bf16: logprob metrics and the gradient cosine."""
    dev, cfg = common.model_device(model), model.cfg
    lora_cfg, dpo, dpo_g, grad_len = _sizes(cfg, args.response_len)
    b = args.batch
    batch_np = quality_batch(cfg, dpo, b)
    batch = common.to_device(batch_np, dev)
    grad_batch = common.to_device(quality_batch(cfg, dpo_g, b, rng_seed=1),
                                  dev)
    masks = masks_of(batch_np)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 5)
    lora = quality_lora(cfg, lora_cfg, gen)
    t0 = time.perf_counter()
    lp_ref = score(model, dpo, batch, lora)
    results = {"bf16": {**logprob_metrics(score(model, dpo, batch, lora),
                                          lp_ref, masks),
                        "note": "baseline, against a second bf16 pass",
                        "grad_response_len": grad_len,
                        "seconds": time.perf_counter() - t0}}
    rollouts = dpo_engine.rollout_score(
        model, dpo_g, None, grad_batch,
        torch.Generator(device=dev).manual_seed(args.seed + 9))
    full = {**grad_batch, **rollouts}
    grads_ref = grads(model, dpo_g, full, lora)
    results["bf16"]["lora_grad_cosine_vs_bf16"] = cosine(grads_ref,
                                                         grads_ref)
    for name in modes:
        bits, mode = MODES[name]
        t0 = time.perf_counter()
        qm = quantized_copy(model, bits, mode)
        entry = logprob_metrics(score(qm, dpo, batch, lora), lp_ref, masks)
        entry["lora_grad_cosine_vs_bf16"] = cosine(
            grads(qm, dpo_g, full, lora), grads_ref)
        entry["seconds"] = time.perf_counter() - t0
        results[name] = entry
        del qm
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return results


@torch.no_grad()
def run_decode_quality(model, args) -> dict:
    """On the int8 weights: the first decode step's logits over the int8
    and the packed int4 prompt cache, and with the int4 head, each against
    the bf16 cache and head."""
    dev, cfg = common.model_device(model), model.cfg
    qm = quantized_copy(model, 8, quant.QuantMode())
    b = 1
    rng = np.random.default_rng(3)
    sz = cfg.vision.image_size
    q = rng.integers(5, cfg.llama.vocab_size,
                     (b, 16 if cfg.llama.num_layers < 8 else 128)
                     ).astype(np.int32)
    q[:, 1] = IMAGE_TOKEN_INDEX
    images = torch.from_numpy(rng.normal(size=(b, sz, sz, 3)) * 0.5).to(
        torch.bfloat16).to(dev)
    ids = torch.from_numpy(q.astype(np.int64)).to(dev)
    pf = llava.prefill_unrolled(qm, ids, torch.ones_like(ids), images)
    tok = pf["last_logits"].argmax(-1)

    def first_step(kv, head=None):
        suffix = llama_model.init_suffix_cache(qm.llama.cfg, b, 8, dev)
        lg, _ = llava.decode_step_unrolled(
            qm, tok, kv, pf["key_mask"], suffix, 0, pf["next_position"],
            head=head)
        return lg.double().cpu().numpy()

    base = first_step(pf["kv_list"])
    out = {"prompt_positions": int(pf["key_mask"].shape[1])}
    for name, kv, head in (
            ("kv8", llama_model.quantize_prompt_kv_list(pf["kv_list"]),
             None),
            ("kv4", llama_model.quantize_prompt_kv_list(pf["kv_list"],
                                                        kv_bits=4), None),
            ("head4", pf["kv_list"],
             llama_model.quantize_head_for_decode(qm.llama, 4))):
        lg = first_step(kv, head)
        d = np.abs(lg - base)
        out[f"{name}_first_step_logit_mae"] = float(d.mean())
        out[f"{name}_first_step_logit_max_abs"] = float(d.max())
        out[f"{name}_argmax_agrees"] = bool(
            (np.argmax(lg, -1) == np.argmax(base, -1)).all())
    return out


def run(args, model=None) -> dict:
    """The measurement on ``model`` (bf16, drawn from ``--seed`` when None)
    -> the record."""
    if model is None:
        dev = common.device_of(args)
        _, model, _ = common.make_model(args.model, 16, dev, args.seed)
    dev = common.model_device(model)
    if common.base_bits(model) != 16:
        raise ValueError("bench_quality measures against a bf16 model")
    modes = [m for m in args.modes.split(",") if m]
    rec = {"tool": TOOL, "card": common.card_line(dev), "model": args.model,
           "scale": "tiny" if args.model == "tiny" else f"llava-{args.model}",
           "batch": args.batch, "response_len": args.response_len,
           "modes": modes,
           "baseline": "bf16 (reference numerics, qlora_model.py:135-147)"}
    if not args.skip_scoring:
        rec["scoring"] = run_scoring_quality(model, args, modes)
    if not args.skip_decode:
        rec["decode"] = run_decode_quality(model, args)
    return rec


def main(argv=None) -> int:
    args = parse_args(argv)
    rec = run(args)
    print(json.dumps(rec), flush=True)
    common.write_record(rec, args.out or common.default_out(TOOL))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
