"""Decode throughput: the rollout's sampling (top-k 30, top-p 0.95,
temperature 1) through ``engine/sampler.Sampler`` after one prefill, on
LLaVA-1.5-7B (or ``--model 13b``) at full width with random weights from
a seed.  Counterpart of ``scripts/bench_decode.py``.

    python -m opadpo_torch.tools.bench_decode [--bits 16|8|4]
        [--kv-bits 16|8|4] [--head-bits 16|8|4] [--chunk N] [--batch 4]
        [--steps 128] [--query-len 128] [--model 7b|13b|tiny]
        [--kv-extra N] [--device cuda|cpu] [--out PATH]

``--chunk N`` folds the suffix into the quantized prompt cache every N
steps (int8 or int4 cache: refused at ``--kv-bits 16``); ``--kv-extra N``
allocates N more alignment multiples (128 positions int8, 256 int4) past
the chunked final length, work unchanged.  The prompts are the JAX
script's: ``numpy.random.default_rng(0)`` ids, the image token second,
zero images.  One warm-up prefill and decode, then PREFILL_ITERS fresh
prefills, each timed, and the last one's decode, timed (host clock
ending in a synchronise).  It reports steps/s (tokens a row per second),
tok/s, ms a step, the median prefill ms (each sample in
``prefill_ms_samples``) and the peak GB
(``torch.cuda.max_memory_allocated``).

Flags of the JAX script that steer only XLA or the TPU are not carried
over: ``--platform`` (``--device`` takes its place), ``--topk-impl``
(the port has one top-k) and ``--probe-memory`` (XLA's compile-time
budget; ``peak_gb`` takes its place).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from opadpo_torch.constants import IMAGE_TOKEN_INDEX
from opadpo_torch.engine.sampler import Sampler
from opadpo_torch.engine.sampling import SamplingConfig
from opadpo_torch.models import llama as llama_model
from opadpo_torch.models import llava
from opadpo_torch.tools import common

TOOL = "bench_decode"
PREFILL_ITERS = 5                # timed prefills; the median is reported


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--bits", type=int, default=8, choices=(16, 8, 4))
    p.add_argument("--kv-bits", type=int, default=16, choices=(16, 8, 4))
    p.add_argument("--head-bits", type=int, default=16, choices=(16, 8, 4))
    p.add_argument("--chunk", type=int, default=0,
                   help="chunked decode: fold the suffix into the quantized "
                        "prompt cache every CHUNK steps (needs --kv-bits 8 "
                        "or 4)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--steps", type=int, default=128)
    p.add_argument("--query-len", type=int, default=128)
    p.add_argument("--kv-extra", type=int, default=0,
                   help="allocate this many more alignment multiples of "
                        "cache length past the chunked final length")
    p.add_argument("--seed", type=int, default=0)
    common.add_device_args(p, TOOL)
    return p.parse_args(argv)


def check_args(args) -> None:
    if args.chunk and args.kv_bits == 16:
        raise ValueError("--chunk needs a quantized prompt cache "
                         "(--kv-bits 8 or 4)")
    if args.kv_extra and not args.chunk:
        raise ValueError("--kv-extra sizes the chunked cache (needs --chunk)")


def prompts(cfg, batch: int, query_len: int):
    """The JAX script's prompts: ids from ``default_rng(0)``, the image
    token second, a full mask."""
    rng = np.random.default_rng(0)
    q = rng.integers(5, cfg.llama.vocab_size,
                     (batch, query_len)).astype(np.int32)
    q[:, 1] = IMAGE_TOKEN_INDEX
    return q, np.ones_like(q)


def run(args, model=None) -> dict:
    """The benchmark on ``model`` (drawn from ``--seed`` when None) -> the
    record."""
    check_args(args)
    if model is None:
        dev = common.device_of(args)
        _, model, _ = common.make_model(args.model, args.bits, dev,
                                        args.seed)
    dev = common.model_device(model)
    cfg, b = model.cfg, args.batch
    q, qm = prompts(cfg, b, args.query_len)
    ids = torch.from_numpy(q.astype(np.int64)).to(dev)
    mask = torch.from_numpy(qm.astype(np.int64)).to(dev)
    sz = cfg.vision.image_size
    images = torch.zeros((b, sz, sz, 3), dtype=torch.bfloat16, device=dev)
    sampling = SamplingConfig(max_new_tokens=args.steps, temperature=1.0,
                              top_k=30, top_p=0.95, eos_token_id=-1,
                              pad_token_id=0)
    sampler = Sampler(sampling, kv_bits=args.kv_bits,
                      head_bits=args.head_bits, chunk=args.chunk)
    head = sampler.decode_head(model)
    s_prompt = args.query_len - 1 + cfg.num_patches
    align = llama_model.KV_ALIGN4 if args.kv_bits == 4 else \
        llama_model.KV_ALIGN
    kv_total = None
    if args.chunk:
        kv_total = sampler._kv_total_len(s_prompt) + args.kv_extra * align

    def prefill():
        return llava.prefill_unrolled(
            model, ids, mask, images, quantize_kv=args.kv_bits != 16,
            kv_total_len=kv_total, kv_bits=args.kv_bits, head=head)

    def decode(pf):
        gen = torch.Generator(device=dev).manual_seed(1)
        return sampler.decode(model, pf, gen, head=head)

    stats = []
    with torch.inference_mode():
        pf = prefill()                   # warm-up (the chunked cache folds
        _, info = decode(pf)             # in place: a fresh prefill each run)
        stats.append(_stat(b, pf, info))
        common.reset_peak(dev)
        pf_s = []
        for i in range(PREFILL_ITERS):
            if i:                        # a prefill left without a decode
                stats.append(_stat(b, pf, {"decode_steps": 0}))
            pf = None                    # free the last cache first
            pf, s = common.timed(prefill, dev)
            pf_s.append(s)
        (_, info), dt = common.timed(decode, dev, pf)
    stats.append(_stat(b, pf, info))
    steps = args.steps
    rec = {"tool": TOOL, "card": common.card_line(dev),
           "model": args.model, "bits": common.base_bits(model),
           "kv_bits": args.kv_bits, "head_bits": args.head_bits,
           "chunk": args.chunk, "kv_extra": args.kv_extra, "batch": b,
           "steps": steps, "query_len": args.query_len,
           "prompt_positions": int(pf["key_mask"].shape[1]),
           "steps_per_sec": steps / dt, "tokens_per_sec": steps * b / dt,
           "ms_per_step": dt / steps * 1e3,
           "prefill_ms": float(np.median(pf_s)) * 1e3,
           "prefill_ms_samples": [x * 1e3 for x in pf_s],
           "decode_s": dt, "decode_forwards": info["decode_steps"],
           "folds": info["folds"], "sp_used": info["sp_used"],
           "peak_gb": common.peak_gb(dev), "runs": stats}
    return rec


def _stat(b, pf, info) -> dict:
    """One prefill and its decode as ``Sampler.stats`` records them."""
    return {"batch_rows": b, "prompt_positions": int(pf["key_mask"].shape[1]),
            "decode_steps": info["decode_steps"]}


def main(argv=None) -> int:
    args = parse_args(argv)
    rec = run(args)
    print(json.dumps(rec), flush=True)
    common.write_record(rec, args.out or common.default_out(TOOL))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
