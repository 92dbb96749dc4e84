"""One chunked-decode chunk under ``torch.profiler``, its Chrome trace
written for ``summarize_trace``.  Counterpart of
``scripts/profile_decode.py``.

    python -m opadpo_torch.tools.profile_decode [--batch 16] [--steps 64]
        [--chunk 256] [--n-chunks 4] [--kv-bits 8|4] [--bits 4]
        [--head-bits 4] [--model 7b|13b|tiny] [--outdir DIR]
        [--device cuda|cpu] [--out PATH]
    python -m opadpo_torch.tools.summarize_trace DIR

LLaVA-1.5-7B at full width with random weights from a seed (an int4 base
and an int4 decode head, as the JAX script), a batch of 128-token prompts
(``default_rng(0)`` ids, the image token second, zero images), the
prompt cache allocated for ``--n-chunks`` chunks of ``--chunk`` (the
896-token rollout's chunk-0 shape) and read to the first chunk's
watermark, the rollout's sampling (top-k 30, top-p 0.95).  One chunk of
``--steps`` steps warms up; the next is traced into ``--outdir``
(``export_chrome_trace``; default ``build/tools/profile_decode/``).  The
record holds ms a step (the traced chunk's host clock), the trace's path
and its device time by kernel group.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from opadpo_torch.constants import IMAGE_TOKEN_INDEX
from opadpo_torch.engine.sampler import decode_loop_unrolled
from opadpo_torch.engine.sampling import SamplingConfig
from opadpo_torch.models import llama as llama_model
from opadpo_torch.models import llava
from opadpo_torch.tools import common

TOOL = "profile_decode"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--chunk", type=int, default=256)
    p.add_argument("--n-chunks", type=int, default=4,
                   help="allocate the cache as if decoding this many chunks")
    p.add_argument("--kv-bits", type=int, default=8, choices=(8, 4))
    p.add_argument("--bits", type=int, default=4, choices=(16, 8, 4))
    p.add_argument("--head-bits", type=int, default=4, choices=(16, 8, 4))
    p.add_argument("--outdir", default=os.path.join(common.REPO, "build",
                                                     "tools", TOOL))
    p.add_argument("--seed", type=int, default=0)
    common.add_device_args(p, TOOL)
    return p.parse_args(argv)


def run(args, model=None) -> dict:
    """The profile on ``model`` (drawn from ``--seed`` at ``--bits`` when
    None) -> the record."""
    if model is None:
        dev = common.device_of(args)
        _, model, _ = common.make_model(args.model, args.bits, dev,
                                        args.seed)
    dev = common.model_device(model)
    cfg, b = model.cfg, args.batch
    tiny = cfg.llama.num_layers < 8
    qlen = 16 if tiny else 128
    rng = np.random.default_rng(0)
    q = rng.integers(5, cfg.llama.vocab_size, (b, qlen)).astype(np.int64)
    q[:, 1] = IMAGE_TOKEN_INDEX
    ids = torch.from_numpy(q).to(dev)
    sz = cfg.vision.image_size
    images = torch.zeros((b, sz, sz, 3), dtype=torch.bfloat16, device=dev)
    align = llama_model.KV_ALIGN4 if args.kv_bits == 4 else \
        llama_model.KV_ALIGN
    if args.chunk % align:
        raise ValueError(f"--chunk {args.chunk}: a multiple of {align} at "
                         f"--kv-bits {args.kv_bits}")
    s_prompt = qlen - 1 + cfg.num_patches
    sp_pad0 = -(-s_prompt // align) * align
    kv_total = sp_pad0 + (args.n_chunks - 1) * args.chunk
    head = (None if args.head_bits == 16 else
            llama_model.quantize_head_for_decode(model.llama, args.head_bits))
    sampling = SamplingConfig(max_new_tokens=args.chunk, temperature=1.0,
                              top_k=30, top_p=0.95, eos_token_id=-1,
                              pad_token_id=0)
    with torch.inference_mode():
        pf = llava.prefill_unrolled(model, ids, torch.ones_like(ids), images,
                                    quantize_kv=True, kv_total_len=kv_total,
                                    kv_bits=args.kv_bits, head=head)
        pm = F.pad(pf["key_mask"], (0, kv_total - pf["key_mask"].shape[1]))

        def chunk():
            gen = torch.Generator(device=dev).manual_seed(1)
            return decode_loop_unrolled(
                model, pf["kv_list"], pm, pf["next_position"],
                pf["last_logits"], gen, sampling, head=head,
                max_new=args.steps, return_state=True, sp_used=sp_pad0)

        (_, n_fwd, _), warm_s = common.timed(chunk, dev)
        trace = os.path.join(args.outdir, f"{TOOL}.trace.json")
        (_, n_fwd, _), summary = common.profile_phase(chunk, dev, warm_s,
                                                      trace=trace)
    return {"tool": TOOL, "card": common.card_line(dev), "model": args.model,
            "bits": common.base_bits(model), "head_bits": args.head_bits,
            "kv_bits": args.kv_bits, "batch": b, "steps": args.steps,
            "chunk": args.chunk, "n_chunks": args.n_chunks,
            "kv_total": kv_total, "sp_used": sp_pad0,
            "decode_forwards": n_fwd, "prefills": 1, "trace": trace,
            "ms_per_step": summary["host_ms"] / args.steps,
            "ms_per_step_unprofiled": warm_s * 1e3 / args.steps,
            "profile": summary}


def main(argv=None) -> int:
    args = parse_args(argv)
    rec = run(args)
    print(json.dumps(rec), flush=True)
    common.write_record(rec, args.out or common.default_out(TOOL))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
