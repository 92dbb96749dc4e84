"""Where the serving path's time goes: ``torch.profiler`` over one prefill
and the decode after it (16 tokens by default), on LLaVA-1.5-7B (or
``--model 13b``) at full width (random weights from a seed: bf16, or with
``--bits 8`` / ``4`` an int8 / int4 base, and with ``--head-bits`` a
quantized decode head), a batch of 8 left-padded prompts of 128 tokens
with one image each, greedy, through the ``Sampler``: an int8 prompt
cache by default (``--kv-bits 4`` packed int4, 16 bf16), with
``--chunk N`` chunked decode folding every N steps (set ``--steps`` past
N to see a fold), with ``--spec-k K`` speculative decode (K drafts per
verify, ``--spec-advance``).  The defaults are the shapes of
``chip_smoke.py``'s serving paths.

``--continuous`` profiles the slot pool instead, as ``chip_smoke.py``
runs it: ``make_continuous_engine`` with 16 slots (``--slots``),
segments of 64 (``--seg-len``), prompts of 128 tokens, ``--requests``
requests (32) at the serving sampling, an int8 pool (``--kv-bits 4``:
int4).  Its phases: one admission group of 4 prompts, then one segment
of the full pool (seg-len plain forwards and the fold, no admission).
With ``--spec-k K`` the int8 pool runs first, then the pool with
speculative segments (its segment is K-draft verify forwards), and the
record names where a verify forward's extra time over a plain one goes.

    python -m opadpo_torch.tools.profile_serving [--model 7b|13b]
        [--bits 16|8|4] [--head-bits 16|8|4] [--kv-bits 16|8|4]
        [--chunk N] [--spec-k K] [--spec-advance shared|per_row]
        [--steps N] [--continuous [--requests N] [--slots N]
        [--seg-len N]] [--json PATH]

For each phase it prints the host time (ending in a device synchronise)
with and without the profiler, the device's busy time (the union of the
kernels' intervals) and its share of either host time, and the device
time by kernel group and by kernel, largest first.  The card's name and
power limit come from ``nvidia-smi``.  ``--device cpu`` rehearses the
control flow on the tiny model on the CPU, where there are no device
times.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from opadpo_torch.constants import IMAGE_TOKEN_INDEX
from opadpo_torch.device import resolve_device
from opadpo_torch.engine.sampler import Sampler
from opadpo_torch.engine.sampling import SamplingConfig
from opadpo_torch.engine.serving_config import (
    make_continuous_engine, make_serving_sampling,
)
from opadpo_torch.tools import common

BATCH = 8
QLEN = 128
DECODE_STEPS = 16
# the slot pool as chip_smoke.py runs it
POOL_SLOTS = 16
POOL_SEG = 64
POOL_MAX_NEW = 256
POOL_REQUESTS = 32
POOL_GROUP = 4


def make_inputs(cfg, batch: int, qlen: int, dev, seed: int = 0):
    g = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(5, cfg.llama.vocab_size, (batch, qlen), generator=g,
                        device=dev)
    pos = torch.arange(qlen, device=dev)[None, :]
    pad = (torch.arange(batch, device=dev) * (qlen // 16))[:, None]
    mask = (pos >= pad).to(torch.int64)              # left padding per row
    ids = torch.where(mask != 0, ids, 0)
    ids[torch.arange(batch, device=dev), pad[:, 0] + 1] = IMAGE_TOKEN_INDEX
    sz = cfg.vision.image_size
    images = torch.randn(batch, sz, sz, 3, generator=g, device=dev)
    return ids, mask, images


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cpu runs the tiny model instead of the 7B / 13B")
    ap.add_argument("--model", choices=("7b", "13b"), default="7b")
    ap.add_argument("--bits", type=int, choices=(16, 8, 4), default=16,
                    help="the base's block linears: bf16, int8 or int4")
    ap.add_argument("--head-bits", type=int, choices=(16, 8, 4), default=16,
                    help="the decode head: bf16, int8 or int4")
    ap.add_argument("--kv-bits", type=int, choices=(16, 8, 4), default=8,
                    help="the prompt cache: bf16, int8 or packed int4")
    ap.add_argument("--chunk", type=int, default=0,
                    help="chunked decode: fold the suffix every N steps")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decode: K drafts per verify")
    ap.add_argument("--spec-advance", choices=("shared", "per_row"),
                    default="shared")
    ap.add_argument("--steps", type=int, default=DECODE_STEPS,
                    help="decode steps (tokens after the first)")
    ap.add_argument("--continuous", action="store_true",
                    help="profile the slot pool (admission, segment)")
    ap.add_argument("--requests", type=int, default=POOL_REQUESTS)
    ap.add_argument("--slots", type=int, default=POOL_SLOTS)
    ap.add_argument("--seg-len", type=int, default=POOL_SEG)
    ap.add_argument("--json", help="also write the summary here")
    return ap.parse_args(argv)


def run(args, model=None) -> dict:
    """The profile as ``args`` says, on ``model`` (drawn from seed 0 when
    None) -> the record."""
    dev = (resolve_device(args.device) if model is None
           else common.model_device(model))
    cuda = dev.type == "cuda"
    if model is None:
        _, model, _ = common.make_model(args.model if cuda else "tiny",
                                        args.bits, dev)
    result = {"card": common.card_line(dev),
              "model": f"llava_{args.model}" if cuda else "tiny",
              "bits": args.bits, "head_bits": args.head_bits,
              "kv_bits": args.kv_bits}
    if args.continuous:
        result.update(run_continuous(args, model, dev))
    else:
        result.update(_run_sampler(args, model, dev))
    return result


def _run_sampler(args, model, dev) -> dict:
    cfg = model.cfg
    ids, mask, images = make_inputs(cfg, BATCH, QLEN, dev)
    sampler = Sampler(
        SamplingConfig(greedy=True, max_new_tokens=args.steps + 1,
                       eos_token_id=-1),
        kv_bits=args.kv_bits, head_bits=args.head_bits, chunk=args.chunk,
        spec_k=args.spec_k, spec_advance=args.spec_advance)
    head = sampler.decode_head(model)

    def prefill():
        return sampler.prefill(model, ids, mask, images, head=head)

    def decode(pf):
        return sampler.decode(model, pf, head=head)

    result = {"chunk": args.chunk, "spec_k": args.spec_k,
              "spec_advance": args.spec_advance, "batch": BATCH,
              "qlen": QLEN}
    with torch.inference_mode():
        decode(common.timed(prefill, dev)[0])             # warm-up
        pf, pf_s = common.timed(prefill, dev)
        (_, info), dec_s = common.timed(decode, dev, pf)
        n_fwd = info["decode_steps"]
        result["decode"] = info
        phases = {}
        _, phases["prefill"] = common.profile_phase(prefill, dev, pf_s)
        _, phases["decode"] = common.profile_phase(lambda: decode(pf), dev,
                                                   dec_s)
    for key in ("unprofiled_ms", "host_ms", "kernels", "device_busy_ms"):
        phases["decode"][key + "_per_step"] = phases["decode"][key] / n_fwd
    result["phases"] = phases
    return result


def pool_requests(cfg, n: int, qlen: int, seed: int = 0):
    """``n`` pool requests: left-padded prompts of ``qlen`` tokens with the
    image token second, seeded random images."""
    rng = np.random.default_rng(seed)
    sz = cfg.vision.image_size
    out = []
    for i in range(n):
        q = rng.integers(5, cfg.llama.vocab_size, (qlen,)).astype(np.int64)
        m = np.ones_like(q)
        pad = (i * 7) % (qlen // 4)
        q[:pad], m[:pad] = 0, 0
        q[pad + 1] = IMAGE_TOKEN_INDEX
        out.append((q, m, rng.normal(size=(sz, sz, 3)).astype(np.float32)))
    return out


def _pool_mode(args, model, dev, spec_k: int, reqs, sampling) -> dict:
    """One pool's phases: an admission group of ``POOL_GROUP`` prompts and
    a segment of the full pool."""
    kv = args.kv_bits if not spec_k else 8

    def engine(slots, seg, samp):
        return make_continuous_engine(
            model, samp, slots=slots, kv_bits=kv, seg_len=seg,
            qlen=QLEN,
            spec_k=spec_k, head_bits=args.head_bits,
            generator=torch.Generator(device=dev).manual_seed(0))

    # the kernels this pool launches, loaded before anything is timed
    warm = engine(1, 2, make_serving_sampling(max_new_tokens=4,
                                              eos_token_id=-1))
    warm.add_request(*reqs[0])
    while warm.has_work():
        warm.step()
    warm_stats = {k: v for k, v in warm.stats.items() if k != "sp_used"}
    del warm
    eng = engine(args.slots, args.seg_len, sampling)
    phases, n = {}, 0

    def admit(k):
        nonlocal n
        for q, m, img in reqs[n:n + k]:
            eng.add_request(q, m, img)
        n += k
        return lambda: eng._admit_pending()

    common.timed(admit(POOL_GROUP), dev)                   # the pool's set-up
    _, plain_s = common.timed(admit(POOL_GROUP), dev)
    before = len(eng.stats["admit_groups"])
    _, phases["admission_group"] = common.profile_phase(
        admit(POOL_GROUP), dev, plain_s)
    groups = eng.stats["admit_groups"][before:]
    if groups != [POOL_GROUP]:
        raise RuntimeError(f"the profiled admission ran groups {groups}")
    phases["admission_group"]["rows"] = POOL_GROUP
    common.timed(admit(args.slots - n), dev)
    for q, m, img in reqs[n:]:
        eng.add_request(q, m, img)            # queued: the pool is full

    def segment():
        before = dict(eng.stats, admit_groups=len(eng.stats["admit_groups"]))
        finished = eng.step()
        if finished or len(eng.stats["admit_groups"]) != \
                before["admit_groups"]:
            raise RuntimeError("a profiled segment admitted or finished "
                               "a request")
        return eng.stats["forwards"] - before["forwards"]

    _, plain_s = common.timed(segment, dev)
    forwards, seg = common.profile_phase(segment, dev, plain_s)
    seg["forwards"] = forwards
    for key in ("unprofiled_ms", "host_ms", "device_busy_ms"):
        seg[key + "_per_forward"] = seg[key] / forwards
    seg["groups_ms_per_forward"] = {g: t / forwards
                                    for g, t in seg["groups_ms"].items()}
    phases["segment"] = seg
    out = {"kv_bits": kv, "spec_k": spec_k, "phases": phases,
           "stats": {k: v for k, v in eng.stats.items() if k != "sp_used"},
           "warm_stats": warm_stats,
           "sp_used": {str(k): v for k, v in eng.stats["sp_used"].items()}}
    if spec_k:
        out["spec_stats"] = dict(eng.spec_stats)
    return out


def verify_extra(plain: dict, spec: dict) -> dict:
    """Where a verify forward's time over a plain segment forward's goes:
    the per-forward differences of host time, of device-busy time, of the
    host time the device sits idle, and of each kernel group."""
    p, s = plain["phases"]["segment"], spec["phases"]["segment"]
    groups = set(p["groups_ms_per_forward"]) | set(s["groups_ms_per_forward"])
    by_group = {g: s["groups_ms_per_forward"].get(g, 0.0)
                - p["groups_ms_per_forward"].get(g, 0.0) for g in groups}
    extra = {
        "host_ms": s["unprofiled_ms_per_forward"]
        - p["unprofiled_ms_per_forward"],
        "device_busy_ms": s["device_busy_ms_per_forward"]
        - p["device_busy_ms_per_forward"],
        "groups_ms": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
    }
    extra["device_idle_ms"] = extra["host_ms"] - extra["device_busy_ms"]
    return extra


def run_continuous(args, model, dev) -> dict:
    """The slot pool's profile: the int8 (or int4) pool, and with
    ``--spec-k`` the int8 pool then the speculative one and
    ``verify_extra``."""
    cfg = model.cfg
    qlen = QLEN
    reqs = pool_requests(cfg, max(args.requests, args.slots), qlen)
    sampling = make_serving_sampling(max_new_tokens=POOL_MAX_NEW,
                                     eos_token_id=-1)
    if 2 * args.seg_len >= POOL_MAX_NEW:
        raise ValueError(f"--seg-len {args.seg_len}: a request must outlast "
                         f"the two timed segments (2 x seg-len < "
                         f"{POOL_MAX_NEW})")
    if args.slots < 3 * POOL_GROUP:
        raise ValueError(f"--slots {args.slots}: the profile admits three "
                         f"groups of {POOL_GROUP} first (--slots >= "
                         f"{3 * POOL_GROUP})")
    res = {"continuous": True, "slots": args.slots, "seg_len": args.seg_len,
           "qlen": qlen, "requests": max(args.requests, args.slots),
           "max_new": POOL_MAX_NEW}
    with torch.inference_mode():
        if args.spec_k:
            plain = _pool_mode(args, model, dev, 0, reqs, sampling)
            spec = _pool_mode(args, model, dev, args.spec_k, reqs, sampling)
            res["pools"] = {"int8": plain, f"spec k{args.spec_k}": spec}
            res["verify_extra"] = verify_extra(plain, spec)
        else:
            name = "int4" if args.kv_bits == 4 else "int8"
            if args.kv_bits == 16:
                raise ValueError("the slot pool is int8 or int4 "
                                 "(--kv-bits 8 or 4)")
            res["pools"] = {name: _pool_mode(args, model, dev, 0, reqs,
                                             sampling)}
    return res


def main(argv=None) -> int:
    args = parse_args(argv)
    result = run(args)
    print(json.dumps(result, indent=1))
    if args.json:
        common.write_record(result, args.json)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
