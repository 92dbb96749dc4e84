"""Serving throughput: the continuous slot pool (``make_continuous_engine``)
against batch-synchronous ``Sampler.generate`` on the same mixed-length
requests, on LLaVA-1.5-7B (or ``--model 13b``) at full width with random
weights from a seed.  Counterpart of ``scripts/bench_serve.py``.

    python -m opadpo_torch.tools.bench_serve [--bits 16|8|4]
        [--head-bits 16|8|4] [--kv-bits 8|4] [--slots 8] [--requests 32]
        [--seg-len 64] [--admit-group 1|2|4] [--max-new 512]
        [--query-len 128] [--mode both|continuous|batch]
        [--budget-mix short|long|uniform] [--spec-k K]
        [--spec-draft ngram|oracle|pad] [--spec-accept 0.8] [--greedy]
        [--seed 0] [--model 7b|13b|tiny] [--device cuda|cpu] [--out PATH]

The traffic is the JAX script's: the budgets and the prompts come from
the same numpy calls in the same order (``traffic``), so one ``--seed``
gives both packages the same requests.  EOS never fires, so each request
runs to its budget.  The pool keeps one engine for its warm-up and timed
passes; the batch mode fills batches of ``--slots`` requests and runs each
to its largest budget (rounded up to 128, chunk 256), as HF ``generate``
does, after a warm-up pass of its own only when the pool did not run
first (the JAX script warms each mode up to compile its programs; here
the first launch of each kernel is the only cost).  With ``--spec-k K``
the pool runs speculative segments; ``--spec-draft oracle`` feeds each
request its own warm-up continuation,
each token kept with probability ``--spec-accept`` and otherwise redrawn
(``corrupt_oracles``, the JAX script's calls), and needs ``--spec-k`` > 0:
without it the oracle is refused (the JAX script ignores it silently).
The oracle forces greedy decoding.

It reports, for each mode, generated tok/s and the request latency mean,
p50 and p95 (the host clock from the pass's start to the step that
returned the request), the continuous speedup and, with ``--spec-k``, the
pool's ``spec_stats``.

Flags of the JAX script that steer only XLA or the TPU are not carried
over: ``--platform`` (``--device`` takes its place).
"""

from __future__ import annotations

import argparse
import gc
import json
import time

import numpy as np
import torch

from opadpo_torch.constants import IMAGE_TOKEN_INDEX
from opadpo_torch.engine.sampler import Sampler
from opadpo_torch.engine.serving_config import (
    make_continuous_engine, make_serving_sampling,
)
from opadpo_torch.tools import common

TOOL = "bench_serve"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--bits", type=int, default=4, choices=(16, 8, 4))
    p.add_argument("--head-bits", type=int, default=4, choices=(16, 8, 4))
    p.add_argument("--kv-bits", type=int, default=8, choices=(8, 4),
                   help="the cache of both modes (4 halves it)")
    p.add_argument("--slots", type=int, default=8,
                   help="slot-pool size, and the batch mode's batch")
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--seg-len", type=int, default=64)
    p.add_argument("--admit-group", type=int, default=4, choices=(1, 2, 4))
    p.add_argument("--max-new", type=int, default=512)
    p.add_argument("--query-len", type=int, default=128)
    p.add_argument("--mode", default="both",
                   choices=("both", "continuous", "batch"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--budget-mix", default="short",
                   choices=("short", "long", "uniform"),
                   help="response lengths: 'short' chat / VQA traffic, "
                        "'long' rollout-like (toward the cap), 'uniform' "
                        "every request at --max-new")
    p.add_argument("--spec-k", type=int, default=0,
                   help="speculative segments in the pool: k drafts a "
                        "verify (needs --kv-bits 8)")
    p.add_argument("--spec-draft", default="ngram",
                   choices=("ngram", "oracle", "pad"),
                   help="'oracle': each request's own warm-up continuation "
                        "corrupted to --spec-accept (needs --spec-k)")
    p.add_argument("--spec-accept", type=float, default=0.8,
                   help="the oracle's per-token keep probability")
    p.add_argument("--greedy", action="store_true",
                   help="greedy decoding instead of the serving default "
                        "(top-k 30 / top-p 0.95); forced for the oracle")
    common.add_device_args(p, TOOL)
    args = p.parse_args(argv)
    try:
        check_args(args)
    except ValueError as e:
        p.error(str(e))
    return args


def check_args(args) -> None:
    if args.spec_draft == "oracle" and args.spec_k <= 0:
        raise ValueError("--spec-draft oracle needs --spec-k > 0 (the "
                         "oracle drafts feed speculative segments only)")
    if args.spec_k and args.kv_bits != 8:
        raise ValueError("speculative segments need the int8 pool "
                         "(--kv-bits 8)")


def budgets_of(rng: np.random.Generator, requests: int, max_new: int,
               mix: str) -> np.ndarray:
    """The JAX script's budget draw (fractions of ``max_new``)."""
    mn = max_new
    if mix == "short":
        return rng.choice(
            [max(1, mn // 16), max(1, mn // 8), max(1, mn // 4),
             max(1, mn // 2), mn], size=requests,
            p=[0.25, 0.25, 0.2, 0.15, 0.15]).astype(int)
    if mix == "long":
        return rng.choice(
            [max(1, mn // 4), max(1, mn // 2), max(1, 3 * mn // 4), mn],
            size=requests, p=[0.1, 0.2, 0.3, 0.4]).astype(int)
    return np.full(requests, mn, dtype=int)


def traffic(seed: int, requests: int, max_new: int, mix: str,
            query_len: int, vocab: int, image_size: int):
    """(budgets, requests [(ids, mask, image, budget)], the generator the
    oracle corruption continues from): the JAX script's draws in its
    order."""
    rng = np.random.default_rng(seed)
    budgets = budgets_of(rng, requests, max_new, mix)
    reqs = []
    for i in range(requests):
        q = rng.integers(5, vocab, (query_len,)).astype(np.int32)
        q[1] = IMAGE_TOKEN_INDEX
        reqs.append((q, np.ones_like(q),
                     np.zeros((image_size, image_size, 3), np.float32),
                     int(budgets[i])))
    return budgets, reqs, rng


def corrupt_oracles(rng: np.random.Generator, outs: list, accept: float,
                    k: int, vocab: int) -> list:
    """Each request's continuation with each token redrawn where
    ``rng.random() > accept``, padded by k + 1: the JAX script's calls."""
    oracles = []
    for out in outs:
        o = np.asarray(out).astype(np.int32).copy()
        corrupt = rng.random(o.shape) > accept
        o[corrupt] = rng.integers(5, vocab, int(corrupt.sum()))
        oracles.append(np.pad(o, (0, k + 1)))
    return oracles


def _latency(lat: np.ndarray, tokens: int, dt: float) -> dict:
    return {"tokens_per_sec": tokens / dt, "seconds": dt,
            "latency_mean_s": float(lat.mean()),
            "latency_p50_s": float(np.percentile(lat, 50)),
            "latency_p95_s": float(np.percentile(lat, 95))}


def run(args, model=None) -> dict:
    """The benchmark on ``model`` (drawn from ``--seed`` at ``--bits`` when
    None) -> the record."""
    check_args(args)
    if model is None:
        dev = common.device_of(args)
        _, model, _ = common.make_model(args.model, args.bits, dev,
                                        args.seed)
    dev = common.model_device(model)
    cfg = model.cfg
    vocab = cfg.llama.vocab_size
    budgets, reqs, rng = traffic(args.seed, args.requests, args.max_new,
                                 args.budget_mix, args.query_len, vocab,
                                 cfg.vision.image_size)
    total = int(budgets.sum())
    greedy = args.greedy or (args.spec_k > 0
                             and args.spec_draft == "oracle")
    if greedy:
        sampling = make_serving_sampling(
            max_new_tokens=args.max_new, eos_token_id=-1, greedy=True,
            top_k=0, top_p=1.0, temperature=1e-4)
    else:
        sampling = make_serving_sampling(max_new_tokens=args.max_new,
                                         eos_token_id=-1)
    rec = {"tool": TOOL, "card": common.card_line(dev), "model": args.model,
           "requests": args.requests, "slots": args.slots,
           "seg_len": args.seg_len, "admit_group": args.admit_group,
           "max_new": args.max_new, "bits": common.base_bits(model),
           "kv_bits": args.kv_bits, "head_bits": args.head_bits,
           "query_len": args.query_len, "budget_mix": args.budget_mix,
           "seed": args.seed, "tokens": total,
           "target": "greedy" if greedy else "sampled_topk30"}
    ran = {"prefills": [], "pool": []}

    if args.mode in ("both", "continuous"):
        eng = make_continuous_engine(
            model, sampling, slots=args.slots, qlen=args.query_len,
            seg_len=args.seg_len, max_admit_group=args.admit_group,
            kv_bits=args.kv_bits, spec_k=args.spec_k,
            spec_draft=args.spec_draft, collect_spec_stats=args.spec_k > 0,
            head_bits=args.head_bits,
            generator=torch.Generator(device=dev).manual_seed(args.seed))

        def run_pool(oracles=None):
            rid_to_idx = {}
            for i, (q, m, im, budget) in enumerate(reqs):
                rid = eng.add_request(
                    q, m, im, max_new=budget,
                    oracle_tokens=None if oracles is None else oracles[i])
                rid_to_idx[rid] = i
            before = {"admit_groups": len(eng.stats["admit_groups"]),
                      "forwards": eng.stats["forwards"],
                      "tokens": eng.stats["tokens"]}
            common.sync(dev)
            t0 = time.perf_counter()
            lat, outs = [], {}
            while eng.has_work():
                for rid, toks in eng.step():
                    lat.append(time.perf_counter() - t0)
                    outs[rid_to_idx[rid]] = np.asarray(toks)
            dt = time.perf_counter() - t0
            if len(lat) != args.requests:
                raise RuntimeError(f"{len(lat)} of {args.requests} requests "
                                   "returned")
            ran["pool"].append({
                "admit_groups": eng.stats["admit_groups"][
                    before["admit_groups"]:],
                "forwards": eng.stats["forwards"] - before["forwards"],
                "tokens": eng.stats["tokens"] - before["tokens"]})
            return dt, np.asarray(lat), outs

        with torch.inference_mode():
            _, _, warm_outs = run_pool()          # warm-up; seeds the oracle
            oracles = None
            if args.spec_k and args.spec_draft == "oracle":
                oracles = corrupt_oracles(rng, [warm_outs[i] for i in
                                                range(args.requests)],
                                          args.spec_accept, args.spec_k,
                                          vocab)
            eng.spec_stats = {"groups": 0, "accepted_drafts": 0,
                              "tokens": 0}
            common.reset_peak(dev)
            dt, lat, outs = run_pool(oracles)
        over = [i for i in range(args.requests)
                if len(outs[i]) != reqs[i][3]]
        if over:
            raise RuntimeError(f"requests {over} did not run to their "
                               "budgets")
        rec["continuous"] = _latency(lat, total, dt)
        rec["continuous"]["peak_gb"] = common.peak_gb(dev)
        if args.spec_k:
            st = eng.spec_stats
            rec["continuous"]["spec"] = {
                "k": args.spec_k, "draft": args.spec_draft,
                "target_accept": (args.spec_accept
                                  if args.spec_draft == "oracle" else None),
                "groups": st["groups"],
                "accepted_drafts": st["accepted_drafts"],
                "verify_tokens": st["tokens"],
                "accept_rate": st["accepted_drafts"]
                / max(1, st["groups"] * args.spec_k),
                "exact_match_nonspec_warmup": all(
                    np.array_equal(warm_outs[i], outs[i])
                    for i in range(args.requests))}
        del eng
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    if args.mode in ("both", "batch"):
        samplers = {}
        dev_reqs = [(torch.from_numpy(q.astype(np.int64)),
                     torch.from_numpy(m.astype(np.int64)),
                     torch.from_numpy(im)) for q, m, im, _ in reqs]

        def run_batch():
            common.sync(dev)
            t0 = time.perf_counter()
            lat = []
            for i in range(0, args.requests, args.slots):
                idx = list(range(i, min(i + args.slots, args.requests)))
                n_real = len(idx)
                idx += [idx[-1]] * (args.slots - n_real)
                cap = -(-max(reqs[j][3] for j in idx[:n_real]) // 128) * 128
                if cap not in samplers:
                    samplers[cap] = Sampler(
                        make_serving_sampling(max_new_tokens=cap,
                                              eos_token_id=-1),
                        kv_bits=args.kv_bits, head_bits=args.head_bits,
                        chunk=256)
                q, m, im = (torch.stack([dev_reqs[j][c] for j in idx])
                            .to(dev) for c in range(3))
                out = samplers[cap].generate(
                    model, q, m, im,
                    torch.Generator(device=dev).manual_seed(i))
                out.cpu()
                # every request of the batch returns with the whole batch
                lat.extend([time.perf_counter() - t0] * n_real)
            return time.perf_counter() - t0, np.asarray(lat)

        with torch.inference_mode():
            if args.mode == "batch":
                run_batch()          # warm-up (after the pool, the kernels
            common.reset_peak(dev)   # are loaded: nothing compiles a shape)
            dt, lat = run_batch()
        rec["batch_sync"] = _latency(lat, total, dt)
        rec["batch_sync"]["peak_gb"] = common.peak_gb(dev)
        ran["prefills"] = [{"batch_rows": s["batch_rows"],
                            "prompt_positions": s["prompt_positions"],
                            "decode_steps": s["decode_steps"]}
                           for smp in samplers.values() for s in smp.stats]

    if "continuous" in rec and "batch_sync" in rec:
        rec["continuous_speedup"] = (rec["continuous"]["tokens_per_sec"]
                                     / rec["batch_sync"]["tokens_per_sec"])
    rec["ran"] = ran
    return rec


def main(argv=None) -> int:
    args = parse_args(argv)
    rec = run(args)
    print(json.dumps(rec), flush=True)
    common.write_record(rec, args.out or common.default_out(TOOL))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
