"""Speculative decode against plain decode on LLaVA-1.5-7B (or ``--model
13b``) at full width with random weights from a seed: an int4 base, an
int8 prompt cache and an int4 decode head, a small batch.  Counterpart of
``scripts/bench_spec.py``.

    python -m opadpo_torch.tools.bench_spec [--batch 1] [--steps 256]
        [--k 4] [--greedy | --sampled] [--accept-rates 1.0,0.8,0.6]
        [--advance shared|per_row] [--model 7b|13b|tiny]
        [--device cuda|cpu] [--out PATH]

- ``baseline``: ``decode_loop_unrolled`` after one prefill;
- ``spec_oracle_a<rate>``: ``engine/speculative.decode_loop_spec`` with
  the "oracle" draft, a continuation each of whose tokens is kept with
  probability ``rate`` and otherwise redrawn (``oracle_drafts``: the JAX
  script's numpy calls), the controlled-acceptance curve.  The JAX script
  takes the baseline's tokens, which on the TPU equal greedy speculative
  decode's; in bf16 on the GPU a verify forward of k + 1 rows rounds
  otherwise than a one-row step, greedy speculative decode parts from
  plain greedy at near-ties, and after such a departure the baseline's
  tokens stop being drafts the verify accepts.  So under greedy the port
  takes speculative decode's own continuation (one untimed pass with
  "pad" drafts); under ``--sampled``, the baseline's, as the JAX script;
- ``spec_ngram``: the zero-cost n-gram draft.

Each run decodes from the same prefill (host clock ending in a
synchronise): the baseline once to warm up, then timed; each speculative
run once, timed, its verify logits copied to the host as it goes (a
fraction of a per cent of a group's time; the host reads each group's
verdicts anyway).  It reports tokens/s, tokens emitted
per verify group, the accept rate, the groups, the speedup over the
baseline and, under greedy, ``exact_match_baseline`` (greedy speculative
decode equals plain greedy decode up to the shortest row) and, where they
part, each row's first departure judged as the smoke's Queue 3 check
judges one: the baseline's top-2 logit gap there against the largest
|logits(verify) - logits(plain step)| over the vocabulary (a near-tie
where the gap is the smaller; bf16 verify forwards of k + 1 rows round
otherwise than single-row steps).  A model given to ``run`` is used as it
is (its base as given: ``--bits`` only sizes a drawn one).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from opadpo_torch.constants import IMAGE_TOKEN_INDEX
from opadpo_torch.engine.sampler import Sampler, decode_loop_unrolled
from opadpo_torch.engine.serving_config import make_serving_sampling
from opadpo_torch.engine.speculative import SpecConfig, decode_loop_spec
from opadpo_torch.models import llava
from opadpo_torch.tools import common

TOOL = "bench_spec"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--greedy", action="store_true", default=True)
    ap.add_argument("--sampled", dest="greedy", action="store_false",
                    help="temperature-1 top-k-30 target instead of greedy")
    ap.add_argument("--accept-rates", default="1.0,0.8,0.6")
    ap.add_argument("--advance", default="shared",
                    choices=("shared", "per_row"),
                    help="per_row: every row keeps its own accepted run")
    ap.add_argument("--bits", type=int, default=4, choices=(16, 8, 4),
                    help="the base drawn when no model is given")
    ap.add_argument("--head-bits", type=int, default=4, choices=(16, 8, 4))
    ap.add_argument("--seed", type=int, default=0)
    common.add_device_args(ap, TOOL)
    return ap.parse_args(argv)


def prompts(cfg, batch: int, qlen: int):
    """(the numpy generator, ids): the JAX script's ``default_rng(0)``
    prompts, the image token second."""
    rng = np.random.default_rng(0)
    q = rng.integers(5, cfg.llama.vocab_size, (batch, qlen)).astype(np.int32)
    q[:, 1] = IMAGE_TOKEN_INDEX
    return rng, q


def oracle_drafts(rng: np.random.Generator, base: np.ndarray, accept: float,
                  k: int, vocab: int) -> np.ndarray:
    """The baseline's tokens [B, steps] with each redrawn where
    ``rng.random() > accept``, padded by k + 1: the JAX script's calls."""
    orac = base.copy()
    mask = rng.random(orac.shape) > accept
    orac[mask] = rng.integers(5, vocab, mask.sum())
    return np.pad(orac, ((0, 0), (0, k + 1)))


class LogitRecorder:
    """While open, the logits of every decode step (``plain``: [B, V] a
    step) and verify forward (``verify``: [B, G, V] a group), on the host
    in f32."""

    NAMES = ("decode_step_unrolled", "decode_step_multi",
             "decode_step_multi_pr")

    def __enter__(self):
        self.plain, self.verify = [], []
        self._saved = [getattr(llava, n) for n in self.NAMES]
        rec = self

        def wrap(fn, store):
            def step(*a, **kw):
                logits, cache = fn(*a, **kw)
                store.append(logits.float().cpu())
                return logits, cache
            return step

        for name, fn in zip(self.NAMES, self._saved):
            setattr(llava, name, wrap(fn, rec.plain if name ==
                                      "decode_step_unrolled" else rec.verify))
        return self

    def __exit__(self, *exc):
        for name, fn in zip(self.NAMES, self._saved):
            setattr(llava, name, fn)


def first_departures(base, spec, plain_logits, verify_logits, advances):
    """Each row's first position where ``spec`` parts from ``base`` (both
    [B, T] on the host), with the baseline's top-2 gap there and the
    largest |logits(verify) - logits(plain)| (``near_tie``: the gap is the
    smaller)."""
    out = []
    for b in range(base.shape[0]):
        differ = torch.nonzero(base[b] != spec[b])
        if not len(differ):
            continue
        pos = int(differ[0])
        dep = {"row": b, "position": pos, "judged": False}
        lp, ls, e = None, None, 1
        if 0 < pos <= len(plain_logits):
            lp = plain_logits[pos - 1][b]
            for gi, adv in enumerate(advances):
                if e <= pos < e + adv[b]:
                    ls = verify_logits[gi][b, pos - e]
                    break
                e += adv[b]
        if lp is not None and ls is not None:
            top2 = lp.topk(2).values
            dep.update(judged=True,
                       tokens_base_spec=[int(base[b, pos]),
                                         int(spec[b, pos])],
                       plain_top2_gap=float(top2[0] - top2[1]),
                       max_abs_logit_diff=float((ls - lp).abs().max()))
            dep["near_tie"] = dep["plain_top2_gap"] < \
                dep["max_abs_logit_diff"]
        out.append(dep)
    return out


def run(args, model=None) -> dict:
    """The benchmark on ``model`` (drawn from ``--seed`` with an int4 base
    when None) -> the record."""
    if model is None:
        dev = common.device_of(args)
        _, model, _ = common.make_model(args.model, args.bits, dev,
                                        args.seed)
    dev = common.model_device(model)
    cfg = model.cfg
    b, steps, k = args.batch, args.steps, args.k
    tiny = cfg.llama.num_layers < 8
    v = cfg.llama.vocab_size
    rng, q = prompts(cfg, b, 10 if tiny else 128)
    ids = torch.from_numpy(q.astype(np.int64)).to(dev)
    sz = cfg.vision.image_size
    images = torch.zeros((b, sz, sz, 3), dtype=torch.bfloat16, device=dev)
    if args.greedy:
        sampling = make_serving_sampling(max_new_tokens=steps,
                                         eos_token_id=-1, greedy=True,
                                         top_k=0, top_p=1.0,
                                         temperature=1e-4)
    else:
        sampling = make_serving_sampling(max_new_tokens=steps,
                                         eos_token_id=-1)
    sampler = Sampler(sampling, kv_bits=8, head_bits=args.head_bits)
    head = sampler.decode_head(model)
    with torch.inference_mode():
        pf = sampler.prefill(model, ids, torch.ones_like(ids), images,
                             head=head)
    common.sync(dev)
    common_args = (model, pf["kv_list"], pf["key_mask"],
                   pf["next_position"], pf["last_logits"])

    def gen():
        return torch.Generator(device=dev).manual_seed(1)

    def timed(fn, warm):
        """(fn's result, seconds, its logits): a timed call, after a
        warm-up call whose logits are kept, or recording its own."""
        with torch.inference_mode():
            if warm:
                with LogitRecorder() as rec:
                    fn()
                out, dt = common.timed(fn, dev)
            else:
                with LogitRecorder() as rec:
                    out, dt = common.timed(fn, dev)
        return out, dt, rec

    (base_out, base_fwd), base_dt, base_rec = timed(
        lambda: decode_loop_unrolled(*common_args, gen(), sampling,
                                     head=head), warm=True)
    rec = {"tool": TOOL, "card": common.card_line(dev), "model": args.model,
           "batch": b, "steps": steps, "k": k,
           "target": "greedy" if args.greedy else "sampled_topk30",
           "advance": args.advance, "bits": common.base_bits(model),
           "kv_bits": 8, "head_bits": args.head_bits,
           "config": f"int{common.base_bits(model)}_kv8_head"
                     f"{args.head_bits}",
           "prompt_positions": int(pf["key_mask"].shape[1]),
           "baseline": {"steps_per_sec": steps / base_dt,
                        "tokens_per_sec": steps * b / base_dt,
                        "decode_forwards": base_fwd}}
    ran = {"prefills": 1, "decode_forwards": 2 * base_fwd,
           "verify_groups": 0}

    def run_spec(draft, oracle=None, label=None):
        spec = SpecConfig(k=k, draft=draft, advance=args.advance)
        o = (torch.from_numpy(oracle.astype(np.int64)).to(dev)
             if oracle is not None else
             torch.zeros((b, steps + k + 1), dtype=torch.int64, device=dev))
        (out, stats), dt, logits = timed(lambda: decode_loop_spec(
            *common_args, gen(), sampling, spec, head=head,
            oracle_tokens=o), warm=False)
        tk = np.asarray(stats["row_tokens"])
        total_toks = int(tk.sum())
        min_toks = int(tk.min())
        groups = int(stats["groups"])
        acc = int(stats["accepted_drafts"])
        denom = groups * k * (b if args.advance == "per_row" else 1)
        entry = {"tokens_per_sec": total_toks / dt,
                 "emitted_per_group": total_toks / b / max(groups, 1),
                 "accept_rate": acc / max(denom, 1), "groups": groups,
                 "speedup_vs_baseline": (total_toks / dt)
                 / (steps * b / base_dt)}
        if args.greedy:
            a, s_ = base_out[:, :min_toks].cpu(), out[:, :min_toks].cpu()
            entry["exact_match_baseline"] = bool(torch.equal(a, s_))
            if not entry["exact_match_baseline"]:
                entry["first_departures"] = first_departures(
                    a, s_, base_rec.plain, logits.verify, stats["advances"])
        ran["verify_groups"] += groups
        rec[label or f"spec_{draft}"] = entry

    source = base_out
    if args.greedy:
        with torch.inference_mode():
            source, st = decode_loop_spec(
                *common_args, gen(), sampling,
                SpecConfig(k=k, draft="pad", advance=args.advance),
                head=head)
        ran["verify_groups"] += st["groups"]
    rec["oracle_source"] = "spec_pad" if args.greedy else "baseline"
    source = source.cpu().numpy().astype(np.int32)
    for a in [float(x) for x in args.accept_rates.split(",")]:
        run_spec("oracle", oracle_drafts(rng, source, a, k, v),
                 label=f"spec_oracle_a{a}")
    run_spec("ngram")
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
