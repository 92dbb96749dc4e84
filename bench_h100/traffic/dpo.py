"""Stage 4's traffic: back-to-back OPA-DPO steps, each ``rollout_score``
under the frozen adapter and then ``dpo_train_step`` on a fresh
per-device batch (noptepochs 1), and its check against the reference.

The batch of step ``i`` comes from ``(seed, i)`` alone:

- queries of ``query_len`` positions, left-padded, the image token second
  in the valid part; the valid lengths are a fixed ladder over
  [``query_min``, ``query_len``], ordered by the seed;
- three responses per example (ground truth, AI-corrected, original),
  right-padded to ``response_len``; their lengths are a fixed ladder of
  3 x batch values over [``response_min``, ``response_len``], ordered by
  the seed, so every step and every seed does the same work;
- token ids uniform over [5, vocab); per-sentence scores and image
  relations, the sentences 8 to 40 tokens long;
- images N(0, 1) in the CLIP-normalised layout [B, H, W, 3].

Set-up builds the model, the adapter and the optimizer once, drives them
through the first ``checked_steps`` steps (the warm-up, and what the
check reads), and hands the same objects to the window.  After the window
the program's state is freed and the reference follows those steps from
the seed; compared are each step's loss, each adapter leaf's first
gradient (from AdamW's first moment after step 1) and each leaf's change
over the checked steps.
"""

from __future__ import annotations

import torch

from bench_h100 import check, program, training, weights
from bench_h100.weights import mix

IMAGE_TOKEN = -200
KEYS = ("standard_response", "original_generate_response",
        "AI_pseudo_response")
# the scoring pass's outputs under the reference's names
SCORED = {"std": "ref_base_standard_response_logprobs",
          "orig": "ref_base_original_generate_response_logprobs",
          "ai": "ref_base_AI_pseudo_response_logprobs",
          "mstd": "ref_mask_standard_response_logprobs",
          "mai": "ref_mask_AI_pseudo_response_logprobs"}


def ladder(lo: int, hi: int, n: int) -> list:
    return [int(round(lo + (hi - lo) * (i + 0.5) / n)) for i in range(n)]


def _sentences(g, rows: int, r: int, lens, values, probs, device):
    """Per-token weights [rows, r]: runs of 8..40 tokens, each run one
    value drawn with ``probs``; zero past each row's length."""
    n = r // 8 + 1
    runs = torch.randint(8, 41, (rows, n), generator=g, device=device)
    ends = runs.cumsum(1)
    pos = torch.arange(r, device=device).expand(rows, r).contiguous()
    idx = torch.searchsorted(ends, pos, right=True).clamp(max=n - 1)
    pick = torch.multinomial(torch.tensor(probs, device=device).expand(
        rows, -1), n, replacement=True, generator=g)
    w = torch.tensor(values, device=device)[pick].gather(1, idx)
    return w * (pos < lens[:, None])


def make_batch(tp: dict, cfg: dict, seed: int, step: int, device) -> dict:
    g = torch.Generator(device=device).manual_seed(mix(seed, step, 3))
    b, q, r = tp["batch"], tp["query_len"], tp["response_len"]
    v = cfg["vocab_size"]
    size = cfg["vision"]["image_size"]
    qlen = torch.tensor(ladder(tp["query_min"], q, b), device=device)[
        torch.randperm(b, generator=g, device=device)]
    start = q - qlen
    ar = torch.arange(q, device=device)
    qmask = (ar[None] >= start[:, None]).long()
    queries = torch.randint(5, v, (b, q), generator=g, device=device) * qmask
    queries[torch.arange(b, device=device), start + 1] = IMAGE_TOKEN
    batch = {"queries": queries, "queries_attention_mask": qmask,
             "images": torch.randn((b, size, size, 3), generator=g,
                                   device=device)}
    rl = torch.tensor(ladder(tp["response_min"], r, 3 * b), device=device)[
        torch.randperm(3 * b, generator=g, device=device)].view(b, 3)
    ar = torch.arange(r, device=device)
    for t, key in enumerate(KEYS):
        m = (ar[None] < rl[:, t:t + 1]).long()
        batch[key] = torch.randint(5, v, (b, r), generator=g,
                                   device=device) * m
        batch[key + "_attention_mask"] = m
    sw, rw = tp["score_weights"], tp["relation_weights"]
    batch["AI_pseudo_response_scores"] = _sentences(
        g, b, r, rl[:, 2], sw, [1.0] * len(sw), device)
    batch["original_generate_response_scores"] = _sentences(
        g, b, r, rl[:, 1], sw, [1.0] * len(sw), device)
    batch["AI_pseudo_response_image_relations"] = _sentences(
        g, b, r, rl[:, 2], rw, tp["relation_probs"], device)
    return batch


def copo_generator(seed: int, step: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(seed, step, 4))


# ---------------------------------------------------------------------------
# The program
# ---------------------------------------------------------------------------

class Program(training.Steps):
    """The port's stage-4 step objects, built once from the seed."""

    def __init__(self, ctx):
        from opadpo_torch.engine import dpo as dpo_engine

        tp = ctx.traffic
        lora = program.lora_tree(weights.draw_lora(ctx.cfg, ctx.seed,
                                                   ctx.device))
        super().__init__(ctx, lora, tp)
        self.engine = dpo_engine
        self.dpo = dpo_engine.DpoConfig(
            beta=tp["beta"], CoPO_mask_ratio=tp["CoPO_mask_ratio"],
            CoPO_coef=tp["CoPO_coef"], response_len=tp["response_len"],
            query_len=tp["query_len"],
            lora_scaling=training.lora_scaling(ctx.cfg))
        self.lengths = []
        self.scores = None

    def batch(self, step: int) -> dict:
        batch = make_batch(self.tp, self.cfg, self.seed, step, self.device)
        if "half_batch" in self.faults:
            half = self.tp["batch"] // 2
            batch = {k: v[:half] for k, v in batch.items()}
        return batch

    def one(self, step: int, spans):
        """``rollout_score`` under the frozen adapter (``self.start``), then
        ``dpo_train_step`` -> the loss; ``spans`` marks both in a traced
        window."""
        batch = self.batch(step)
        if spans is None:
            spans = training.no_span
        else:
            self.lengths.append(_lengths(batch))
        with spans("rollout_score"):
            out = self.engine.rollout_score(
                self.model, self.dpo, self.start, batch,
                copo_generator(self.seed, step, self.device))
            if "altered" in self.faults:
                out["ref_base_standard_response_logprobs"][0] += 1.0
        if self.scores is None:
            self.scores = {k: out[v].detach().clone()
                           for k, v in SCORED.items()}
        full = {**batch, **out}
        with spans("dpo_train_step"):
            if "unchanged" in self.faults:
                return self.engine.loss_and_grads(self.state, self.model,
                                                  self.dpo, full)[0]
            self.state, stats = self.engine.dpo_train_step(
                self.state, self.model, full, self.opt, self.dpo)
        return stats["loss/total"]

    def readings(self) -> dict:
        """The first scoring pass's log-probs, for the check."""
        return {"scores": self.scores}

    def window_record(self) -> dict:
        return {"metrics": {"dpo_step_s": lambda seconds, n: seconds / n},
                "work": _window_work(self.cfg, self.lengths)}


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------

def reference(cfg: dict, tp: dict, seed: int, device, steps: int,
              precision: dict) -> dict:
    """The checked steps in plain PyTorch from the seed -> losses, first
    gradients and changes, as the program's record."""
    from bench_h100.reference import dpo as ref_dpo
    from bench_h100.reference.llava import Llava, NoTF32
    from bench_h100.reference.optim import AdamW

    with NoTF32():
        model = Llava(cfg, weights.draw_weights(cfg, seed, device), precision)
        lora = weights.draw_lora(cfg, seed, device)
        frozen = [{n: {ab: t.detach().clone() for ab, t in e.items()}
                   for n, e in layer.items()} for layer in lora]
        leaves = [(k, t.requires_grad_(True))
                  for k, t in ref_dpo.leaves(lora)]
        scaling = training.lora_scaling(cfg)
        first = {}

        def loss_of(step):
            batch = make_batch(tp, cfg, seed, step, device)
            masked = ref_dpo.masked_images(
                batch["images"], copo_generator(seed, step, device),
                tp["CoPO_mask_ratio"])
            ref = ref_dpo.score(model, batch, masked, frozen, scaling)
            if not first:
                first.update(ref)
            return ref_dpo.loss(model, batch, masked, ref, lora, tp, scaling)

        out = training.follow(leaves, AdamW([t for _, t in leaves], tp),
                              steps, loss_of)
        return dict(out, scores=first)


# ---------------------------------------------------------------------------
# One run of a cell
# ---------------------------------------------------------------------------

def program_side(ctx, window: bool = True) -> dict:
    return training.program_side(ctx, Program, window)


def reference_side(ctx) -> dict:
    return training.reference_side(ctx, reference)


def compare(prog: dict, ref: dict) -> list:
    """The training numbers, and ``score_gap``: the widest gap of a scored
    token's log-prob in the first scoring pass (the frozen adapter's
    ``rollout_score``), over the rows both sides scored."""
    return training.compare(prog, ref) + [
        ("score_gap", check.widest_gap(prog["scores"], ref["scores"]))]


def run(ctx) -> dict:
    """Set-up, the window and the check -> the run's record for run.py."""
    rec = program_side(ctx)
    rec["checks"] = compare(rec, reference_side(ctx))
    return rec


def _lengths(batch: dict):
    """(query lengths [B], response lengths [B, 3]) of a batch, on the
    device (read after the window)."""
    return (batch["queries_attention_mask"].sum(1),
            torch.stack([batch[k + "_attention_mask"].sum(1) for k in KEYS],
                        1))


def _window_work(cfg: dict, lengths: list) -> dict:
    """The required work of the window's steps (``bench_h100/work.py``),
    summed."""
    from bench_h100 import work as work_mod

    patches = (cfg["vision"]["image_size"]
               // cfg["vision"]["patch_size"]) ** 2
    total: dict = {}
    for q, r in lengths:
        prefix = [int(x) - 1 + patches for x in q.tolist()]
        one = work_mod.dpo_step(cfg, training.stated_precision(cfg), prefix,
                                r.tolist())
        for k, v in one.items():
            total[k] = total.get(k, 0.0) + v
    return total
