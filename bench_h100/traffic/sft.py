"""Stage 3's traffic: back-to-back OPA LoRA-SFT micro-steps
(``sft_train_step``) with the adapter on the decoder, the vision tower and
the projector, and remat, and their check against the reference.

The micro-batch of step ``i`` comes from ``(seed, i)`` alone: ``batch``
rows of a templated conversation, the image token second, right-padded to
``text_len`` tokens; the valid lengths a fixed ladder over [``text_min``,
``text_len``] ordered by the seed, so every step and every seed does the
same work; the first ``unlabelled`` tokens (the prompt) and the pads
unlabelled; token ids uniform over [5, vocab); images N(0, 1) in the
CLIP-normalised layout.  Every micro-step applies its update (the recipe
averages 8 before one update; the update is a few milliseconds of a
micro-step of seconds).
"""

from __future__ import annotations

import torch

from bench_h100 import check, program, training, weights
from bench_h100.traffic.dpo import ladder
from bench_h100.weights import mix

IMAGE_TOKEN = -200
IGNORE = -100


def make_batch(tp: dict, cfg: dict, seed: int, step: int, device) -> dict:
    g = torch.Generator(device=device).manual_seed(mix(seed, step, 7))
    b, n = tp["batch"], tp["text_len"]
    size = cfg["vision"]["image_size"]
    lens = torch.tensor(ladder(tp["text_min"], n, b), device=device)[
        torch.randperm(b, generator=g, device=device)]
    pos = torch.arange(n, device=device)[None]
    mask = (pos < lens[:, None]).long()
    ids = torch.randint(5, cfg["vocab_size"], (b, n), generator=g,
                        device=device) * mask
    ids[:, 1] = IMAGE_TOKEN
    labels = torch.where((pos >= tp["unlabelled"]) & (mask > 0), ids,
                         torch.full_like(ids, IGNORE))
    return {"input_ids": ids, "attention_mask": mask, "labels": labels,
            "images": torch.randn((b, size, size, 3), generator=g,
                                  device=device)}


class Program(training.Steps):
    """The port's stage-3 step objects, built once from the seed."""

    def __init__(self, ctx):
        from opadpo_torch.engine import sft as sft_engine

        cfg, seed, dev = ctx.cfg, ctx.seed, ctx.device
        lora = program.lora_tree(weights.draw_lora(cfg, seed, dev),
                                 weights.draw_vision_lora(cfg, seed, dev))
        super().__init__(ctx, lora, ctx.traffic)
        self.engine = sft_engine
        self.sft = sft_engine.SftConfig(
            lora_scaling=training.lora_scaling(cfg))
        self.positions = []
        self.patches = (cfg["vision"]["image_size"]
                        // cfg["vision"]["patch_size"]) ** 2

    def one(self, step: int, spans):
        batch = make_batch(self.tp, self.cfg, self.seed, step, self.device)
        if "half_batch" in self.faults:
            half = self.tp["batch"] // 2
            batch = {k: v[:half] for k, v in batch.items()}
        if spans is None:
            spans = training.no_span
        else:
            self.positions.append((batch["attention_mask"].sum(1),
                                   (batch["labels"][:, 1:] != IGNORE).sum(1)))
        with spans("sft_train_step"):
            if "unchanged" in self.faults:
                loss, _ = self.engine.sft_loss(self.state.params, self.model,
                                               self.sft, batch)
                return loss
            self.state, stats = self.engine.sft_train_step(
                self.state, self.model, batch, self.opt, self.sft)
        loss = stats["loss/total"]
        return loss * 1.01 if "altered" in self.faults else loss

    def window_record(self) -> dict:
        """``sft_tokens_per_s``: the valid spliced positions of the
        window's micro-steps over the window; the work of the same."""
        from bench_h100 import work

        lengths = [[int(x) + self.patches - 1 for x in m.tolist()]
                   for m, _ in self.positions]
        total = sum(sum(ls) for ls in lengths)
        acc: dict = {}
        for ls, (_, lab) in zip(lengths, self.positions):
            one = work.sft_step(self.cfg, training.stated_precision(self.cfg),
                                ls, lab.tolist())
            for k, v in one.items():
                acc[k] = acc.get(k, 0.0) + v
        return {"metrics": {"sft_tokens_per_s":
                            lambda seconds, n: total / seconds},
                "work": acc}


def reference(cfg: dict, tp: dict, seed: int, device, steps: int,
              precision: dict) -> dict:
    """The checked micro-steps in plain PyTorch from the seed."""
    from bench_h100.reference import sft as ref_sft
    from bench_h100.reference.llava import Llava, NoTF32
    from bench_h100.reference.optim import AdamW

    with NoTF32():
        model = Llava(cfg, weights.draw_weights(cfg, seed, device), precision)
        blocks, proj = weights.draw_vision_lora(cfg, seed, device)
        lora = {"llama": weights.draw_lora(cfg, seed, device),
                "vision": blocks, "projector": proj}
        leaves = [(k, t.requires_grad_(True))
                  for k, t in ref_sft.leaves(lora)]
        scaling = training.lora_scaling(cfg)

        def loss_of(step):
            batch = make_batch(tp, cfg, seed, step, device)
            return ref_sft.loss(model, batch, lora, scaling)

        return training.follow(leaves, AdamW([t for _, t in leaves], tp),
                               steps, loss_of)


def program_side(ctx, window: bool = True) -> dict:
    return training.program_side(ctx, Program, window)


def reference_side(ctx) -> dict:
    return training.reference_side(ctx, reference)


def compare(prog: dict, ref: dict) -> list:
    """The training numbers, and ``grad_mean_gap``: the first gradients'
    mean leaf gap, which the program in a lower precision moves where the
    worst leaf is the rounding noise of one small vision leaf."""
    return training.compare(prog, ref) + [
        ("grad_mean_gap", check.leaf_mean_gap(prog["grads"], ref["grads"]))]


def run(ctx) -> dict:
    """Set-up, the window and the check -> the run's record for run.py."""
    rec = program_side(ctx)
    rec["checks"] = compare(rec, reference_side(ctx))
    return rec
