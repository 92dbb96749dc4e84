"""What the training cells share: the port's model, adapter and AdamW built
once from the seed, set-up through the checked steps, the window of whole
steps, and the three numbers of the check.

A traffic module subclasses ``Steps`` with ``one(step, spans)``, one
training step on the batch of ``(seed, step)`` -> its loss, and
``window_record()``, the cell's end-to-end metric and the work
(``work.py``) of the window's steps.  Set-up drives the object through
``checked_steps`` steps and hands the same object to the window.  The check
compares each step's loss, each adapter leaf's first gradient (from
AdamW's first moment after step 1, mu = (1 - b1) g) and each leaf's change
over the checked steps with what the reference worked out from the seed.
"""

from __future__ import annotations

import contextlib
import math
import time

import torch

from bench_h100 import check, program, weights


def lora_scaling(cfg: dict) -> float:
    t = cfg["training"]
    return t["lora_alpha"] / t["lora_r"]


@contextlib.contextmanager
def no_span(name: str):
    """The spans of an untraced step: nothing."""
    yield


def stated_precision(cfg: dict) -> dict:
    """The base's precision as the configuration states it."""
    t = cfg["training"]
    return {k: t[k] for k in ("bits", "act_bits", "act_bwd_int8")}


class Steps:
    def __init__(self, ctx, lora_tree: dict, opt_cfg: dict):
        from opadpo_torch.engine.train_state import (
            AdamW, OptimizerConfig, TrainState)
        from opadpo_torch.models.lora import make_trainable, named_leaves

        self.cfg, self.tp = ctx.cfg, ctx.traffic
        self.seed, self.device = ctx.seed, ctx.device
        self.faults = set(ctx.faults)
        self.named_leaves = named_leaves
        state_dict = weights.draw_weights(self.cfg, self.seed, self.device)
        self.model = program.build_model(self.cfg, state_dict, self.device,
                                         ctx.program_precision)
        del state_dict
        self.start = lora_tree
        self.opt = AdamW(OptimizerConfig(
            learning_rate=opt_cfg["learning_rate"],
            lr_scheduler_type="cosine", warmup_steps=0,
            total_steps=opt_cfg["total_steps"],
            max_grad_norm=opt_cfg["max_grad_norm"]))
        self.state = TrainState.create(make_trainable(lora_tree),
                                       self.opt.cfg)

    def readings(self) -> dict:
        """What else the check compares, beside the losses, the first
        gradients and the changes."""
        return {}

    def first_gradients(self) -> dict:
        b1 = self.opt.cfg.b1
        return {program.leaf_name(k): float(
            torch.linalg.vector_norm(mu.float()) / (1 - b1))
            for (k, _), mu in zip(self.named_leaves(self.state.params),
                                  self.state.mu)}

    def changes(self) -> dict:
        start = {program.leaf_name(k): t
                 for k, t in self.named_leaves(self.start)}
        return {program.leaf_name(k): float(torch.linalg.vector_norm(
            (t.detach() - start[program.leaf_name(k)]).float()))
            for k, t in self.named_leaves(self.state.params)}


def program_side(ctx, make, window: bool = True) -> dict:
    """Set-up (``make(ctx)`` and the checked steps) and, with ``window``,
    the window -> the program's record; its state is gone on return."""
    checked = ctx.traffic["checked_steps"]
    t0 = time.perf_counter()
    prog = make(ctx)
    ctx.sync()
    ctx.log(f"set-up: model and adapter {time.perf_counter() - t0:.2f} s")
    ctx.reset_peak()
    losses, grads = [], None
    for step in range(1, checked + 1):
        losses.append(float(prog.one(step, None).detach()))
        if grads is None:
            grads = prog.first_gradients()
        ctx.log(f"set-up: step {step} done at "
                f"{time.perf_counter() - t0:.2f} s")
    changes = prog.changes()
    ctx.sync()
    setup_s = time.perf_counter() - t0
    rec = {"setup_s": setup_s, "losses": losses, "grads": grads,
           "changes": changes}
    rec.update(prog.readings())
    if not window:
        rec["peak_bytes"] = ctx.peak_bytes()
        del prog
        ctx.release()
        return rec
    win = ctx.window()
    step, n, window_losses, ends = checked, 0, [], []
    with win:
        while True:
            step += 1
            window_losses.append(prog.one(step, win.spans))
            n += 1
            ctx.sync()
            ends.append(win.elapsed())
            if ends[-1] >= ctx.seconds:
                break
    ctx.log("window: steps end at " + " ".join(f"{t:.3f}" for t in ends))
    if ctx.trace:
        ctx.log(f"window: trace stopped and read in {win.read_s:.1f} s, "
                f"{len(win.kernels)} device and {len(win.host)} host events")
    done = prog.window_record()
    rec.update(
        steps=n, window=win, work=done["work"] if ctx.trace else {},
        metrics={k: v(win.seconds, n) for k, v in done["metrics"].items()},
        attempted=checked + n, peak_bytes=ctx.peak_bytes(),
        failed=sum(1 for x in losses + [float(t.detach())
                                         for t in window_losses]
                   if not math.isfinite(x)))
    del prog, window_losses
    ctx.release()
    return rec


def reference_side(ctx, reference) -> dict:
    """``reference(cfg, tp, seed, device, steps, precision)``: the
    reference's checked steps -> {losses, grads, changes}."""
    t = time.perf_counter()
    ref = reference(ctx.cfg, ctx.traffic, ctx.seed, ctx.device,
                    ctx.traffic["checked_steps"],
                    stated_precision(ctx.cfg))
    ctx.log(f"reference: {time.perf_counter() - t:.1f} s, peak "
            f"{ctx.peak_bytes() / 1e9:.1f} GB")
    return ref


def compare(prog: dict, ref: dict) -> list:
    return [
        ("loss_gap", check.loss_gap(prog["losses"], ref["losses"])),
        ("grad_gap", check.leaf_gap(prog["grads"], ref["grads"])),
        ("change_gap", check.leaf_gap(prog["changes"], ref["changes"],
                                      keep=check.moving(ref["grads"]))),
    ]


def follow(leaves: list, opt, steps: int, loss_of) -> dict:
    """The reference's checked steps: ``loss_of(step)`` -> the loss with a
    graph over ``leaves`` ((name, tensor) pairs, tensors requiring
    gradients); ``opt`` the reference AdamW over them."""
    start = [t.detach().clone() for _, t in leaves]
    params = [t for _, t in leaves]
    losses, grads0 = [], None
    for step in range(1, steps + 1):
        loss = loss_of(step)
        grads = torch.autograd.grad(loss, params)
        clipped = opt.step(list(grads))
        losses.append(float(loss.detach()))
        if grads0 is None:
            grads0 = {k: float(torch.linalg.vector_norm(g))
                      for (k, _), g in zip(leaves, clipped)}
        del grads, clipped, loss
    changes = {k: float(torch.linalg.vector_norm(t.detach() - s))
               for (k, t), s in zip(leaves, start)}
    return {"losses": losses, "grads": grads0, "changes": changes}
