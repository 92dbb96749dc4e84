"""The lm_head's products in ``chunked_logprobs`` at the DPO cells' shapes,
the f32 route (both operands upcast, FFMA GEMMs) against the tensor-core
route (bf16 operands, f32 accumulation; the backward through the exact
three-part split): one 2,000-row chunk's forward product and its
backward's d hidden over 8,960 rows (10 x 896) of width 4,096, and the
whole 102,400-row head through ``chunked_logprobs`` with the entropy,
forward and backward.  Each is checked against the f32 route (1e-5 of the
largest entry; 1e-2 for the head's d hidden, which is bf16) and timed as
the smoke times it (CUDA-event medians of 20, the L2 flushed before each
run), with the useful TFLOP/s of the tensor-core route.  Prints the card
and one JSON line ``{"card": ..., "cases": {case: {...}}}``.

    python -m opadpo_torch.tools.time_head

Needs a GPU.
"""

from __future__ import annotations

import json
import sys

ROWS, SEQ, WIDTH, CHUNK, VOCAB = 10, 896, 4096, 2000, 102400


def main() -> int:
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, ".")
    import chip_smoke
    from opadpo_torch.ops import logprobs

    if not torch.cuda.is_available():
        print("time_head needs a GPU", file=sys.stderr)
        return 1
    _, card = chip_smoke.phase_device()
    g = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    m = ROWS * SEQ
    hidden = torch.randn(ROWS, SEQ, WIDTH, generator=g, device="cuda").to(
        torch.bfloat16)
    head = (torch.randn(VOCAB, WIDTH, generator=g, device="cuda")
            * 0.02).to(torch.bfloat16)
    labels = torch.randint(0, VOCAB, (ROWS, SEQ), generator=g, device="cuda")
    h16, w_c = hidden.view(m, WIDTH), head[:CHUNK]
    h32 = h16.float()
    d = torch.randn(m, CHUNK, generator=g, device="cuda") * 1e-4
    flops = 2 * m * WIDTH * CHUNK

    def f32_route(fn):
        """``fn`` with ``chunked_logprobs`` held to the f32 products."""
        def run():
            route = logprobs._tensor_core_route
            logprobs._tensor_core_route = lambda *a: False
            try:
                return fn()
            finally:
                logprobs._tensor_core_route = route
        return run

    def head_pass():
        x = hidden.detach().requires_grad_()
        lp, ent = logprobs.chunked_logprobs(x, head, labels, -100,
                                            with_entropy=True)
        (dx,) = torch.autograd.grad(lp.sum() + ent.sum(), x)
        return torch.stack([lp, ent]), dx

    # (f32 route, tensor-core route, useful operations, tolerances); the
    # head's pass multiplies three times: forward, recompute, backward
    cases = {
        "chunk_fwd": (lambda: (F.linear(h32, w_c.float()),),
                      lambda: (logprobs._mm_f32(h16, w_c.t()),), flops,
                      (1e-5,)),
        "chunk_bwd": (lambda: (d @ w_c.float(),),
                      lambda: (logprobs.dh_f32(d, w_c),), flops, (1e-5,)),
        "head_fwd_bwd": (f32_route(head_pass), head_pass,
                         3 * flops * VOCAB // CHUNK, (1e-5, 1e-2)),
    }
    res = {}
    for name, (old, new, ops, tols) in cases.items():
        ref, got = old(), new()
        torch.cuda.synchronize()
        errs = [((a.float() - b.float()).abs().max() / b.float().abs().max()
                 ).item() for a, b in zip(got, ref)]
        if any(e > t for e, t in zip(errs, tols)):
            raise SystemExit(f"{name}: relative errors {errs} > {tols}")
        del ref, got
        old_ms, new_ms = chip_smoke.time_ms(old, flush), chip_smoke.time_ms(
            new, flush)
        res[name] = {"rel_err": errs, "f32_ms": old_ms, "tc_ms": new_ms,
                     "speedup": old_ms / new_ms,
                     "tc_tflops": ops / new_ms / 1e9}
        print(json.dumps({name: res[name]}), flush=True)
    print(json.dumps({"card": card, "cases": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
