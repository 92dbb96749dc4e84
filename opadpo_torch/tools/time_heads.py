"""The gather kernel (#5) at ``chip_smoke.py``'s two training shapes: a
stream's dQ, dK and dV at 32 heads of 128, in the layouts the training
path hands them over (``heads_grads``; the prefix [2, 703] with dK and dV
contiguous head-major, the response [6, 896] with dK and dV slices of a
[6, 1599, 32, 128] gradient at 703), in one launch where the checkout has
the three-tensor form (``gather_heads_multi_cuda``, also over dQ and dK
alone: what dV, a plain copy at group 1, adds to the launch) and as three
single launches (``gather_heads_cuda``).  Each is checked against the
plain version (1e-2 of the largest entry) and timed as the smoke times it
(CUDA-event medians, the L2 flushed before each launch), beside the
bound.  Prints the card and one JSON line ``{"card": ..., "cases":
{shape: {...}}}``.

    python -m opadpo_torch.tools.time_heads

The file measures the checkout it runs in (its ``chip_smoke.py`` and
``opadpo_torch``), so two commits compare in one call by running this
file from each checkout's root, with that root on ``PYTHONPATH``, in turns
(``python path/to/time_heads.py`` runs the same tensors on an older
checkout's kernels: it calls only ``chip_smoke.phase_device``,
``phase_build``, ``time_ms`` and ``_bound`` and the wrappers).  Needs a
GPU.
"""

from __future__ import annotations

import json
import sys

H, HD = 32, 128
# (batch rows, stream length, length of the [prefix ++ response] gradient
# the stream's dK and dV are slices of, or None)
SHAPES = {"prefix": (2, 703, None), "response": (6, 896, 1599)}
ROPES = (True, True, False)             # dQ and dK rotated back, dV not


def heads_grads(b, s, h, hd, g, kv_len=None):
    """dQ, dK and dV of one stream as the training path hands them to the
    gather, bf16 on the card, each logically [b, h, s, hd]: dQ the permuted
    view of the flash backward's [b, s, h, hd]; dK and dV, with ``kv_len``,
    the slice at kv_len - s along S of that view of a [b, kv_len, h, hd]
    gradient (the response stream's part of [prefix ++ response]), else
    contiguous [b, h, s, hd] (as autograd's sum for the prefix stream may
    leave them)."""
    import torch

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda",
                           dtype=torch.bfloat16)

    dq = randn(b, s, h, hd).permute(0, 2, 1, 3)
    if kv_len is None:
        return [dq, randn(b, h, s, hd), randn(b, h, s, hd)]
    return [dq] + [randn(b, kv_len, h, hd).permute(0, 2, 1, 3)[
        :, :, kv_len - s:] for _ in range(2)]


def main() -> int:
    import torch

    sys.path.insert(0, ".")
    import chip_smoke
    from opadpo_torch.ops import heads_layout as hl
    from opadpo_torch.ops.rope import rope_frequencies

    if not torch.cuda.is_available():
        print("time_heads needs a GPU", file=sys.stderr)
        return 1
    _, card = chip_smoke.phase_device()
    chip_smoke.phase_build()
    g = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    cos, sin = rope_frequencies(HD, 4096, device="cuda")
    multi = getattr(hl, "gather_heads_multi_cuda", None)

    def case(b, s, kv_len):
        mask = (torch.arange(s, device="cuda")[None]
                >= (torch.arange(b, device="cuda") * 21)[:, None]).long()
        pos = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
        grads = heads_grads(b, s, H, HD, g, kv_len)
        refs = [hl.gather_heads_plain(t, cos, sin, pos, r)
                for t, r in zip(grads, ROPES)]
        fns = {"three_single": lambda: [
            hl.gather_heads_cuda(t, cos, sin, pos, r)
            for t, r in zip(grads, ROPES)]}
        if multi is not None:
            fns["one_launch"] = lambda: multi(grads, cos, sin, pos, ROPES,
                                              (1, 1, 1))
            # dQ and dK alone: the launch less dV's share
            fns["dq_dk_launch"] = lambda: multi(grads[:2], cos, sin, pos,
                                                ROPES[:2], (1, 1))
        nbytes = 3 * 2 * b * s * H * HD * 2 + b * s * 8 \
            + 2 * b * s * (HD // 2) * 4
        bound, by = chip_smoke._bound(nbytes, 2 * 6 * b * s * H * HD)
        res = {"shape": [b, s, H * HD], "kv_len": kv_len, "bound_ms": bound,
               "bound_by": by}
        for name, fn in fns.items():
            outs = fn()
            torch.cuda.synchronize()
            err = max((o.float() - r.float()).abs().max().item()
                      for o, r in zip(outs, refs))
            top = max(r.float().abs().max().item() for r in refs)
            if err > 1e-2 * top:
                raise SystemExit(f"{name} [{b}, {s}]: error {err} > 1e-2 x "
                                 f"{top}")
            res[f"{name}_err"] = err
            res[f"{name}_ms"] = chip_smoke.time_ms(fn, flush)
        print(json.dumps(res), flush=True)
        return res

    cases = {name: case(*shape) for name, shape in SHAPES.items()}
    print(json.dumps({"card": card, "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
