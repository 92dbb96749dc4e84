"""The decode kernels #7 and #8 at ``chip_smoke.py``'s shapes: #7 over the
packed int4 cache of path A ([8, 32, 768, 128] packed, 1536 positions) at
its four watermarks (s_used 768, 1024, 1280, 1536), #8 over the int8
cache ([8, 32, 768, 128]) at G 2, 5 and 8, s_used 768.  Each is checked
against its plain version (out, m, l within 1e-4 of each one's largest
entry) and timed as the smoke times it (CUDA-event medians, the L2
flushed before each launch), beside its bound.  Prints the card and one
JSON line ``{"card": ..., "ms": {case: ms}, "cases": [...]}``.

    python -m opadpo_torch.tools.time_decode [--ctas N]

``--ctas`` sets ``decode_split``'s target of CTAs a launch (this
checkout's cluster kernels only).  The
file measures the checkout it runs in (its ``chip_smoke.py`` and
``opadpo_torch``), so two commits compare in one call by running this file
from each checkout's root, with that root on ``PYTHONPATH``, in turns
(``python path/to/time_decode.py`` runs the same shapes against an older
checkout too).  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys

B, H, HD = 8, 32, 128
INT4_S_USED = (768, 1024, 1280, 1536)
MULTI_G = (2, 5, 8)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--ctas", type=int)
    args = ap.parse_args()
    sys.path.insert(0, ".")
    import chip_smoke
    from opadpo_torch.ops import decode_attention as da

    if args.ctas:
        da.TARGET_CTAS = args.ctas
    if not torch.cuda.is_available():
        print("time_decode needs a GPU", file=sys.stderr)
        return 1
    _, card = chip_smoke.phase_device()
    chip_smoke.phase_build()
    g = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    sm = HD ** -0.5

    def cache(sp, rows, filled, lo):
        ks, vs = (torch.rand(B, H, sp, generator=g, device="cuda") * 0.02
                  for _ in range(2))
        bias = torch.zeros(B, sp, device="cuda")
        for i in range(B):
            bias[i, :13 * i] = chip_smoke.NEG_INF
        bias[:, filled:] = chip_smoke.NEG_INF
        ks[:, :, filled:] = 0.0
        vs[:, :, filled:] = 0.0
        pk, pv = (torch.randint(lo, 128, (B, H, rows, HD), generator=g,
                                device="cuda", dtype=torch.int8)
                  for _ in range(2))
        return pk, ks, pv, vs, bias

    def case(name, kernel, plain, q, kv, su, gq, packed):
        fargs = (q, *kv, sm, su)
        out, ref = kernel(*fargs), plain(*fargs)
        err = [(o - r).abs().max().item() / max(r.abs().max().item(), 1.0)
               for o, r in zip(out, ref)]
        if max(err) > 1e-4:
            raise SystemExit(f"{name} s_used {su}: error {err} > 1e-4")
        nbytes = chip_smoke._decode_bytes(B, H, su, HD, gq, packed)
        bound, by = chip_smoke._bound(nbytes, 4 * B * H * gq * su * HD)
        res = {"case": name, "s_used": su, "G": gq,
               "ms": chip_smoke.time_ms(lambda: kernel(*fargs), flush),
               "bound_ms": bound, "bound_by": by, "rel_err": max(err)}
        print(json.dumps(res), flush=True)
        return res

    q = torch.randn(B, H, 8, HD, generator=g, device="cuda").to(
        torch.bfloat16)
    q1 = q[:, :, 0].contiguous()
    kv4 = cache(1536, 768, 1500, -128)
    cases = [case(f"int4 s_used {su}", da.decode_attention4_cuda,
                  da.decode_attention_prompt4_plain, q1, kv4, su, 1, True)
             for su in INT4_S_USED]
    del kv4
    kv8 = cache(768, 768, 703, -127)
    cases += [case(f"multi G {gq}", da.decode_attention_multi_cuda,
                   da.decode_attention_prompt_multi_plain,
                   q[:, :, :gq].contiguous(), kv8, 768, gq, False)
              for gq in MULTI_G]
    print(json.dumps({"card": card, "ctas": args.ctas,
                      "ms": {c["case"]: c["ms"] for c in cases},
                      "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
