"""The CUDA kernels against their plain versions, on a GPU only.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with the GPU and no JAX (without the repository's conftest, which
imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Without a GPU each test skips.
"""

import pytest
import torch

from opadpo_torch.ops import attention as t_attention
from opadpo_torch.ops import decode_attention as t_decode


@pytest.mark.gpu
def test_kernels_match_plain_on_gpu():
    """On the card: the flash forward kernel and the int8 decode kernel
    against their plain versions, bf16, at small shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    for causal, d, s in ((True, 128, 203), (False, 64, 77), (True, 32, 33)):
        q, k, v = (torch.randn(2, s, 4, d, generator=g, device=dev,
                               dtype=torch.bfloat16) for _ in range(3))
        mask = torch.ones(2, s, dtype=torch.int32, device=dev)
        mask[1, :50] = 0
        o, lse = t_attention.flash_fwd_cuda(q, k, v, mask, causal)
        o_ref, lse_ref = t_attention.mha_reference_lse(q, k, v, mask, causal)
        assert (o.float() - o_ref.float()).abs().max().item() < 2e-2
        assert (lse - lse_ref).abs().max().item() < 1e-3
    b, h, sp, hd = 2, 4, 256, 128
    qd = torch.randn(b, h, hd, generator=g, device=dev).to(torch.bfloat16)
    pk, pv = (torch.randint(-127, 128, (b, h, sp, hd), generator=g,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(b, h, sp, generator=g, device=dev) * 0.02
              for _ in range(2))
    bias = torch.zeros(b, sp, device=dev)
    bias[1, :30] = -1e30
    for su in (256, 128):
        out = t_decode.decode_attention_cuda(qd, pk, ks, pv, vs, bias,
                                             hd ** -0.5, s_used=su)
        ref = t_decode.decode_attention_prompt_plain(qd, pk, ks, pv, vs,
                                                     bias, hd ** -0.5, su)
        for o, r in zip(out, ref):
            assert torch.allclose(o, r, rtol=1e-4,
                                  atol=1e-4 * r.abs().max().item())
