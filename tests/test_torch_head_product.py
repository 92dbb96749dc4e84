"""The head's tensor-core route in ``opadpo_torch/ops/logprobs.py``, on the
CPU: the exact three-part bf16 split of an f32 cotangent; the route's
forward and backward, with its tensor-core product replaced by the f32
product of the same bf16 values (exact products, so the faithful stand-in),
against the f32 route; and which route each kind of operand takes, with
the counters that say so."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from opadpo_torch.ops import logprobs as t_logprobs
from opadpo_torch.utils import trace
from tests.test_torch_gpu import f32_grad_of

torch.set_num_threads(2)


def _exact_f32_mm(a, b):
    """The tensor-core product's stand-in: bf16 x bf16 products are exact
    in f32, so only the order of the f32 sums may differ."""
    assert a.dtype == b.dtype == torch.bfloat16
    return a.float() @ b.float()


def _reset():
    for c in t_logprobs.head_products.values():
        c.launches = 0


def _counts():
    return {k: c.launches for k, c in t_logprobs.head_products.items()}


def _inputs(n=3, s=7, d=48, v=500, seed=0, head_dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    hidden = torch.randn(n, s, d, generator=g).to(torch.bfloat16)
    head = (torch.randn(v, d, generator=g) * 0.3).to(head_dtype)
    labels = torch.randint(1, v, (n, s), generator=g)
    labels[:, -1] = -100
    return hidden.requires_grad_(), head, labels


def _run(hidden, head, labels, with_entropy, chunk, head_lora=None):
    """Values, the f32 d hidden and the bf16 d hidden of a weighted sum of
    the outputs."""
    lp, ent = t_logprobs.chunked_logprobs(
        hidden, head, labels, -100, temperature=0.7,
        with_entropy=with_entropy, head_lora=head_lora, chunk_size=chunk)
    outs = [lp] + ([ent] if with_entropy else [])
    got = f32_grad_of(outs, hidden)
    g = torch.Generator().manual_seed(1)
    loss = sum((o * torch.randn(o.shape, generator=g)).sum() for o in outs)
    (dh,) = torch.autograd.grad(loss, hidden)
    return [o.detach() for o in outs], got[0], dh


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_split_bf16x3_is_exact(sign):
    """f32 values with every significand pattern drawn at random, across
    exponents 2^-100 ... 2^100 (and powers of two, values already bf16,
    +0): the three parts add back to the value bit for bit, smallest
    first, the residue after two parts is the third part's value exactly
    (so it survives the bf16 round trip), and the parts shrink by at least
    2^8 each."""
    g = torch.Generator().manual_seed(3)
    exps = torch.arange(-100, 101, dtype=torch.float32)
    mant = 1.0 + torch.rand(201, 64, generator=g)
    d = torch.cat([sign * (mant * torch.exp2(exps)[:, None]).flatten(),
                   sign * torch.exp2(exps),
                   sign * torch.exp2(exps).to(torch.bfloat16).float() * 1.5,
                   torch.zeros(3)])
    d1, d2, d3 = t_logprobs.split_bf16x3(d)
    assert d1.dtype == d2.dtype == d3.dtype == torch.bfloat16
    back = (d3.float() + d2.float()) + d1.float()
    assert torch.equal(back.view(torch.int32), d.view(torch.int32))
    assert torch.equal(d - d1.float() - d2.float(), d3.float())
    for p in (d1, d2, d3):
        assert torch.equal(p.float().to(torch.bfloat16), p)
    big = d.abs() > 0
    assert (d2.float().abs()[big] <= d.abs()[big] * 2.0 ** -8).all()
    assert (d3.float().abs()[big] <= d.abs()[big] * 2.0 ** -16).all()


@pytest.mark.parametrize("with_entropy", [False, True])
@pytest.mark.parametrize("v, chunk", [(500, 64), (512, 128)])
def test_route_matches_the_f32_products(monkeypatch, with_entropy, v,
                                        chunk):
    """The tensor-core route (its product the exact stand-in) against the
    f32 route on the same bf16 hidden states and head: logprobs, entropies
    and the f32 d hidden within 1e-6 of their largest entry, for a
    vocabulary that the chunk divides and one it does not; the bf16 d
    hidden it yields is that f32 sum rounded once."""
    hidden, head, labels = _inputs(v=v)
    ref_vals, ref_dh32, _ = _run(hidden, head, labels, with_entropy, chunk)
    monkeypatch.setattr(t_logprobs, "on_cuda", lambda t: True)
    monkeypatch.setattr(t_logprobs, "_mm_f32", _exact_f32_mm)
    _reset()
    vals, dh32, dh = _run(hidden, head, labels, with_entropy, chunk)
    chunks = -(-v // chunk)
    assert _counts() == {"tc": 3 * chunks, "f32": 0}
    for a, b in zip(vals, ref_vals):
        assert (a - b).abs().max() <= 1e-6 * b.abs().max()
    assert (dh32 - ref_dh32).abs().max() <= 1e-6 * ref_dh32.abs().max()
    assert torch.equal(dh, dh32.to(torch.bfloat16))
    assert (vals[0][:, -1] == 0).all()


def test_dispatch_and_counters(monkeypatch):
    """CPU tensors take the f32 route, forward, recompute and backward
    counted a chunk each (and under a profiler as ``head.f32_products``);
    on CUDA only bf16 hidden states and a bf16 head with no head adapter
    take the tensor cores: an f32 or f16 head, f32 hidden states or a head
    adapter keep the f32 products."""
    hidden, head, labels = _inputs(v=300)
    _reset()
    with profile(activities=[ProfilerActivity.CPU]):
        trace.clear()
        _run(hidden, head, labels, True, 128)
        counters = trace.snapshot(clear=True)["counters"]
    assert _counts() == {"tc": 0, "f32": 9}
    assert counters == {"head.f32_products": 9}
    with torch.no_grad():
        t_logprobs.chunked_logprobs(hidden, head, labels, -100,
                                    chunk_size=128)
    assert _counts() == {"tc": 0, "f32": 12}

    route = t_logprobs._tensor_core_route
    lora = {"a": torch.zeros(2, 48), "b": torch.zeros(300, 2)}
    assert not route(hidden, head, None)
    monkeypatch.setattr(t_logprobs, "on_cuda", lambda t: True)
    assert route(hidden, head, None)
    assert not route(hidden, head, lora)
    assert not route(hidden, head.float(), None)
    assert not route(hidden, head.half(), None)
    assert not route(hidden.float(), head, None)

    monkeypatch.setattr(t_logprobs, "_mm_f32", _exact_f32_mm)
    _reset()
    _run(hidden, head.float(), labels, False, 128)
    _run(hidden, head, labels, False, 128, head_lora=lora)
    assert _counts() == {"tc": 0, "f32": 18}
    _run(hidden, head, labels, False, 128)
    assert _counts() == {"tc": 9, "f32": 18}


def test_route_refuses_a_trainable_head(monkeypatch):
    """The route computes no dW: a head that requires grad raises."""
    hidden, head, labels = _inputs(v=100)
    monkeypatch.setattr(t_logprobs, "on_cuda", lambda t: True)
    monkeypatch.setattr(t_logprobs, "_mm_f32", _exact_f32_mm)
    with pytest.raises(ValueError, match="frozen lm_head"):
        t_logprobs.chunked_logprobs(hidden, head.requires_grad_(), labels,
                                    -100, chunk_size=64)
