"""Per-token logprob and entropy math: port of ``opadpo_tpu/ops/logprobs.py``.

- per-token logprobs are ``-cross_entropy(logits, labels, ignore_index)``:
  0 at positions whose label is the ignore index;
- entropies are ``-(softmax * log_softmax).sum(-1)`` in nats.

``chunked_logprobs`` reads both out of the lm_head product without ever
holding ``[N, S, V]`` f32 logits: it walks the vocabulary in chunks, each
chunk's body under ``torch.utils.checkpoint`` so that only four ``[N, S]``
statistics per chunk are kept for the backward and the chunk's logits are
recomputed there (the span ``remat.head``), and merges the chunks by
their log-sum-exp.  Over a vocabulary split across a model group (``tp``)
each rank walks its own slice; the running max is ``all_reduce``d (MAX)
and the sums of exponentials, the entropy's sums and the target's logit
(non-zero only on the rank that owns the label) are added by one
``all_reduce``.

A chunk's product takes one of two routes, chosen by what the operands are
(``_tensor_core_route``):

- a bf16 head and bf16 hidden states on CUDA with no head adapter (the
  training configurations): bf16 tensor-core GEMMs with f32 accumulation
  and f32 output, as the JAX package's ``preferred_element_type=f32``
  product.  A product of two bf16 values is exact in f32, so the forward is
  the f32 product of the same values up to the order of its sums.  The
  backward's f32 cotangent is split exactly into three bf16 parts
  (``split_bf16x3``) and dh is the f32 sum of their three exact products,
  so it carries the f32 product's precision;
- anything else (CPU tensors, an f32 or f16 head, a head adapter, whose
  ``b`` is f32): both operands upcast and multiplied in f32.

Either way each chunk's dh reaches the f32 copy of the hidden states, so
the chunks' gradients add up in f32 and are cast to the hidden dtype once.
``head_products`` counts the chunk products of each route, forward (its
recompute included) and backward, one a chunk each, as do the trace
counters ``head.tc_products`` and ``head.f32_products``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from opadpo_torch.device import on_cuda
from opadpo_torch.ops.quant import LaunchCount
from opadpo_torch.parallel import comm
from opadpo_torch.utils import trace

# chunk products by route (``chip_smoke.py`` and the tests reset and read
# ``launches``)
head_products = {"tc": LaunchCount(), "f32": LaunchCount()}


def per_token_logprobs(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int) -> torch.Tensor:
    """log p(labels | logits) per position, 0 where label == ignore_index.
    logits [..., S, V] (computed in f32), labels [..., S]."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ignored = labels == ignore_index
    safe = torch.where(ignored, torch.zeros_like(labels), labels)
    picked = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    return torch.where(ignored, torch.zeros_like(picked), picked - logz)


def per_token_entropy(logits: torch.Tensor) -> torch.Tensor:
    """Entropy of softmax(logits) per position, in nats: [..., S, V] ->
    [..., S]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(logp.exp() * logp).sum(dim=-1)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None):
    """Mean of x over mask (the reference's ``masked_mean``)."""
    mask = mask.to(x.dtype)
    if dim is None:
        return (x * mask).sum() / torch.clamp(mask.sum(), min=1e-9)
    return (x * mask).sum(dim) / torch.clamp(mask.sum(dim), min=1e-9)


def _count(route: str) -> None:
    head_products[route].launches += 1
    trace.count(f"head.{route}_products")


def _tensor_core_route(hidden: torch.Tensor, lm_head: torch.Tensor,
                       head_lora: Optional[dict]) -> bool:
    """Whether the head's chunk products run on tensor cores: bf16 hidden
    states and head on CUDA, no head adapter.  An f16 head keeps the f32
    products: an f32 cotangent does not split exactly into f16 parts,
    whose exponents span only 2^-24 ... 2^15."""
    return (head_lora is None and lm_head.dtype == torch.bfloat16
            and hidden.dtype == torch.bfloat16 and on_cuda(lm_head))


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 operands on tensor cores, accumulated and returned
    in f32 (``aten::mm.dtype``; its output being f32, so are any split-K
    partial sums)."""
    return torch.mm(a, b, out_dtype=torch.float32)


def split_bf16x3(d: torch.Tensor):
    """``d`` (f32) as three bf16 tensors ``(d1, d2, d3)`` with ``d1 + d2 +
    d3 == d`` exactly, ``d1`` the largest: ``d1 = bf16(d)``, ``d2 = bf16(d -
    d1)``, ``d3 = d - d1 - d2``.  Each difference is exact in f32 (the error
    of a round to nearest), and the last part needs at most 8 significant
    bits, since 24 = 3 x 8, so it is exact in bf16.  Summed in f32 from the
    smallest part up, the parts give ``d`` back bit for bit.  The one
    inexactness, in use: a part below bf16's smallest normal (about
    1.2e-38) may be flushed to zero by the tensor cores."""
    d1 = d.to(torch.bfloat16)
    r = d - d1                  # in f32: the bf16 operand widens exactly
    d2 = r.to(torch.bfloat16)
    return d1, d2, torch.sub(r, d2, out=torch.empty_like(d2))


def dh_f32(d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``d @ w`` for an f32 ``d`` [M, V] and a bf16 ``w`` [V, D], in f32
    on tensor cores: the sum of the three exact products of
    ``split_bf16x3(d)``, the smallest part's first."""
    d1, d2, d3 = split_bf16x3(d)
    dh = _mm_f32(d3, w)
    dh += _mm_f32(d2, w)
    dh += _mm_f32(d1, w)
    return dh


class _HeadProduct(torch.autograd.Function):
    """One chunk's logits ``h @ w^T`` in f32 on tensor cores.  ``h32`` (the
    f32 hidden states) takes the f32 dh; ``h16`` (the same values in bf16,
    detached) feeds the forward's product; ``w`` is the chunk's rows of the
    frozen bf16 head."""

    @staticmethod
    def forward(ctx, h32, h16, w):
        if ctx.needs_input_grad[2]:
            raise ValueError("the tensor-core head product takes a frozen "
                             "lm_head (no dW); this one requires grad")
        ctx.save_for_backward(w)
        _count("tc")
        logits = _mm_f32(h16.reshape(-1, h16.shape[-1]), w.t())
        return logits.view(*h16.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, d):
        (w,) = ctx.saved_tensors
        _count("tc")
        dh = dh_f32(d.reshape(-1, d.shape[-1]), w)
        return dh.view(*d.shape[:-1], w.shape[1]), None, None


def _f32_product(h32, w_c):
    _count("f32")
    logits = F.linear(h32, w_c.float())
    if logits.requires_grad:
        logits.register_hook(lambda _: _count("f32"))
    return logits


def _chunk_stats(h32, h16, w_c, ha32, b_c, labels, start: int, inv_t: float,
                 lora_scaling: float, with_entropy: bool):
    """One vocabulary chunk: (max, sum exp(l - max), sum exp(l - max) * l,
    the label's logit where the label falls in the chunk, else 0), each
    [N, S] f32.  ``h16``: the hidden states in bf16 on the tensor-core
    route, else None."""
    if h16 is not None:
        logits = _HeadProduct.apply(h32, h16, w_c)
    else:
        logits = _f32_product(h32, w_c)
    if ha32 is not None:
        logits = logits + F.linear(ha32, b_c.float()) * lora_scaling
    logits = logits * inv_t
    local = labels - start
    in_range = (local >= 0) & (local < logits.shape[-1])
    idx = torch.clamp(local, 0, logits.shape[-1] - 1)
    picked = torch.gather(logits, -1, idx[..., None])[..., 0]
    picked = torch.where(in_range, picked, torch.zeros_like(picked))
    m = logits.amax(dim=-1)
    e = torch.exp(logits - m[..., None])
    s = e.sum(dim=-1)
    t = (e * logits).sum(dim=-1) if with_entropy else torch.zeros_like(s)
    return m, s, t, picked


def chunked_logprobs(hidden: torch.Tensor, lm_head: torch.Tensor,
                     labels: torch.Tensor, ignore_index: int,
                     temperature: float = 1.0, with_entropy: bool = False,
                     head_lora: Optional[dict] = None,
                     lora_scaling: float = 1.0, chunk_size: int = 2000,
                     tp=None):
    """Per-token ``log p(label)`` (and optionally the entropy, in nats) of
    ``softmax(hidden @ lm_head^T / temperature)``, computed in f32 from the
    model-dtype hidden states and weights (on CUDA with a bf16 head, by
    tensor-core products with f32 accumulation: the module docstring).

    hidden [N, S, D]; lm_head [V, D] (``Linear`` layout); labels [N, S];
    head_lora ``{"a": [r, D], "b": [V, r]}`` or None.  Returns ``(logprobs
    [N, S], entropy [N, S] or None)``; the logprob is 0 where ``label ==
    ignore_index``.  Gradients reach ``hidden`` and the head adapter.

    ``tp``: the model group over which ``lm_head`` [V / n, D] and the
    adapter's ``b`` [V / n, r] are split (rank i holds rows [i V / n,
    (i + 1) V / n)); ``hidden`` and ``a`` enter the model region, so their
    gradients come out whole on every rank."""
    v = lm_head.shape[0]
    vc = min(chunk_size, v)
    v0 = 0
    a = None if head_lora is None else head_lora["a"]
    if tp is not None:
        v0 = tp.rank * v
        hidden = comm.copy_to_model(hidden, tp)
        if a is not None:
            a = comm.copy_to_model(a, tp)
    h32 = hidden.float()
    h16 = hidden.detach() if _tensor_core_route(hidden, lm_head, head_lora) \
        else None
    ha32 = None
    if head_lora is not None:
        ha32 = F.linear(h32, a.float()).to(head_lora["b"].dtype).float()
    labels = labels.long()
    stats = []
    for start in range(0, v, vc):
        b_c = head_lora["b"][start:start + vc] if head_lora is not None \
            else None
        body = trace.rerun_span(_chunk_stats, "remat.head")
        stats.append(checkpoint(
            body, h32, h16, lm_head[start:start + vc], ha32, b_c, labels,
            v0 + start, 1.0 / temperature, lora_scaling, with_entropy,
            use_reentrant=False))
    m_c, s_c, t_c, p_c = (torch.stack(x) for x in zip(*stats))
    m = m_c.amax(dim=0)
    if tp is not None:
        # the shift of the log-sum-exp: any value gives the same sums and
        # gradients, so the maximum over the group is taken detached
        m = comm.all_reduce_(m.detach().clone(), tp,
                             torch.distributed.ReduceOp.MAX)
    w = torch.exp(m_c - m)
    acc_s = (s_c * w).sum(dim=0)
    picked = p_c.sum(dim=0)
    acc_t = (t_c * w).sum(dim=0) if with_entropy else None
    if tp is not None:
        sums = [acc_s, picked] + ([acc_t] if with_entropy else [])
        sums = comm.reduce_from_model(torch.stack(sums), tp).unbind(0)
        acc_s, picked = sums[0], sums[1]
        acc_t = sums[2] if with_entropy else None
    logz = m + torch.log(acc_s)
    lp = torch.where(labels == ignore_index, torch.zeros_like(picked),
                     picked - logz)
    entropy = None
    if with_entropy:
        entropy = logz - acc_t / acc_s
    return lp, entropy
