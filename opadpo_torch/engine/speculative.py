"""Speculative decoding (drafts, then one batched verify forward): port of
``opadpo_tpu/engine/speculative.py``.

Single-token decode is bound by reading the weights and the prompt cache,
so verifying k draft tokens in ONE forward (``llama.decode_forward_multi``
and the multi-query prompt kernel, #8) costs about one decode step while
emitting up to k + 1 tokens.

- Acceptance (sampled): draft ``d`` under the warped target distribution
  ``p`` (temperature, top-k, top-p, as ``sample_tokens`` warps) is kept
  with probability ``p(d)``; on rejection the replacement is drawn from
  ``p`` with ``d`` zeroed and renormalised, which leaves every emitted
  token exactly ``p``-distributed for a deterministic draft.  Greedy
  targets accept iff ``d == argmax`` and correct with the argmax, so
  speculative greedy equals plain greedy for any draft.
- ``advance="shared"``: every row advances by the batch's smallest
  accepted run + 1, so the suffix stays one contiguous batch-wide buffer.
- ``advance="per_row"``: every row keeps its own run; group KV lands in a
  raw buffer at a shared slot, and every ``compact_every`` groups each
  row's accepted rows move into a settled buffer by a per-row index
  scatter (``compact_suffix_pr``; the JAX package's one-hot einsum was a
  TPU workaround).

The loops run on the host, in Python: each group reads the accepted
counts (a synchronise), as the plain decode loop reads ``done`` each step.
Draws come from an explicit ``torch.Generator``.

Under tensor parallelism every rank of the model group runs the loop on
its own heads (suffix caches sized from the local ``model.llama.cfg``)
and takes model rank 0's first tokens and, after each verify group, its
verdicts and corrections (one int64 ``broadcast`` each time), so the host
decisions that follow (the advance, ``done``, the emitted tokens, the
raw-row targets) are equal on every rank and no collective is left
waiting.  Every rank still draws from its own generator with the same
calls in the same order, so the generators stay in step.

Drafts: "ngram" (2-gram lookup in the row's own output), "pad" (the worst
case) or "oracle" (``oracle_tokens[b, t:t + k]`` at generated-token offset
t: the controlled-acceptance A/B; wrong drafts cost acceptance only).

SEGMENT mode (``done_init``/``max_new``/``return_state``, per-row advance
only) serves the continuous engine (``engine/continuous.py``): it decodes up
to ``max_new`` tokens a row, then one flush forward (the carry token, pad
drafts) computes the last emitted token's KV and the next token's logits,
and a last compaction settles every pending raw row, so the state holds
one suffix row per emitted token, as ``decode_loop_unrolled`` leaves it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from opadpo_torch.engine.sampling import NEG_INF, SamplingConfig, \
    sample_tokens
from opadpo_torch.models import llama as llama_model
from opadpo_torch.models import llava as llava_model
from opadpo_torch.parallel import comm

DRAFTS = ("ngram", "pad", "oracle")
ADVANCES = ("shared", "per_row")


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    k: int = 4                    # drafts per group (verify width k + 1)
    draft: str = "ngram"          # "ngram" | "pad" | "oracle"
    advance: str = "shared"       # "shared" | "per_row"
    compact_every: int = 32       # per_row: groups between compactions


def warped_topk_dist(logits: torch.Tensor, cfg: SamplingConfig):
    """The exact distribution ``sample_tokens`` draws from, in top-k space:
    (probs [N, K], token ids [N, K]).  Needs ``cfg.top_k > 0``."""
    if not (cfg.top_k and cfg.top_k > 0):
        raise ValueError("speculative sampling needs top_k > 0 or greedy")
    logits = logits.float()
    if cfg.suppress_eos:
        logits = logits.clone()
        logits[:, cfg.eos_token_id] = NEG_INF
    logits = logits / max(cfg.temperature, 1e-6)
    vals, idx = torch.topk(logits, cfg.top_k, dim=-1)
    if cfg.top_p < 1.0:
        probs = torch.softmax(vals, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < cfg.top_p
        vals = torch.where(keep, vals, NEG_INF)
    return torch.softmax(vals, dim=-1), idx


def accept_probs(logits_g: torch.Tensor, drafts: torch.Tensor,
                 cfg: SamplingConfig):
    """For the k drafted positions of a group: (acceptance probabilities
    p(d) [B, k], the residual distributions (p with d zeroed, unnormalised)
    [B*k, K], their token ids [B*k, K])."""
    b, g, v = logits_g.shape
    k = g - 1
    probs, idx = warped_topk_dist(logits_g[:, :k].reshape(b * k, v), cfg)
    is_d = idx == drafts.reshape(b * k, 1)
    p_d = (probs * is_d).sum(dim=-1).reshape(b, k)
    return p_d, torch.where(is_d, 0.0, probs), idx


def _accept_and_correct(logits_g: torch.Tensor, drafts: torch.Tensor,
                        cfg: SamplingConfig,
                        generator: Optional[torch.Generator]):
    """One group's decisions.  logits_g [B, G, V] (G = k + 1), drafts
    [B, k] -> (accept [B, k] bool, each position's own verdict before the
    leading-run rule; corrections [B, k + 1], the token to emit at
    position j if the group stops there: the residual draw for j < k, a
    plain draw from the last distribution for j = k)."""
    b, g, _ = logits_g.shape
    k = g - 1
    if cfg.greedy:
        arg = torch.argmax(logits_g, dim=-1)
        return drafts == arg[:, :k], arg
    p_d, resid, idx = accept_probs(logits_g, drafts, cfg)
    u = torch.rand(b, k, generator=generator, device=logits_g.device)
    acc = u < p_d
    # rejection implies p(d) < 1, so the residual has mass elsewhere
    local = torch.multinomial(resid + 1e-30, 1, generator=generator)
    fix = torch.gather(idx, 1, local)[:, 0].reshape(b, k)
    bonus = sample_tokens(logits_g[:, k], cfg, generator)
    return acc, torch.cat([fix, bonus[:, None]], dim=1)


def _decisions_of_rank0(acc: torch.Tensor, corrections: torch.Tensor, tp):
    """Model rank 0's ``acc`` [B, k] and ``corrections`` [B, k + 1] on every
    rank of ``tp`` (one int64 broadcast; the tensors given without
    tensor parallelism)."""
    if tp is None:
        return acc, corrections
    k = acc.shape[1]
    buf = comm.broadcast_(torch.cat([acc.long(), corrections.long()], dim=1),
                          tp)
    return buf[:, :k].bool(), buf[:, k:]


def _ngram_drafts(out_buf: torch.Tensor, e, last_tok: torch.Tensor, k: int,
                  pad_id: int) -> torch.Tensor:
    """2-gram lookup: the k tokens that followed the latest earlier
    occurrence of each row's last two tokens, or pads where there is none.
    ``e`` is the number of tokens written per row (an int or [B])."""
    b, n = out_buf.shape
    e = torch.as_tensor(e, device=out_buf.device).expand(b)
    prev = torch.gather(out_buf, 1, (e - 2).clamp(min=0)[:, None])[:, 0]
    pos = torch.arange(n, device=out_buf.device)[None, :]
    nxt = torch.roll(out_buf, -1, dims=1)
    match = ((out_buf == prev[:, None]) & (nxt == last_tok[:, None])
             & (pos + 1 < (e - 1)[:, None]))
    score = torch.where(match, pos, -1)
    best, j = score.max(dim=1)
    cols = (j[:, None] + 2 + torch.arange(k, device=out_buf.device)).clamp(
        max=n - 1)
    cand = torch.gather(out_buf, 1, cols)
    return torch.where((best >= 0)[:, None], cand, pad_id)


def _drafts(spec: SpecConfig, out, e, last_tok, pad_id, oracle=None):
    if spec.draft == "ngram":
        return _ngram_drafts(out, e, last_tok, spec.k, pad_id)
    if spec.draft == "oracle":
        e = torch.as_tensor(e, device=out.device).expand(out.shape[0])
        cols = e[:, None] + torch.arange(spec.k, device=out.device)
        return torch.gather(oracle, 1, cols)
    return torch.full((out.shape[0], spec.k), pad_id, dtype=out.dtype,
                      device=out.device)


def compact_suffix_pr(raw_list: list, settled_list: list,
                      rawtgt: torch.Tensor) -> list:
    """Move each row's accepted raw rows into its settled buffer, in place:
    raw row c of batch row b goes to settled row ``rawtgt[b, c]`` where
    that is >= 0.  Targets are unique within a row, so the scatter is
    deterministic."""
    rows, cols = torch.nonzero(rawtgt >= 0, as_tuple=True)
    tgt = rawtgt[rows, cols]
    for (rk, rv), (ck, cv) in zip(raw_list, settled_list):
        ck[rows, tgt] = rk[rows, cols]
        cv[rows, tgt] = rv[rows, cols]
    return settled_list


def decode_loop_spec(model, prompt_kv_list: list, prompt_mask: torch.Tensor,
                     positions: torch.Tensor, last_logits: torch.Tensor,
                     generator: Optional[torch.Generator],
                     sampling: SamplingConfig, spec: SpecConfig, lora=None,
                     lora_scaling: float = 1.0, head=None,
                     sp_used: Optional[int] = None,
                     oracle_tokens: Optional[torch.Tensor] = None,
                     done_init: Optional[torch.Tensor] = None,
                     max_new: Optional[int] = None,
                     return_state: bool = False):
    """Speculative decode over a bf16 or int8 prompt cache -> (tokens
    [B, max_new], pad after each row's end; stats: ``groups`` (verify
    forwards, the flush not counted), ``accepted_drafts``, ``row_tokens``
    [B] (tokens written per row, the first one included), ``advances``
    [groups][B] (each group's advance per row)), and with ``return_state``
    also the state the continuous engine folds: {"suffix" (settled row t =
    generated token t's KV), "positions", "last_logits", "done",
    "emitted"}.

    ``oracle_tokens`` [B, >= max_new + k]: the "oracle" draft's source;
    ``done_init`` [B]: rows that emit pads only; ``max_new`` (default
    ``sampling.max_new_tokens``) tokens a row."""
    if spec.draft not in DRAFTS:
        raise ValueError(f"spec draft {spec.draft!r}: one of {DRAFTS}")
    if spec.advance not in ADVANCES:
        raise ValueError(f"spec advance {spec.advance!r}: one of "
                         f"{ADVANCES}")
    if spec.draft == "oracle" and oracle_tokens is None:
        raise ValueError("spec draft 'oracle' needs oracle_tokens")
    segment = (done_init is not None or max_new is not None
               or return_state)
    if segment and spec.advance != "per_row":
        raise ValueError("segment mode (done_init/max_new/return_state) "
                         "needs advance='per_row'")
    if spec.advance == "shared":
        return _loop_shared(model, prompt_kv_list, prompt_mask, positions,
                            last_logits, generator, sampling, spec, lora,
                            lora_scaling, head, sp_used, oracle_tokens)
    return _loop_per_row(model, prompt_kv_list, prompt_mask, positions,
                         last_logits, generator, sampling, spec, lora,
                         lora_scaling, head, sp_used, oracle_tokens,
                         done_init, max_new, return_state)


def _first_token(last_logits, generator, sampling, total, g, tp,
                 done_init=None):
    t1 = comm.broadcast_(sample_tokens(last_logits, sampling, generator), tp)
    done = t1 == sampling.eos_token_id
    if done_init is not None:
        t1 = torch.where(done_init, sampling.pad_token_id, t1)
        done = done | done_init
    out = torch.full((t1.shape[0], total + g), sampling.pad_token_id,
                     dtype=torch.int64, device=t1.device)
    out[:, 0] = t1
    return out, done


def _emit(drafts, corrections, lead, n, done, k, pad_id):
    """The tokens a group emits [B, k + 1]: the drafts, then the bonus;
    a row that stopped at position n - 1 takes the correction there."""
    jpos = torch.arange(k + 1, device=drafts.device)[None, :]
    cand = torch.cat([drafts, corrections[:, k:]], dim=1)
    corr_n = torch.gather(corrections, 1, (n - 1).clamp(0, k)[:, None])
    take_fix = (lead == n - 1)[:, None] & (jpos == (n - 1)[:, None]) \
        & (n > 0)[:, None]
    emit = torch.where(take_fix, corr_n, cand)
    return torch.where(done[:, None], pad_id, emit), jpos


def _loop_shared(model, kv, pm, positions, last_logits, generator, sampling,
                 spec, lora, lora_scaling, head, sp_used, oracle):
    cfg, tp = model.llama.cfg, model.llama.tp
    b, dev = pm.shape[0], pm.device
    k, g = spec.k, spec.k + 1
    total, eos, pad = (sampling.max_new_tokens, sampling.eos_token_id,
                       sampling.pad_token_id)
    # worst case: every group advances by 1 and writes g rows
    suffix = llama_model.init_suffix_cache(cfg, b, total + g, dev)
    out, done = _first_token(last_logits, generator, sampling, total, g, tp)
    e, advances = 1, []
    while e < total and not bool(done.all()):
        last_tok = out[:, e - 1]
        drafts = _drafts(spec, out, e, last_tok, pad, oracle)
        toks = torch.where(done[:, None], pad,
                           torch.cat([last_tok[:, None], drafts], dim=1))
        logits, suffix = llava_model.decode_step_multi(
            model, toks, kv, pm, suffix, e - 1, positions, lora=lora,
            lora_scaling=lora_scaling, sp_used=sp_used, head=head)
        acc, corrections = _decisions_of_rank0(*_accept_and_correct(
            logits, drafts, sampling, generator), tp)
        acc = acc | done[:, None]                 # done rows never throttle
        lead = torch.cumprod(acc.long(), dim=1).sum(dim=1)
        n = int(lead.min()) + 1
        emit, jpos = _emit(drafts, corrections, lead, torch.full_like(
            lead, n), done, k, pad)
        out[:, e:e + g] = emit
        done = done | ((emit == eos) & (jpos < n)).any(dim=1)
        e += n
        positions = positions + n
        advances.append([n] * b)
    out = torch.where(torch.arange(total + g, device=dev)[None, :] < e, out,
                      pad)[:, :total]
    return out, {"groups": len(advances),
                 "accepted_drafts": sum(a[0] - 1 for a in advances),
                 "row_tokens": [min(e, total)] * b, "advances": advances}


def _loop_per_row(model, kv, pm, positions, last_logits, generator,
                  sampling, spec, lora, lora_scaling, head, sp_used, oracle,
                  done_init, max_new, return_state):
    cfg, tp = model.llama.cfg, model.llama.tp
    b, dev = pm.shape[0], pm.device
    k, g = spec.k, spec.k + 1
    total = max_new or sampling.max_new_tokens
    eos, pad = sampling.eos_token_id, sampling.pad_token_id
    c_groups = spec.compact_every
    raw = llama_model.init_suffix_cache(cfg, b, c_groups * g, dev)
    # settled row t = generated token t's KV; the last token's KV is only
    # written by the segment's flush, at row <= total - 1
    settled = llama_model.init_suffix_cache(cfg, b, total, dev)
    rawtgt = torch.full((b, c_groups * g), -1, dtype=torch.int64, device=dev)
    w = torch.zeros(b, dtype=torch.int64, device=dev)
    out, done = _first_token(last_logits, generator, sampling, total, g, tp,
                             done_init)
    e = torch.ones(b, dtype=torch.int64, device=dev)
    advances = []
    while bool((~done & (e < total)).any()):
        gi = len(advances)
        slot = (gi % c_groups) * g
        last_tok = torch.gather(out, 1, (e - 1)[:, None])[:, 0]
        drafts = _drafts(spec, out, e, last_tok, pad, oracle)
        toks = torch.where(done[:, None], pad,
                           torch.cat([last_tok[:, None], drafts], dim=1))
        logits, raw = llava_model.decode_step_multi_pr(
            model, toks, kv, pm, raw, settled, slot, rawtgt >= 0, w,
            positions, lora=lora, lora_scaling=lora_scaling,
            sp_used=sp_used, head=head)
        acc, corrections = _decisions_of_rank0(*_accept_and_correct(
            logits, drafts, sampling, generator), tp)
        lead = torch.cumprod(acc.long(), dim=1).sum(dim=1)
        n = torch.where(done, 0, torch.minimum(lead + 1, total - e))
        emit, jpos = _emit(drafts, corrections, lead, n, done, k, pad)
        in_prefix = jpos < n[:, None]
        cols = e[:, None] + jpos                  # unique within a row
        out.scatter_(1, cols, torch.where(in_prefix, emit,
                                          torch.gather(out, 1, cols)))
        # raw rows j < n carry the KV of tokens e - 1 .. e + n - 2
        rawtgt[:, slot:slot + g] = torch.where(in_prefix, cols - 1, -1)
        done = done | ((emit == eos) & in_prefix).any(dim=1)
        e = e + n
        positions = positions + n
        advances.append(n.tolist())
        if len(advances) % c_groups == 0:
            settled = compact_suffix_pr(raw, settled, rawtgt)
            rawtgt.fill_(-1)
            w = e - 1
    valid = torch.arange(total + g, device=dev)[None, :] < e[:, None]
    out_final = torch.where(valid, out, pad)[:, :total]
    stats = {"groups": len(advances),
             "accepted_drafts": sum(max(x - 1, 0) for a in advances
                                    for x in a),
             "row_tokens": e.clamp(max=total).tolist(),
             "advances": advances}
    if not return_state:
        return out_final, stats
    # FLUSH: the in-loop verify never feeds a row's last emitted token, so
    # one carry-only forward (pad drafts, their raw rows never marked)
    # computes its KV, which the engine folds, and the logits of the next
    # token; a last compaction settles every pending raw row
    last_tok = torch.gather(out, 1, (e - 1)[:, None])[:, 0]
    toks = torch.cat([last_tok[:, None],
                      torch.full((b, k), pad, dtype=out.dtype, device=dev)],
                     dim=1)
    slot = (len(advances) % c_groups) * g
    logits, raw = llava_model.decode_step_multi_pr(
        model, toks, kv, pm, raw, settled, slot, rawtgt >= 0, w, positions,
        lora=lora, lora_scaling=lora_scaling, sp_used=sp_used, head=head)
    rawtgt[:, slot:slot + g] = -1
    rawtgt[:, slot] = e - 1
    settled = compact_suffix_pr(raw, settled, rawtgt)
    # positions tracks the carry token (the last emitted one)
    return out_final, stats, {
        "suffix": settled, "positions": positions + 1,
        "last_logits": logits[:, 0].float(), "done": done,
        "emitted": e.clamp(max=total)}
