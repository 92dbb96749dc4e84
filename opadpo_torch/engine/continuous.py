"""Continuous (in-flight) batching over a slot pool of quantized prompt
caches: port of ``opadpo_tpu/engine/continuous.py``.

A fixed pool of B slots decodes in SEGMENTS of ``seg_len`` steps, and the
slots that finished are refilled between segments, so a request's latency
follows its own length rather than its batch's longest.

- The cache is the chunked-decode design (``engine/sampler.Sampler``): per
  layer an int8 (``kv_bits`` 8) or packed int4 (4) prompt cache
  preallocated at ``s_total = ceil((qlen - 1 + patches + max_new) / a) *
  a`` positions (``a`` 128, or 256 packed), and a bf16 suffix for the
  segment's own tokens.  Nothing reallocates after the first admission.
- ADMISSION: waiting requests are prefilled together in groups of 4, 2 or
  1 (at most ``max_admit_group``) and written into their slots' rows in
  place by index.
- SEGMENT: ``decode_loop_unrolled`` (or, with ``spec_k``, the per-row
  speculative loop in segment mode) runs the whole pool; free and
  finished rows ride along as ``done`` and emit pads.  The kernels read
  the cache to the watermark ``su``: the longest active row rounded up to
  ``su_bucket``, computed from the host mirror of the fill offsets, so no
  device-to-host copy is made for it.
- FOLD: each row's kept tokens are quantized as ``quantize_prompt_kv`` /
  ``quantize_prompt_kv_int4`` quantize them (per row, position and head,
  so a value does not depend on when its token is folded) and written at
  that row's own fill offset by an index scatter, in place.  The JAX
  package selects them with one-hot einsums, a TPU workaround.  In the
  packed int4 cache position p lives in byte ``(p // 256) * 128 + p %
  128``, low nibble when ``p % 256 < 128``; each touched byte is rebuilt
  from its old and new nibbles and written once, so offsets are arbitrary
  and a window that covers both nibbles of a byte never races.

Every random draw comes from one explicit ``torch.Generator``.

Under tensor parallelism each rank of a model group runs the pool on its
own heads: the caches are shaped from the first admitted group's prefill,
which is local, the admission and the folds write local heads, and the
last logits come back gathered over the whole vocabulary.  The segment
loops take model rank 0's sampled tokens (and, with ``spec_k``, its
verdicts), so the host bookkeeping after a segment is equal on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from opadpo_torch.engine import speculative
from opadpo_torch.engine.sampler import decode_loop_unrolled
from opadpo_torch.engine.sampling import SamplingConfig
from opadpo_torch.models import llama as llama_model
from opadpo_torch.models import llava as llava_model
from opadpo_torch.ops.decode_attention import MAX_G


def _fold_index(row_len, n_valid, s_total: int, n_suffix: int):
    """Host arrays [B] -> (rows [N], suffix index t [N], cache position
    [N]) of every entry a per-row fold writes, checked here against the
    cache and suffix lengths: on the GPU an index out of range is a device
    fault, not an error."""
    rl = np.asarray(row_len, np.int64)
    nv = np.asarray(n_valid, np.int64)
    if nv.size and (nv.min() < 0 or nv.max() > n_suffix
                    or (rl + nv).max() > s_total or rl.min() < 0):
        raise ValueError(f"fold window row_len {rl.tolist()} + n_valid "
                         f"{nv.tolist()} outside a cache of {s_total} "
                         f"positions or a suffix of {n_suffix}")
    rows = np.repeat(np.arange(nv.shape[0]), nv)
    t = np.arange(rows.shape[0]) - np.repeat(np.cumsum(nv) - nv, nv)
    return rows, t, rl[rows] + t


def fold_suffix_per_row(kv_list: list, suffix_list: list, pm: torch.Tensor,
                        row_len, n_valid) -> tuple:
    """Fold each row's first ``n_valid[i]`` suffix entries ([B, C, H, hd]
    per layer) into the int8 cache at position ``row_len[i]``, in place,
    and set ``pm`` [B, S_total] over the same window.  ``row_len`` and
    ``n_valid`` are host integer arrays [B].  -> (kv_list, pm), the objects
    given."""
    rows, t, pos = _fold_index(row_len, n_valid, pm.shape[1],
                               suffix_list[0][0].shape[1])
    if rows.shape[0] == 0:
        return kv_list, pm
    dev = pm.device
    rows_d, t_d, pos_d = (torch.as_tensor(x, device=dev)
                          for x in (rows, t, pos))
    n = rows.shape[0]
    for pair, suffix in zip(kv_list, suffix_list):
        for cache, new in zip(pair, suffix):
            qn = llama_model.quantize_prompt_kv(new[rows_d, t_d][None])
            cache["q"][rows_d, :, pos_d] = qn["q"][0, :, :n].transpose(0, 1)
            cache["scale"][rows_d, :, pos_d] = qn["scale"][0, :, :n].T
    pm[rows_d, pos_d] = 1
    return kv_list, pm


def fold_suffix_per_row_int4(kv_list: list, suffix_list: list,
                             pm: torch.Tensor, row_len, n_valid) -> tuple:
    """``fold_suffix_per_row`` into the packed int4 cache: every touched
    byte is rebuilt from its old nibble outside the row's window and the
    new int4 value inside it, and written once."""
    rows, t, pos = _fold_index(row_len, n_valid, pm.shape[1],
                               suffix_list[0][0].shape[1])
    if rows.shape[0] == 0:
        return kv_list, pm
    half = pm.shape[1] // 2
    byte = (pos // 256) * 128 + pos % 128
    hi = pos % 256 >= 128
    keys, inv = np.unique(rows * half + byte, return_inverse=True)
    t_lo = np.full(keys.shape, -1, np.int64)
    t_hi = np.full(keys.shape, -1, np.int64)
    t_lo[inv[~hi]] = t[~hi]
    t_hi[inv[hi]] = t[hi]
    dev = pm.device
    rows_d, t_d, pos_d = (torch.as_tensor(x, device=dev)
                          for x in (rows, t, pos))
    b_rows, b_byte, tl, th = (torch.as_tensor(x, device=dev) for x in (
        keys // half, keys % half, t_lo, t_hi))
    for pair, suffix in zip(kv_list, suffix_list):
        for cache, new in zip(pair, suffix):
            qv = llama_model.quantize_prompt_kv_int4_values(new)
            old = cache["q4"][b_rows, :, b_byte].to(torch.int32)  # [U,H,hd]
            old_lo = ((old & 0xF) ^ 8) - 8
            old_hi = old >> 4
            new_lo = torch.where(
                (tl >= 0)[:, None, None],
                qv["qv"][b_rows, :, tl.clamp(min=0)], old_lo)
            new_hi = torch.where(
                (th >= 0)[:, None, None],
                qv["qv"][b_rows, :, th.clamp(min=0)], old_hi)
            cache["q4"][b_rows, :, b_byte] = (
                new_hi * 16 + (new_lo & 0xF)).to(torch.int8)
            cache["scale"][rows_d, :, pos_d] = qv["scale"][rows_d, :, t_d]
    pm[rows_d, pos_d] = 1
    return kv_list, pm


@dataclasses.dataclass
class _Slot:
    request_id: int
    tokens: List[np.ndarray]            # per-segment kept tokens
    budget: int                         # per-request max_new cap
    emitted: int = 0
    finished: bool = False
    oracle: Optional[np.ndarray] = None  # spec_draft="oracle" drafts


class ContinuousEngine:
    """Slot-pool decode engine.  Usage::

        eng = ContinuousEngine(model, sampling, max_batch=16, qlen=128,
                               seg_len=64)
        rid = eng.add_request(ids_1d, mask_1d, image)   # host numpy
        while eng.has_work():
            for rid, toks in eng.step():
                ...                                     # finished requests

    ``sampling.max_new_tokens`` is the per-request cap and sizes the cache;
    ``seg_len`` is the scheduling quantum (admission happens between
    segments).  ``head_bits`` 8 / 4: an int8 / int4 copy of the lm_head for
    the prefill and decode passes.  ``prefill``: a callable ``(ids [k,
    qlen], mask, images [k, H, W, 3]) -> llava.prefill_unrolled``'s dict
    (quantized cache, on the engine's device), in place of the engine's
    own.  ``stats`` counts what the engine ran: segments, folds, each
    admission group's size, decoder forwards of the segments (verify
    groups and flushes with ``spec_k``), segments per watermark, tokens
    kept; ``spec_stats`` (with ``collect_spec_stats``) the speculative
    groups, accepted drafts and verify-loop tokens.

    Over a tensor-parallel model every rank of the model group must be
    given the same requests in the same order (the same ``add_request``
    calls, the same ``step`` calls), and a ``generator`` seeded equally on
    every rank of the group: admission, segments and folds are collective
    there."""

    def __init__(self, model, sampling: SamplingConfig, lora=None,
                 lora_scaling: float = 1.0, max_batch: int = 8,
                 qlen: int = 128, seg_len: int = 64, su_bucket: int = 256,
                 max_admit_group: int = 4, kv_bits: int = 8,
                 generator: Optional[torch.Generator] = None,
                 spec_k: int = 0, spec_draft: str = "ngram",
                 collect_spec_stats: bool = False, head_bits: int = 16,
                 prefill: Optional[Callable] = None):
        cfg = model.cfg
        if kv_bits not in (8, 4):
            raise ValueError(f"kv_bits={kv_bits}: the slot pool is int8 (8) "
                             "or packed int4 (4)")
        if max_admit_group not in (1, 2, 4):
            raise ValueError(f"max_admit_group={max_admit_group}: 1, 2 or 4")
        if head_bits not in (16, 8, 4):
            raise ValueError(f"head_bits={head_bits}: 16, 8 or 4")
        if seg_len < 1 or max_batch < 1:
            raise ValueError(f"seg_len={seg_len}, max_batch={max_batch}")
        self.model = model
        self.cfg = cfg
        self.sampling = sampling
        self.lora = lora
        self.lora_scaling = lora_scaling
        self.b = max_batch
        self.qlen = qlen
        self.seg_len = seg_len
        self.kv_bits = kv_bits
        # the decode kernels' watermark is a multiple of 128 (int8) or of
        # the 256-position packed group (int4); the fold needs no alignment
        a = llama_model.KV_ALIGN4 if kv_bits == 4 else llama_model.KV_ALIGN
        self.su_bucket = max(a, (su_bucket // a) * a)
        self.max_admit_group = max_admit_group
        self.device = next(model.parameters()).device
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.generator = generator
        self.head = (None if head_bits == 16 else
                     llama_model.quantize_head_for_decode(model.llama,
                                                          head_bits))
        self._prefill = prefill or self._prefill_model

        self.sp_splice = qlen - 1 + cfg.num_patches
        self.s_total = -(-(self.sp_splice + sampling.max_new_tokens)
                         // a) * a
        self._queue: List[tuple] = []   # (rid, q, m, img, budget, oracle)
        self._slots: List[Optional[_Slot]] = [None] * self.b
        self._next_id = 0
        self._state = None               # [kv, pm, positions, last_logits]
        # host mirror of the fill offsets: admission sets sp_splice, folds
        # add n_valid, so the watermark needs no device read
        self._row_len_host = np.zeros((self.b,), np.int64)

        self.spec_k = int(spec_k)
        self.spec_draft = spec_draft
        self.collect_spec_stats = collect_spec_stats
        self.spec_stats = {"groups": 0, "accepted_drafts": 0, "tokens": 0}
        self.spec = None
        if self.spec_k:
            if self.spec_k < 0 or self.spec_k + 1 > MAX_G:
                raise ValueError(f"spec_k={spec_k}: 1 ... {MAX_G - 1} (the "
                                 "multi-query kernel verifies at most "
                                 f"{MAX_G} tokens)")
            if kv_bits != 8:
                raise ValueError("speculative segments need the int8 pool "
                                 "(kv_bits 8)")
            if cfg.llama.num_heads != cfg.llama.num_kv_heads:
                raise ValueError("speculative segments need multi-head "
                                 "attention (num_kv_heads == num_heads)")
            if not (sampling.greedy or (sampling.top_k or 0) > 0):
                raise ValueError("speculative sampling needs greedy or "
                                 "top_k > 0")
            if spec_draft not in speculative.DRAFTS:
                raise ValueError(f"spec_draft={spec_draft!r}: one of "
                                 f"{speculative.DRAFTS}")
            self.spec = speculative.SpecConfig(
                k=self.spec_k, draft=spec_draft, advance="per_row",
                compact_every=max(4, min(32, seg_len)))
        # full_queued: segments decoded with every slot live that ended with
        # requests still waiting in the queue
        self.stats = {"segments": 0, "folds": 0, "admit_groups": [],
                      "forwards": 0, "sp_used": {}, "tokens": 0,
                      "full_queued": 0}

    # -- request intake -------------------------------------------------

    def add_request(self, input_ids, text_mask, image,
                    max_new: Optional[int] = None,
                    oracle_tokens: Optional[np.ndarray] = None) -> int:
        """Queue one request (1-D prompt ids and mask, one image [H, W,
        3]).  The prompt is left-padded or left-truncated to ``qlen``;
        ``max_new`` caps this request's generation (clipped to
        ``sampling.max_new_tokens``); ``oracle_tokens`` feeds the "oracle"
        draft: the draft at generated-token offset t is
        ``oracle_tokens[t:t + k]``."""
        ids = np.asarray(input_ids)[-self.qlen:]
        msk = np.asarray(text_mask)[-self.qlen:]
        q = np.zeros((self.qlen,), np.int64)
        m = np.zeros((self.qlen,), np.int64)
        q[-len(ids):] = ids
        m[-len(msk):] = msk
        budget = self.sampling.max_new_tokens if max_new is None else \
            max(1, min(max_new, self.sampling.max_new_tokens))
        rid = self._next_id
        self._next_id += 1
        ora = None if oracle_tokens is None else \
            np.asarray(oracle_tokens, np.int64)
        self._queue.append((rid, q, m, np.asarray(image, np.float32), budget,
                            ora))
        return rid

    @property
    def queue_length(self) -> int:
        """Requests added and not yet admitted."""
        return len(self._queue)

    def has_work(self) -> bool:
        return bool(self._queue) or any(
            s is not None and not s.finished for s in self._slots)

    def _segment_oracle(self) -> torch.Tensor:
        """[B, seg_len + k] drafts for this segment: each active row's
        oracle tokens from its own emitted offset, pads elsewhere."""
        pad = self.sampling.pad_token_id
        width = self.seg_len + self.spec_k
        ora = np.full((self.b, width), pad, np.int64)
        if self.spec_draft == "oracle":
            for i, slot in enumerate(self._slots):
                if slot is None or slot.finished or slot.oracle is None:
                    continue
                chunk = slot.oracle[slot.emitted:slot.emitted + width]
                ora[i, :len(chunk)] = chunk
        return torch.as_tensor(ora, device=self.device)

    # -- device state ---------------------------------------------------

    def _prefill_model(self, ids, mask, images) -> dict:
        return llava_model.prefill_unrolled(
            self.model, ids, mask, images, lora=self.lora,
            lora_scaling=self.lora_scaling, quantize_kv=True,
            kv_bits=self.kv_bits, head=self.head)

    def _init_state(self, row_kv, key_mask) -> list:
        """The zero pool, shaped from the first admitted group's prefill."""
        st, b, dev = self.s_total, self.b, self.device
        kv = []
        for pk, _ in row_kv:
            key = "q4" if "q4" in pk else "q"
            h, hd = pk[key].shape[1], pk[key].shape[3]
            sq = st // 2 if key == "q4" else st
            kv.append(tuple(
                {key: torch.zeros((b, h, sq, hd), dtype=torch.int8,
                                  device=dev),
                 "scale": torch.zeros((b, h, st), dtype=pk["scale"].dtype,
                                      device=dev)}
                for _ in range(2)))
        pm = torch.zeros((b, st), dtype=key_mask.dtype, device=dev)
        pos = torch.zeros((b,), dtype=torch.int64, device=dev)
        ll = torch.zeros((b, self.cfg.llama.vocab_size), dtype=torch.float32,
                         device=dev)
        return [kv, pm, pos, ll]

    def _admit_rows(self, pf: dict, slots: List[int]) -> None:
        """Write a prefilled group's rows into ``slots`` in place: the
        cache rows (zero past the prompt), mask, next position and last
        logits."""
        kv, pm, pos, ll = self._state
        sl = torch.as_tensor(slots, dtype=torch.int64, device=self.device)
        for pair, rows in zip(kv, pf["kv_list"]):
            for pc, rc in zip(pair, rows):
                key = "q4" if "q4" in pc else "q"
                for name in (key, "scale"):
                    sp = rc[name].shape[2]
                    pc[name][sl, :, :sp] = rc[name].to(pc[name].dtype)
                    pc[name][sl, :, sp:] = 0
        km = pf["key_mask"]
        pm[sl, :km.shape[1]] = km.to(pm.dtype)
        pm[sl, km.shape[1]:] = 0
        pos[sl] = pf["next_position"].to(pos.dtype)
        ll[sl] = pf["last_logits"].float()

    # -- scheduling -----------------------------------------------------

    def _admit_pending(self) -> None:
        free = [i for i in range(self.b)
                if self._slots[i] is None or self._slots[i].finished]
        take = min(len(free), len(self._queue))
        if not take:
            return
        assignments = list(zip(free[:take],
                               [self._queue.pop(0) for _ in range(take)]))
        # groups of 4, 2 or 1: a burst pays one prefill per group
        i = 0
        while i < len(assignments):
            left = len(assignments) - i
            k = min(self.max_admit_group,
                    4 if left >= 4 else 2 if left >= 2 else 1)
            group = assignments[i:i + k]
            i += k
            dev = self.device
            pf = self._prefill(
                torch.as_tensor(np.stack([g[1][1] for g in group]),
                                device=dev),
                torch.as_tensor(np.stack([g[1][2] for g in group]),
                                device=dev),
                torch.as_tensor(np.stack([g[1][3] for g in group]),
                                device=dev))
            if self._state is None:
                self._state = self._init_state(pf["kv_list"],
                                               pf["key_mask"])
            self._admit_rows(pf, [g[0] for g in group])
            self.stats["admit_groups"].append(k)
            for slot_idx, (rid, _, _, _, budget, ora) in group:
                self._slots[slot_idx] = _Slot(request_id=rid, tokens=[],
                                              budget=budget, oracle=ora)
                self._row_len_host[slot_idx] = self.sp_splice

    @torch.inference_mode()
    def step(self) -> List[Tuple[int, np.ndarray]]:
        """Admit pending requests, decode one segment, fold, and return the
        requests that finished in it as (request_id, tokens)."""
        self._admit_pending()
        if self._state is None:
            return []
        active = [s is not None and not s.finished for s in self._slots]
        if not any(active):
            return []
        kv, pm, pos, ll = self._state
        max_len = max(int(x) for x, a in zip(self._row_len_host, active)
                      if a)
        su = min(self.s_total,
                 -(-max_len // self.su_bucket) * self.su_bucket)
        done0 = torch.as_tensor(np.logical_not(active), device=self.device)
        kw = dict(lora=self.lora, lora_scaling=self.lora_scaling,
                  head=self.head, done_init=done0, max_new=self.seg_len,
                  return_state=True, sp_used=su)
        if self.spec is not None:
            out_d, sst, st = speculative.decode_loop_spec(
                self.model, kv, pm, pos, ll, self.generator, self.sampling,
                self.spec, oracle_tokens=self._segment_oracle(), **kw)
            forwards = sst["groups"] + 1              # the flush
            if self.collect_spec_stats:
                self.spec_stats["groups"] += sst["groups"]
                self.spec_stats["accepted_drafts"] += sst["accepted_drafts"]
                self.spec_stats["tokens"] += sum(
                    t - 1 for t in sst["row_tokens"])
        else:
            out_d, forwards, st = decode_loop_unrolled(
                self.model, kv, pm, pos, ll, self.generator, self.sampling,
                **kw)
        out = out_d.cpu().numpy()
        eos = self.sampling.eos_token_id

        finished: List[Tuple[int, np.ndarray]] = []
        n_valid = np.zeros((self.b,), np.int64)
        for i, slot in enumerate(self._slots):
            if slot is None or slot.finished or not active[i]:
                continue
            row = out[i]
            hit = np.nonzero(row == eos)[0]
            raw = int(hit[0]) + 1 if hit.size else self.seg_len
            keep = min(raw, slot.budget - slot.emitted)
            n_valid[i] = keep
            slot.tokens.append(row[:keep])
            slot.emitted += keep
            if hit.size and hit[0] < keep or slot.emitted >= slot.budget:
                slot.finished = True
                finished.append((slot.request_id,
                                 np.concatenate(slot.tokens)))

        fold = (fold_suffix_per_row if self.kv_bits == 8
                else fold_suffix_per_row_int4)
        fold(kv, st["suffix"], pm, self._row_len_host, n_valid)
        self._row_len_host += n_valid
        self._state = [kv, pm, st["positions"], st["last_logits"]]
        s = self.stats
        s["segments"] += 1
        s["folds"] += 1
        s["forwards"] += forwards
        s["sp_used"][su] = s["sp_used"].get(su, 0) + 1
        s["tokens"] += int(n_valid.sum())
        s["full_queued"] += int(all(active) and bool(self._queue))
        return finished
