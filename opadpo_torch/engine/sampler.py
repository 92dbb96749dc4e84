"""Autoregressive sampler, prefill + decode: port of
``opadpo_tpu/engine/sampler.py`` (``Sampler`` in its unrolled layout,
``decode_loop_unrolled`` and ``truncate_after_tokens``).

The prompt KV is computed once by prefill (bf16, or int8 / packed int4
head-major with ``kv_bits`` 8 / 4) and each decode step writes its token's
KV into a small bf16 suffix buffer in place.  With ``chunk`` the suffix is
re-quantized and folded into the cache, preallocated at its final length,
every ``chunk`` steps, and each chunk's kernels read the cache only to its
fill watermark.  With ``spec_k`` each step verifies k drafted tokens in
one forward (``engine/speculative.py``).  With ``head_bits`` 8 or 4 the
prefill and decode passes read an int8 / int4 copy of the lm_head, made
once per model.  Decoding stops when every row has emitted EOS, as the JAX
``while_loop`` does.

Under tensor parallelism each rank's caches hold its own heads and the
logits come back gathered over the vocabulary; every rank samples from
them and takes model rank 0's tokens (a ``broadcast``), so the ranks'
caches never fork.  Speculative decode takes rank 0's first tokens and
each group's verdicts and corrections the same way
(``engine/speculative.py``).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from opadpo_torch.engine import speculative
from opadpo_torch.engine.sampling import SamplingConfig, sample_tokens
from opadpo_torch.models import llama as llama_model
from opadpo_torch.models import llava as llava_model
from opadpo_torch.ops.decode_attention import MAX_G
from opadpo_torch.parallel import comm


def decode_loop_unrolled(model, prompt_kv_list: list,
                         prompt_mask: torch.Tensor, positions: torch.Tensor,
                         last_logits: torch.Tensor,
                         generator: Optional[torch.Generator],
                         sampling: SamplingConfig, lora=None,
                         lora_scaling: float = 1.0, head=None,
                         done_init: Optional[torch.Tensor] = None,
                         max_new: Optional[int] = None,
                         return_state: bool = False,
                         sp_used: Optional[int] = None):
    """-> (tokens [B, max_new] int64, pad after each row's EOS; the number
    of decode forwards run), and with ``return_state`` also the state a
    chunked decode continues from: {"step": suffix rows written, "suffix",
    "positions", "last_logits", "done"}.

    ``max_new`` (default ``sampling.max_new_tokens``) steps, rows in
    ``done_init`` already finished; ``head``: a quantized decode head, or
    None for the model's lm_head; ``sp_used``: the prompt cache's fill
    watermark.  The forward of a step is skipped where nothing reads it:
    once every row is done, and at the last step unless ``return_state``
    (a chunk's last step gives the KV to fold and the next chunk's first
    logits)."""
    b = prompt_mask.shape[0]
    n_new = max_new or sampling.max_new_tokens
    dev = prompt_mask.device
    suffix = llama_model.init_suffix_cache(model.llama.cfg, b, n_new, dev)
    tp = model.llama.tp
    out = torch.full((b, n_new), sampling.pad_token_id, dtype=torch.int64,
                     device=dev)
    done = (torch.zeros(b, dtype=torch.bool, device=dev) if done_init is None
            else done_init.clone())
    n_fwd = 0
    for step in range(n_new):
        tok = sample_tokens(last_logits, sampling, generator)
        tok = comm.broadcast_(tok, tp)
        tok = torch.where(done, sampling.pad_token_id, tok)
        out[:, step] = tok
        done = done | (tok == sampling.eos_token_id)
        if bool(done.all()) or (step == n_new - 1 and not return_state):
            break
        last_logits, suffix = llava_model.decode_step_unrolled(
            model, tok, prompt_kv_list, prompt_mask, suffix, step, positions,
            lora=lora, lora_scaling=lora_scaling, sp_used=sp_used, head=head)
        positions = positions + 1
        n_fwd += 1
    if not return_state:
        return out, n_fwd
    return out, n_fwd, {"step": n_fwd, "suffix": suffix,
                        "positions": positions, "last_logits": last_logits,
                        "done": done}


class Sampler:
    """Prefill then decode, per-layer weights.

    - ``kv_bits``: the prompt cache in bf16 (16), int8 (8) or packed int4
      (4, lengths in 256-position groups);
    - ``head_bits``: the model's lm_head (16) or an int8 / int4 copy;
    - ``chunk`` (kv 8 or 4): fold the suffix into the cache every
      ``chunk`` steps, a multiple of 128 (256 at kv 4);
    - ``spec_k``: speculative decode, k drafts (``spec_draft`` "ngram" or
      "pad") verified per group, rows advancing together
      (``spec_advance="shared"``) or each by its own run ("per_row"); kv 16
      or 8, no chunk, greedy or top-k sampling, MHA.

    ``stats`` holds, for each of the last 1000 calls, its phase times (host
    clock around work that ends in a device synchronise), its prompt
    length after the image splice, its decode forward count
    (``decode_steps``; verify forwards with ``spec_k``), its folds and the
    watermarks its chunks read (``sp_used``), and with ``spec_k`` its
    groups, accepted drafts, tokens per row and advances summed per row."""

    def __init__(self, sampling: SamplingConfig, lora_scaling: float = 1.0,
                 kv_bits: int = 16, head_bits: int = 16, chunk: int = 0,
                 spec_k: int = 0, spec_draft: str = "ngram",
                 spec_advance: str = "shared"):
        if kv_bits not in (16, 8, 4):
            raise ValueError(f"kv_bits={kv_bits}: 16, 8 or 4")
        if head_bits not in (16, 8, 4):
            raise ValueError(f"head_bits={head_bits}: 16, 8 or 4")
        align = llama_model.KV_ALIGN4 if kv_bits == 4 else \
            llama_model.KV_ALIGN
        if chunk:
            if kv_bits == 16:
                raise ValueError("chunked decode needs kv_bits 8 or 4")
            if chunk < 0 or chunk % align:
                raise ValueError(f"chunk={chunk} must be a multiple of "
                                 f"{align} at kv_bits {kv_bits}")
        if spec_k:
            if spec_k < 0:
                raise ValueError(f"spec_k={spec_k}")
            if chunk:
                raise ValueError("speculative decode runs without chunk")
            if kv_bits not in (16, 8):
                raise ValueError("speculative decode needs kv_bits 16 or 8")
            if kv_bits == 8 and spec_k + 1 > MAX_G:
                raise ValueError(f"spec_k={spec_k}: the multi-query kernel "
                                 "verifies at most 8 tokens (spec_k <= 7)")
            if not (sampling.greedy or (sampling.top_k or 0) > 0):
                raise ValueError("speculative sampling needs greedy or "
                                 "top_k > 0 (temperature > 0 with top_k 0 "
                                 "is not supported)")
            if spec_draft == "oracle":
                raise ValueError("spec_draft='oracle' needs oracle tokens, "
                                 "which the Sampler does not have")
            if spec_draft not in speculative.DRAFTS:
                raise ValueError(f"spec_draft={spec_draft!r}: one of "
                                 f"{speculative.DRAFTS}")
            if spec_advance not in speculative.ADVANCES:
                raise ValueError(f"spec_advance={spec_advance!r}: one of "
                                 f"{speculative.ADVANCES}")
        self.sampling = sampling
        self.lora_scaling = lora_scaling
        self.kv_bits = kv_bits
        self.head_bits = head_bits
        self.chunk = chunk
        self._kv_align = align
        self.spec = (speculative.SpecConfig(k=spec_k, draft=spec_draft,
                                            advance=spec_advance)
                     if spec_k else None)
        self._head = None                 # (model, its quantized head)
        self.stats: deque = deque(maxlen=1000)

    def _kv_total_len(self, s_prompt: int) -> int:
        """The chunked cache's final length: the padded prompt and one
        chunk per fold (the last chunk never folds)."""
        a = self._kv_align
        n_chunks = -(-self.sampling.max_new_tokens // self.chunk)
        return -(-s_prompt // a) * a + (n_chunks - 1) * self.chunk

    def prefill(self, model, input_ids, text_mask, images, lora=None,
                head=None) -> dict:
        """The prompt pass with this sampler's cache:
        ``llava.prefill_unrolled``'s dict."""
        s_prompt = input_ids.shape[1] - 1 + model.cfg.num_patches
        return llava_model.prefill_unrolled(
            model, input_ids, text_mask, images, lora=lora,
            lora_scaling=self.lora_scaling, quantize_kv=self.kv_bits != 16,
            kv_total_len=(self._kv_total_len(s_prompt) if self.chunk
                          else None),
            kv_bits=self.kv_bits, head=head)

    def decode(self, model, pf: dict,
               generator: Optional[torch.Generator] = None, lora=None,
               head=None) -> Tuple[torch.Tensor, dict]:
        """Decode after ``prefill`` -> (tokens [B, max_new_tokens], what it
        did: decode_steps, folds, sp_used and the speculative counts)."""
        info = {"decode_steps": 0, "folds": 0, "sp_used": []}
        args = (model, pf["kv_list"], pf["key_mask"], pf["next_position"],
                pf["last_logits"], generator, self.sampling)
        kw = dict(lora=lora, lora_scaling=self.lora_scaling, head=head)
        if self.chunk:
            return self._decode_chunked(*args, info, **kw)
        if self.spec is not None:
            cfg = model.cfg.llama
            if cfg.num_heads != cfg.num_kv_heads:
                raise ValueError("speculative verify needs multi-head "
                                 "attention (num_kv_heads == num_heads)")
            out, st = speculative.decode_loop_spec(*args, self.spec, **kw)
            info.update(decode_steps=st["groups"], spec_groups=st["groups"],
                        accepted_drafts=st["accepted_drafts"],
                        row_tokens=st["row_tokens"],
                        row_advances=[sum(a) for a in zip(*st["advances"])])
            return out, info
        out, info["decode_steps"] = decode_loop_unrolled(*args, **kw)
        return out, info

    def _decode_chunked(self, model, kv_list, key_mask, positions,
                        last_logits, generator, sampling, info, **kw):
        """Decode in chunks of ``self.chunk`` steps.  The cache was
        preallocated at its final length by prefill; after each chunk but
        the last the suffix is folded into it in place at the fill
        watermark, and chunk ``ci`` reads the cache to ``sp_used = sp_pad0
        + ci * chunk``."""
        c, total = self.chunk, sampling.max_new_tokens
        b = key_mask.shape[0]
        sp_total = kv_list[0][0]["scale"].shape[2]
        a = self._kv_align
        sp_pad0 = -(-key_mask.shape[1] // a) * a
        # the mask in cache layout: zero on the padding and unfilled tail
        pm = F.pad(key_mask, (0, sp_total - key_mask.shape[1]))
        done = torch.zeros(b, dtype=torch.bool, device=pm.device)
        n_chunks = -(-total // c)
        outs = []
        for ci in range(n_chunks):
            sp_used = sp_pad0 + ci * c
            last = ci == n_chunks - 1
            res = decode_loop_unrolled(
                model, kv_list, pm, positions, last_logits, generator,
                sampling, done_init=done, max_new=min(c, total - ci * c),
                return_state=not last, sp_used=sp_used, **kw)
            outs.append(res[0])
            info["decode_steps"] += res[1]
            info["sp_used"].append(sp_used)
            if last:
                break
            st = res[2]
            done = st["done"]
            if bool(done.all()):
                break
            positions, last_logits = st["positions"], st["last_logits"]
            kv_list, pm = llama_model.fold_suffix_into_prompt_kv(
                kv_list, st["suffix"], pm, st["step"], sp_used)
            info["folds"] += 1
        out = torch.cat(outs, dim=1)
        return F.pad(out, (0, total - out.shape[1]),
                     value=sampling.pad_token_id), info

    def generate(self, model, input_ids: torch.Tensor,
                 text_mask: torch.Tensor, images: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 lora=None) -> torch.Tensor:
        """[B, L] left-padded prompts with one image token each, their
        mask, [B, H, W, 3] images -> tokens [B, max_new_tokens]."""
        sync = (torch.cuda.synchronize if input_ids.is_cuda
                else (lambda: None))
        head = self.decode_head(model)
        t0 = time.perf_counter()
        pf = self.prefill(model, input_ids, text_mask, images, lora, head)
        sync()
        t1 = time.perf_counter()
        out, info = self.decode(model, pf, generator, lora, head)
        sync()
        t2 = time.perf_counter()
        self.stats.append({"prefill_s": t1 - t0, "decode_s": t2 - t1,
                           "prompt_positions": pf["key_mask"].shape[1],
                           "batch_rows": int(input_ids.shape[0]), **info})
        return out

    def decode_head(self, model):
        """The quantized decode head of ``model`` (made on its first use,
        then kept), or None at ``head_bits=16``."""
        if self.head_bits == 16:
            return None
        if self._head is None or self._head[0] is not model:
            self._head = (model, llama_model.quantize_head_for_decode(
                model.llama, self.head_bits))
        return self._head[1]


def truncate_after_tokens(
    responses: np.ndarray,
    eos_token_id: int,
    pad_token_id: int,
    additional_tokens: Optional[Tuple[int, ...]] = None,
) -> np.ndarray:
    """Keep each row through its first EOS (or additional stop token) and
    pad the rest."""
    out = responses.copy()
    stops = {eos_token_id}
    if additional_tokens:
        stops.update(additional_tokens)
    for i in range(out.shape[0]):
        idxs = np.nonzero(np.isin(out[i], list(stops)))[0]
        if idxs.size:
            out[i, idxs[0] + 1:] = pad_token_id
    return out
