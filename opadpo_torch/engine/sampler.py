"""Autoregressive sampler, prefill + decode: port of
``opadpo_tpu/engine/sampler.py`` (``Sampler`` in its unrolled layout,
``decode_loop_unrolled`` and ``truncate_after_tokens``).

The prompt KV is computed once by prefill (int8 head-major with
``kv_bits=8``) and stays constant; each decode step writes its token's KV
into a small bf16 suffix buffer in place.  With ``head_bits`` 8 or 4 the
prefill and decode passes read an int8 / int4 copy of the lm_head, made
once per model.  The decode loop stops when every
row has emitted EOS, as the JAX ``while_loop`` does; the forward of a step
whose token ends the loop is skipped, since no one reads its logits.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional, Tuple

import numpy as np
import torch

from opadpo_torch.engine.sampling import SamplingConfig, sample_tokens
from opadpo_torch.models import llama as llama_model
from opadpo_torch.models import llava as llava_model


def decode_loop_unrolled(model, prompt_kv_list: list,
                         prompt_mask: torch.Tensor, positions: torch.Tensor,
                         last_logits: torch.Tensor,
                         generator: Optional[torch.Generator],
                         sampling: SamplingConfig, lora=None,
                         lora_scaling: float = 1.0, head=None
                         ) -> Tuple[torch.Tensor, int]:
    """-> (tokens [B, max_new_tokens] int64, pad after each row's EOS;
    the number of decode forwards run).  ``head``: a quantized decode
    head, or None for the model's lm_head."""
    cfg = model.cfg.llama
    b = prompt_mask.shape[0]
    n_new = sampling.max_new_tokens
    dev = prompt_mask.device
    shape = (b, n_new, cfg.num_kv_heads, cfg.head_dim)
    suffix = [(torch.zeros(shape, dtype=cfg.dtype, device=dev),
               torch.zeros(shape, dtype=cfg.dtype, device=dev))
              for _ in range(cfg.num_layers)]
    out = torch.full((b, n_new), sampling.pad_token_id, dtype=torch.int64,
                     device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    n_fwd = 0
    for step in range(n_new):
        tok = sample_tokens(last_logits, sampling, generator)
        tok = torch.where(done, sampling.pad_token_id, tok)
        out[:, step] = tok
        done = done | (tok == sampling.eos_token_id)
        if step == n_new - 1 or bool(done.all()):
            break
        last_logits, suffix = llava_model.decode_step_unrolled(
            model, tok, prompt_kv_list, prompt_mask, suffix, step, positions,
            lora=lora, lora_scaling=lora_scaling, head=head)
        positions = positions + 1
        n_fwd += 1
    return out, n_fwd


class Sampler:
    """Prefill then decode, per-layer weights, with a bf16 (``kv_bits=16``)
    or int8 (``kv_bits=8``) prompt cache, and the model's lm_head
    (``head_bits=16``) or an int8 / int4 copy of it (8 / 4).

    ``stats`` holds, for each of the last 1000 calls, its phase times (host
    clock around work that ends in a device synchronise), its prompt
    length after the image splice and its decode forward count."""

    def __init__(self, sampling: SamplingConfig, lora_scaling: float = 1.0,
                 kv_bits: int = 16, head_bits: int = 16, chunk: int = 0,
                 spec_k: int = 0):
        if kv_bits == 4:
            raise NotImplementedError(
                "kv_bits=4 needs the int4 decode kernel (_kernel4): ROADMAP "
                "slice 4, kv4/chunked/speculative decode")
        if kv_bits not in (16, 8):
            raise ValueError(f"kv_bits={kv_bits}")
        if chunk:
            raise NotImplementedError(
                "chunked decode: ROADMAP slice 4, kv4/chunked/speculative "
                "decode")
        if spec_k:
            raise NotImplementedError(
                "speculative decode needs the multi-query decode kernel "
                "(_kernel_multi): ROADMAP slice 4")
        if head_bits not in (16, 8, 4):
            raise ValueError(f"head_bits={head_bits}")
        self.sampling = sampling
        self.lora_scaling = lora_scaling
        self.kv_bits = kv_bits
        self.head_bits = head_bits
        self._head = None                 # (model, its quantized head)
        self.stats: deque = deque(maxlen=1000)

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
        pf = llava_model.prefill_unrolled(
            model, input_ids, text_mask, images, lora=lora,
            lora_scaling=self.lora_scaling, quantize_kv=self.kv_bits == 8,
            head=head)
        sync()
        t1 = time.perf_counter()
        out, n_fwd = decode_loop_unrolled(
            model, pf["kv_list"], pf["key_mask"], pf["next_position"],
            pf["last_logits"], generator, self.sampling, lora=lora,
            lora_scaling=self.lora_scaling, head=head)
        sync()
        t2 = time.perf_counter()
        self.stats.append({"prefill_s": t1 - t0, "decode_s": t2 - t1,
                           "prompt_positions": pf["key_mask"].shape[1],
                           "decode_steps": n_fwd,
                           "batch_rows": int(input_ids.shape[0])})
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
