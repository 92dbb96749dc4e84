"""Model set-up for the pipeline entry points: port of
``opadpo_tpu/pipeline/runtime.py`` (``llava_config_from_hf``,
``load_tokenizer``, ``setup_model``, ``StepTimer``,
``maybe_start_profiler``) and the host-batch move ``batch_to_device``.

``setup_model`` loads a checkpoint directory through ``models/loader`` or
draws random weights (``tiny``, ``skip_loading_weights``), then applies
the QLoRA quantization and the w8a8 switches.  Over a ``mesh``
(``parallel/mesh.make_mesh``) it keeps only this rank's shard of the
decoder (``parallel/sharding``), made one weight at a time: each weight
is drawn or read whole, quantized whole, then cut.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from opadpo_torch.device import resolve_device
from opadpo_torch.models import clip as clip_model
from opadpo_torch.models import llama as llama_model
from opadpo_torch.models import llava as llava_model
from opadpo_torch.models import projector as projector_model
from opadpo_torch.models.llava import Llava, LlavaConfig
from opadpo_torch.models.loader import load_llava_checkpoint
from opadpo_torch.ops import quant
from opadpo_torch.parallel import sharding
from opadpo_torch.parallel.mesh import Mesh, single_mesh
from opadpo_torch.utils import trace


def llava_config_from_hf(model_dir: str) -> LlavaConfig:
    """LlavaConfig from a HF checkpoint's ``config.json`` (only that file
    is read)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        top = json.load(f)
    # a llava-hf config keeps the decoder's dimensions under text_config
    hf = {**top, **top.get("text_config", {})}
    heads = hf.get("num_attention_heads", 32)
    lm = llama_model.LlamaConfig(
        vocab_size=hf.get("vocab_size", 32000),
        hidden_size=hf.get("hidden_size", 4096),
        intermediate_size=hf.get("intermediate_size", 11008),
        num_layers=hf.get("num_hidden_layers", 32),
        num_heads=heads,
        num_kv_heads=hf.get("num_key_value_heads", heads),
        head_dim=hf.get("hidden_size", 4096) // heads,
        max_position_embeddings=hf.get("max_position_embeddings", 4096),
        rope_base=hf.get("rope_theta", 10000.0),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
    )
    vis = clip_model.ClipVisionConfig(
        select_layer=hf.get("mm_vision_select_layer", -2))
    proj = projector_model.ProjectorConfig(in_dim=vis.hidden_size,
                                           out_dim=lm.hidden_size)
    return LlavaConfig(lm, vis, proj)


def load_tokenizer(model_dir: str, model_max_length: int = 2048):
    """The checkpoint's Vicuna/LLaMA tokenizer with the reference's pad
    handling (pad -> unk, id 0).  Needs ``transformers``."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            "load_tokenizer needs the transformers package, which is not "
            "installed; pass a tokenizer object instead") from e
    tok = AutoTokenizer.from_pretrained(model_dir, use_fast=False,
                                        model_max_length=model_max_length)
    if tok.pad_token is None:
        tok.pad_token = tok.unk_token
    return tok


def setup_model(
    model_dir: Optional[str] = None,
    vision_dir: Optional[str] = None,
    skip_loading_weights: bool = False,
    tiny: bool = False,
    seed: int = 42,
    bits: int = 16,
    act_bits: int = 16,
    act_outlier_cols: int = 0,
    act_bwd_int8: bool = False,
    device: str = "cuda",
    mesh: Optional[Mesh] = None,
    visual_tokens: Optional[int] = None,
    fused_attention: bool = True,
):
    """(cfg, model, mesh) on ``device``.  A ``model_dir``: the checkpoint there
    (``models/loader.load_llava_checkpoint``; its configuration from its
    ``config.json``, the vision tower from ``vision_dir`` when the
    directory lacks it).  ``tiny``: the tiny random model;
    ``skip_loading_weights`` (or no ``model_dir``): random weights at the
    configuration of ``model_dir``'s ``config.json`` (LLaVA-1.5-7B without
    one), drawn from ``seed``.  ``bits`` 8 / 4: the QLoRA base (int8 / int4
    block linears; the full-size random branch draws it straight into
    quantized form, and a model already quantized is not quantized again).
    ``act_bits`` 8 (with ``act_outlier_cols`` and ``act_bwd_int8``): the
    w8a8 mode of an int8 base.

    ``mesh``: this rank's place (``parallel/mesh.make_mesh``); the model
    goes to the mesh's device, cut to this rank's shard (random weights
    drawn as one process draws them; a checkpoint's decoder weights read
    from the memory-mapped files one at a time, each moved, quantized
    whole and cut before the next).  Without one: the ``1 x 1`` mesh of
    ``device``.

    ``visual_tokens`` K >= 1: training-free visual-token pruning (the
    weights are unchanged; ``cfg.num_patches`` becomes min(K, 576)).

    ``fused_attention`` False: see ``check_fused_attention``."""
    check_fused_attention(fused_attention,
                          mesh.device if mesh is not None else device)
    if bits not in (16, 8, 4):
        raise ValueError(f"bits={bits} unsupported (16, 8 or 4)")
    if act_bits not in (16, 8):
        raise ValueError(f"act_bits={act_bits} unsupported (16 or 8)")
    if act_bits == 8 and bits != 8:
        raise ValueError("act_bits=8 requires bits=8")
    if visual_tokens is not None and int(visual_tokens) < 1:
        raise ValueError(f"visual_tokens must be >= 1, got {visual_tokens}")
    mode = quant.QuantMode(act_bits, act_outlier_cols if act_bits == 8 else 0,
                           act_bwd_int8 and act_bits == 8)
    mesh = mesh or single_mesh(device)
    dev = mesh.device
    tp = (mesh.model_rank, mesh.model) if mesh.model > 1 else None
    gen = torch.Generator(device=dev).manual_seed(seed)
    cut = False
    if tiny:
        cfg = LlavaConfig.tiny()
        model = llava_model.init_params(cfg, gen, dev)
    elif skip_loading_weights or model_dir is None:
        cfg = (llava_config_from_hf(model_dir) if model_dir
               else LlavaConfig.llava_7b())
        if bits in (8, 4) or tp is not None:
            model = llava_model.init_params_quantized(cfg, gen, bits, dev,
                                                      mode, tp)
            cut = tp is not None
        else:
            model = llava_model.init_params(cfg, gen, dev)
    else:
        cfg = llava_config_from_hf(model_dir)
        if tp is None:
            model = load_llava_checkpoint(model_dir, cfg, vision_dir, dev)
        else:
            model = _load_cut(model_dir, cfg, vision_dir, dev, bits, mode,
                              tp)
            cut = True
    if visual_tokens is not None:
        cfg = dataclasses.replace(cfg, visual_tokens=int(visual_tokens))
        model.cfg = cfg
    if bits in (8, 4):
        # the linears not yet quantized (all of them, or a cut decoder's
        # vision tower)
        quant.quantize_params(model, bits=bits, mode=mode)
    quant.set_quant_mode(model, mode)
    sharding.shard_module(model, mesh, weights_done=cut)
    return cfg, model, mesh


def check_fused_attention(fused_attention: bool, device) -> None:
    """The drivers' ``fused_attention`` key.  In the JAX package false
    selects the unfused XLA attention; the port's attention on a CUDA
    device is always its kernels (#1-#5), so false raises there rather
    than run them all the same, and is accepted on the CPU, where the port
    runs the plain attention anyway."""
    if not fused_attention and torch.device(device).type == "cuda":
        raise ValueError(
            "fused_attention=false: the port's attention on a CUDA device "
            "is always its kernels; set fused_attention: true, or run on "
            "the CPU (device: cpu), which runs the plain attention")


def _load_cut(model_dir, cfg, vision_dir, dev, bits, mode, tp) -> Llava:
    """A checkpoint whose decoder block linears and lm_head are read one
    at a time from the memory-mapped files, moved to ``dev``, quantized
    whole (the block linears at ``bits`` 8 / 4) and cut to model rank
    ``tp[0]``'s shard of ``tp[1]`` before the next one is read."""

    @torch.no_grad()
    def linear(owner, name, weight):
        lin = getattr(owner, name)
        w = weight.to(dev).to(lin.weight.dtype)
        if bits in (8, 4) and name != "lm_head":
            setattr(owner, name, quant.QuantLinear.from_weight(w, bits,
                                                              mode=mode))
        else:
            lin.weight = torch.nn.Parameter(w, requires_grad=False)
        sharding.shard_linear(owner, name, *tp)

    return load_llava_checkpoint(model_dir, cfg, vision_dir, dev, linear)


def batch_to_device(batch: dict, dev: torch.device) -> dict:
    """The numpy arrays of a collated host batch as tensors on ``dev``
    (its other entries, such as text lists, dropped)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items() if isinstance(v, np.ndarray)}


@dataclasses.dataclass
class StepTimer:
    """Per-step wall-clock records, named (``rollout``, ``train``) with any
    counters beside them, and their means by name."""

    history: list = dataclasses.field(default_factory=list)

    def record(self, name: str, seconds: float, **counters):
        entry = {"name": name, "seconds": seconds, **counters}
        self.history.append(entry)
        return entry

    def summary(self) -> dict:
        agg = collections.defaultdict(list)
        for e in self.history:
            agg[e["name"]].append(e["seconds"])
        return {k: {"mean_s": float(np.mean(v)), "count": len(v)}
                for k, v in agg.items()}


_PROFILER: Optional[tuple] = None      # (profile, trace path) while open


def maybe_start_profiler(output_dir: str, step: int, start_step: int = 5,
                         num_steps: int = 3) -> bool:
    """The trace hook, called after each step's work: a
    ``torch.profiler.profile`` (CPU, and CUDA where there is a card)
    started at ``start_step`` and stopped at ``start_step + num_steps``,
    so the steps between are traced, written as a Chrome trace under
    ``output_dir/profile/``.  -> whether it started one.  A run that ends
    while the trace is open calls ``stop_profiler``, or the trace is
    lost."""
    global _PROFILER
    if step == start_step:
        stop_profiler()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        path = os.path.join(output_dir, "profile", f"steps_{step + 1}-"
                            f"{step + num_steps}_pid{os.getpid()}.json")
        _PROFILER = (prof, path)
        return True
    if step == start_step + num_steps:
        stop_profiler()
    return False


def stop_profiler() -> Optional[str]:
    """Stop the open trace, if any, and write it -> its path (None when
    none was open).  The trace carries the steps' spans
    (``utils/trace.py``); their store is emptied with it."""
    global _PROFILER
    if _PROFILER is None:
        return None
    (prof, path), _PROFILER = _PROFILER, None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    trace.clear()
    return path
