"""Weights, adapters and batches carried between the JAX package's trees
and the port.

The JAX trees stack layers on a leading axis and store dense weights
``[in, out]`` (``opadpo_tpu/models/llama.py:init_params``,
``clip.py:init_params``); torch ``Linear`` stores ``[out, in]``, one module
per layer.  The trees arrive with numpy leaves (``np.asarray`` of each JAX
array, bf16 included), so this module needs neither JAX nor the JAX package.

Quantized base weights cross over too: a ``{"q": int8 [L, K, N], "scale":
[L, 1, N]}`` or ``{"q4": int8 [L, K/2, N], "scale": [L, K/g, N]}`` leaf of
the decoder's or the vision tower's block linears becomes a
``QuantLinear`` in the port's layout (``ops/quant.py``: codes ``[N, K]`` or
``[N, K/2]``, scales ``[N]`` or ``[N, K/g]``), the same codes transposed.
"""

from __future__ import annotations

import numpy as np
import torch

from opadpo_torch.device import resolve_device
from opadpo_torch.models.llava import Llava, LlavaConfig, empty_model
from opadpo_torch.ops.quant import QuantLinear


def _np(leaf) -> np.ndarray:
    if isinstance(leaf, dict):
        raise ValueError("a quantized leaf where the port keeps the weight "
                         "in its own dtype (only the block linears of the "
                         "decoder and the vision tower are quantized)")
    return np.asarray(leaf, dtype=np.float32)


def _layer_leaf(leaf):
    """A stacked leaf as numpy: a quantized dict keeps its arrays' dtypes,
    any other leaf is f32."""
    if isinstance(leaf, dict):
        return {k: np.asarray(v) for k, v in leaf.items()}
    return _np(leaf)


def _set_linear(owner, name: str, leaf, i: int, bias=None) -> None:
    """Layer ``i`` of a stacked ``[L, in, out]`` leaf (or a quantized one)
    into ``owner.<name>``: copied into the ``nn.Linear``, or a
    ``QuantLinear`` in its place (with ``bias`` in the model dtype)."""
    lin = getattr(owner, name)
    if not isinstance(leaf, dict):
        _copy(lin.weight, leaf[i], transpose=True)
        if bias is not None:
            _copy(lin.bias, bias)
        return
    dev = lin.weight.device
    bits = 4 if "q4" in leaf else 8
    q = np.ascontiguousarray(leaf["q4" if bits == 4 else "q"][i].T)
    scale = leaf["scale"][i]
    scale = np.ascontiguousarray(scale.T if bits == 4 else scale[0])
    b = None
    if bias is not None:
        b = torch.tensor(_np(bias), dtype=lin.bias.dtype, device=dev)
    qlin = QuantLinear(torch.tensor(q.astype(np.int8), device=dev),
                       torch.tensor(scale.astype(np.float32), device=dev),
                       bits, b)
    if (qlin.out_features, qlin.in_features) != tuple(lin.weight.shape):
        raise ValueError(f"quantized shape {tuple(q.shape)} for a "
                         f"{tuple(lin.weight.shape)} slot")
    setattr(owner, name, qlin)


def _copy(dst: torch.Tensor, leaf, transpose: bool = False) -> None:
    arr = _np(leaf)
    if transpose:
        arr = arr.T
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"shape {arr.shape} for a {tuple(dst.shape)} slot")
    dst.copy_(torch.tensor(arr))


@torch.no_grad()
def llava_from_jax(params_np: dict, cfg: LlavaConfig,
                   device="cuda") -> Llava:
    """JAX LLaVA params (stacked layers, numpy leaves) -> ``Llava`` on
    ``device``, weights in ``cfg``'s dtypes (norms stay f32)."""
    model = empty_model(cfg, resolve_device(device))

    vp, vis = params_np["vision"], model.vision
    _copy(vis.patch_embed.weight, vp["patch_embed"], transpose=True)
    _copy(vis.class_embed, vp["class_embed"])
    _copy(vis.pos_embed, vp["pos_embed"])
    _copy(vis.pre_norm.weight, vp["pre_norm"]["scale"])
    _copy(vis.pre_norm.bias, vp["pre_norm"]["bias"])
    vl = {k: _layer_leaf(v) for k, v in vp["layers"].items()}
    for i, blk in enumerate(vis.layers):
        for ln in ("ln1", "ln2"):
            _copy(getattr(blk, ln).weight, vl[f"{ln}_scale"][i])
            _copy(getattr(blk, ln).bias, vl[f"{ln}_bias"][i])
        for w, bias in (("wq", "bq"), ("wk", "bk"), ("wv", "bv"),
                        ("wo", "bo"), ("fc1", "b_fc1"), ("fc2", "b_fc2")):
            _set_linear(blk, w, vl[w], i, vl[bias][i])

    pp, proj = params_np["projector"], model.projector
    _copy(proj.fc1.weight, pp["fc1"], transpose=True)
    _copy(proj.fc1.bias, pp["b1"])
    _copy(proj.fc2.weight, pp["fc2"], transpose=True)
    _copy(proj.fc2.bias, pp["b2"])

    lp, lm = params_np["llama"], model.llama
    _copy(lm.embed, lp["embed"])
    _copy(lm.final_norm, lp["final_norm"])
    _copy(lm.lm_head.weight, lp["lm_head"], transpose=True)
    ll = {k: _layer_leaf(v) for k, v in lp["layers"].items()}
    for i, layer in enumerate(lm.layers):
        _copy(layer.attn_norm, ll["attn_norm"][i])
        _copy(layer.mlp_norm, ll["mlp_norm"][i])
        for w in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            _set_linear(layer, w, ll[w], i)
    return model


def _torch_dtype(leaf) -> torch.dtype:
    name = str(np.asarray(leaf).dtype)
    return {"bfloat16": torch.bfloat16, "float16": torch.float16,
            "float32": torch.float32}[name]


def _entry(a, b, dtype, device) -> dict:
    """JAX ``{"a": [in, r], "b": [r, out]}`` -> Linear layout
    ``{"a": [r, in], "b": [out, r]}``."""
    def t(x):
        return torch.tensor(_np(x).T, device=device, dtype=dtype)
    return {"a": t(a), "b": t(b)}


def lora_from_jax(lora_np: dict, device="cuda") -> dict:
    """JAX adapter tree (stacked ``layers`` entries, optional ``lm_head``,
    ``vision`` and ``projector`` parts) -> the port's adapter tree, with
    ``layers`` as a per-layer list.  Factor dtypes are kept."""
    dev = resolve_device(device)
    out: dict = {}
    for part, sub in lora_np.items():
        conv: dict = {}
        for name, node in sub.items():
            if name == "layers":
                n = next(iter(node.values()))["a"].shape[0]
                conv["layers"] = [
                    {w: _entry(_np(e["a"])[i], _np(e["b"])[i],
                               _torch_dtype(e["a"]), dev)
                     for w, e in node.items()}
                    for i in range(n)]
            else:
                conv[name] = _entry(node["a"], node["b"],
                                    _torch_dtype(node["a"]), dev)
        out[part] = conv
    return out


def lora_to_jax(lora: dict) -> dict:
    """The port's adapter tree -> the JAX package's layout as numpy f32:
    ``{"a": [in, r], "b": [r, out]}`` entries, per-layer entries stacked
    on a leading axis under ``layers``."""
    def entry(e):
        return {k: e[k].detach().float().cpu().numpy().T for k in ("a", "b")}

    out: dict = {}
    for part, sub in lora.items():
        conv: dict = {}
        for name, node in sub.items():
            if name == "layers":
                per = [{w: entry(e) for w, e in layer.items()}
                       for layer in node]
                conv["layers"] = {
                    w: {k: np.stack([p[w][k] for p in per]) for k in ("a", "b")}
                    for w in per[0]}
            else:
                conv[name] = entry(node)
        out[part] = conv
    return out


def tensors_from_jax(arrays: dict, device="cuda") -> dict:
    """A flat dict of JAX (or numpy) arrays, such as a rollout batch, ->
    tensors on ``device``: integers as int64, floats as f32."""
    dev = resolve_device(device)
    out = {}
    for key, value in arrays.items():
        arr = np.asarray(value)
        dtype = np.int64 if np.issubdtype(arr.dtype, np.integer) \
            else np.float32
        out[key] = torch.from_numpy(arr.astype(dtype)).to(dev)
    return out
