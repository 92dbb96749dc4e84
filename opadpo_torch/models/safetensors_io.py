"""A reader and a writer of the safetensors format, on torch alone.

A file is an 8-byte little-endian header length, a JSON header mapping each
tensor's name to ``{"dtype", "shape", "data_offsets": [begin, end]}`` (an
optional ``"__metadata__"`` map of strings beside them), then the raw
little-endian buffers, the offsets counted from the end of the header.

The reader maps the file (``mmap``, copy-on-write) and builds each tensor
with ``torch.frombuffer`` in its own dtype, so a bf16 shard is never widened
on the host; the tensors share the mapping and keep it alive.  A directory
with a ``*.safetensors.index.json`` reads the files its ``weight_map``
names.  The port uses these functions on every machine: the ``safetensors``
package is not needed (the tests hold both directions against it).
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Optional

import torch

DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
          "F32": torch.float32, "F64": torch.float64, "I8": torch.int8,
          "U8": torch.uint8, "I16": torch.int16, "I32": torch.int32,
          "I64": torch.int64, "BOOL": torch.bool}
_NAMES = {v: k for k, v in DTYPES.items()}


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """name -> CPU tensor in the file's dtype, backed by a private mapping
    of the file (pages are read as the tensors are touched)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        size = os.fstat(f.fileno()).st_size
        buf = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
               if size > 8 + n else None)
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES[info["dtype"]]
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        count = 1
        for d in shape:
            count *= d
        if end - begin != count * torch.empty((), dtype=dtype).element_size():
            raise ValueError(f"{path}: {name} holds {end - begin} bytes for "
                             f"{info['dtype']} {list(shape)}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(buf, dtype=dtype, count=count,
                                     offset=base + begin).reshape(shape)
    return out


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (any device; written in their own dtypes, in name
    order) as one safetensors file; the header is padded with spaces to a
    multiple of 8 bytes, as the ``safetensors`` package pads it."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    names = sorted(tensors)
    for name in names:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in names:
            t = tensors[name].detach()
            if t.numel():
                flat = t.reshape(-1).contiguous().cpu().view(torch.uint8)
                f.write(memoryview(flat.numpy()))


def _index_files(checkpoint_dir: str) -> Optional[list]:
    """The shard files a ``*.safetensors.index.json`` in the directory
    names, in order, or None without one."""
    for name in sorted(os.listdir(checkpoint_dir)):
        if name.endswith(".safetensors.index.json"):
            with open(os.path.join(checkpoint_dir, name)) as f:
                weight_map = json.load(f)["weight_map"]
            return sorted(set(weight_map.values()))
    return None


def load_dir(checkpoint_dir: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a directory's safetensors files: those its index
    names when it has one, else every ``*.safetensors`` file."""
    files = _index_files(checkpoint_dir)
    if files is None:
        files = sorted(f for f in os.listdir(checkpoint_dir)
                       if f.endswith(".safetensors"))
    state: Dict[str, torch.Tensor] = {}
    for f in files:
        state.update(load_file(os.path.join(checkpoint_dir, f)))
    return state
