"""ctypes binding of the native C++ image pipeline
(``opadpo_torch/csrc/image_pipeline.cpp``: libjpeg decode, expand2square,
bicubic resize and CLIP normalisation, a batch over OpenMP threads): port
of ``opadpo_tpu/data/native_image.py`` with the same API.

    from opadpo_torch.data.native_image import preprocess_jpeg_batch
    arrs = preprocess_jpeg_batch([jpeg_bytes, ...], out_size=336)

The library is built at first use with ``g++ -O3 -shared -fPIC -fopenmp
... -ljpeg`` into ``build/opadpo_torch_image/<hash>/`` at the root of the
checkout, keyed by a hash of the source and the flags, so an edited
source rebuilds; it never touches ``native/``, the JAX package's.  Where
there is no compiler or no libjpeg, and for an image that is not a JPEG
(PNG and others), the PIL path (``data/image_processing.clip_preprocess``)
answers instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / \
    "image_pipeline.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / \
    "opadpo_torch_image"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp", "-Wall")
LINK_FLAGS = ("-ljpeg",)            # after the source on the command line

_lib = None
_lib_lock = threading.Lock()
# why the library is unavailable (None: not tried yet, or built)
build_error: Optional[str] = None


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libopadpo_torch_image.so"


def _build(path: Path) -> None:
    """Compile the source into ``path`` (written under a name of this
    process first, then renamed, so that concurrent builds never load a
    half-written file)."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++)")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), *LINK_FLAGS, "-o",
                           str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed: {proc.stderr[-2000:]}")
    os.replace(tmp, path)


def _load_library() -> Optional[ctypes.CDLL]:
    global _lib, build_error
    if _lib is not None or build_error is not None:
        return _lib
    with _lib_lock:
        if _lib is not None or build_error is not None:
            return _lib
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            u8p, f32p = (ctypes.POINTER(ctypes.c_uint8),
                         ctypes.POINTER(ctypes.c_float))
            lib.opadpo_preprocess_rgb.restype = ctypes.c_int
            lib.opadpo_preprocess_rgb.argtypes = [
                u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p]
            lib.opadpo_preprocess_jpeg.restype = ctypes.c_int
            lib.opadpo_preprocess_jpeg.argtypes = [
                u8p, ctypes.c_size_t, ctypes.c_int, f32p]
            lib.opadpo_preprocess_jpeg_batch.restype = None
            lib.opadpo_preprocess_jpeg_batch.argtypes = [
                ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_size_t),
                ctypes.c_int, ctypes.c_int, f32p,
                ctypes.POINTER(ctypes.c_int)]
            _lib = lib
        except Exception as e:        # no toolchain, no libjpeg
            build_error = str(e)
            logger.warning("native image pipeline unavailable (%s); using "
                           "PIL", e)
        return _lib


def native_available() -> bool:
    """Whether the library is built and loaded (building it if need be)."""
    return _load_library() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def preprocess_rgb(rgb: np.ndarray, out_size: int = 336
                   ) -> Optional[np.ndarray]:
    """u8 [H, W, 3] -> normalised f32 [out, out, 3]; None without the
    library."""
    lib = _load_library()
    if lib is None:
        return None
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    out = np.empty((out_size, out_size, 3), np.float32)
    rc = lib.opadpo_preprocess_rgb(_u8p(rgb), h, w, out_size, _f32p(out))
    return out if rc == 0 else None


def preprocess_jpeg(data: bytes, out_size: int = 336
                    ) -> Optional[np.ndarray]:
    """One JPEG's bytes -> normalised f32 [out, out, 3]; None without the
    library or where libjpeg cannot decode them."""
    lib = _load_library()
    if lib is None or not _is_jpeg(data):
        return None
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((out_size, out_size, 3), np.float32)
    rc = lib.opadpo_preprocess_jpeg(_u8p(buf), len(data), out_size,
                                    _f32p(out))
    return out if rc == 0 else None


def _is_jpeg(data: bytes) -> bool:
    return len(data) > 3 and data[:3] == b"\xff\xd8\xff"


def preprocess_jpeg_batch(jpegs: List[bytes], out_size: int = 336
                          ) -> np.ndarray:
    """Encoded images -> f32 [N, out, out, 3]: the JPEGs in one call of the
    library (OpenMP over the batch), every other image, and a JPEG libjpeg
    cannot decode, through PIL."""
    lib = _load_library()
    outs = np.empty((len(jpegs), out_size, out_size, 3), np.float32)
    idx = ([i for i, d in enumerate(jpegs) if _is_jpeg(d)]
           if lib is not None else [])
    ok = set()
    if idx:
        bufs = [np.frombuffer(jpegs[i], np.uint8) for i in idx]
        ptrs = (ctypes.POINTER(ctypes.c_uint8) * len(idx))(
            *[_u8p(b) for b in bufs])
        lens = (ctypes.c_size_t * len(idx))(*[len(jpegs[i]) for i in idx])
        sub = np.empty((len(idx), out_size, out_size, 3), np.float32)
        statuses = (ctypes.c_int * len(idx))()
        lib.opadpo_preprocess_jpeg_batch(ptrs, lens, len(idx), out_size,
                                         _f32p(sub), statuses)
        for k, i in enumerate(idx):
            if statuses[k] == 0:
                outs[i] = sub[k]
                ok.add(i)
    for i, d in enumerate(jpegs):
        if i not in ok:
            outs[i] = _pil_one(d, out_size)
    return outs


def _pil_one(data: bytes, out_size: int) -> np.ndarray:
    from PIL import Image

    from opadpo_torch.data.image_processing import clip_preprocess
    return clip_preprocess(Image.open(io.BytesIO(data)), size=out_size)
