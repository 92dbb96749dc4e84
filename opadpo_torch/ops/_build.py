"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes`` (pointers
and the stream pass as ``c_void_p``).  The build runs on the first CUDA
call, never at import time, and compiles every source at once, one
``nvcc`` process each, in parallel.  Outputs go to
``build/opadpo_torch_kernels/<hash>/`` at the root of the checkout, keyed
by a hash of the sources and flags, so an edited kernel rebuilds and an
unchanged one loads at once.

The flash sources, ``int8_matmul.cu``, ``int4_matmul.cu``,
``decode_attention.cu`` and ``heads_layout.cu`` share ``csrc/hopper.cuh``
(mbarrier, bulk-copy, TMA and wgmma helpers, the quant matmuls' stage
ring), which the hash covers too.  All but ``decode_attention.cu`` encode
TMA tensor maps with the driver's ``cuTensorMapEncodeTiled``, taken from
``libcuda.so.1`` by ``dlopen``/``dlsym`` at the first call, so the
libraries link ``-ldl`` (after the source, so the linker keeps it), not
``-lcuda``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / \
    "opadpo_torch_kernels"
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "heads_layout.cu",
           "decode_attention.cu", "quant_matmul.cu", "int8_matmul.cu",
           "int4_matmul.cu")
# included by the sources, so hashed with them: an edited header rebuilds
HEADERS = ("hopper.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-ldl",)              # after the source on the command line

_lock = threading.Lock()
_libs: dict = {}
# what the last build did: {source: {"seconds": s, "ptxas": text}}
last_build: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the GPU")
    return path


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return build_dir() / ("lib" + name.replace(".cu", ".so"))


def build_all() -> dict:
    """Compile every source whose library is missing, all at once.
    Returns ``{source: seconds}`` for what was built."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in SOURCES:
        target = _lib_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / name),
               *LINK_FLAGS]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    built = {}
    failures = []
    for name, (proc, tmp, target, t0) in procs.items():
        text, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}:\n{text}")
            continue
        os.replace(tmp, target)
        built[name] = secs
        last_build[name] = {"seconds": secs, "ptxas": text}
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>``."""
    with _lock:
        if name not in _libs:
            if not _lib_path(name).exists():
                build_all()
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise if a C launcher returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
