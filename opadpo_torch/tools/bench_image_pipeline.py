"""The host image preprocess: the port's native JPEG pipeline
(``opadpo_torch/data/native_image.py``, libjpeg and OpenMP, built with g++
at first use) against PIL, on the two surfaces it serves.  Counterpart of
``scripts/bench_image_pipeline.py``; host only, no device.

    python -m opadpo_torch.tools.bench_image_pipeline [--images 64]
        [--size 640] [--out PATH]

1. the batch preprocess in front of the serving batch and the pool's
   admission (``preprocess_images``), ms an image;
2. rollout dataset rows (``QueryDataset.__getitem__``: the templated
   query and the image from base64 bytes), rows a second.

The JPEGs are the JAX script's (``make_jpegs``: smooth seeded content,
quality 90).  Times are the best of 3.  Where the native library cannot
build (no ``jpeglib.h``), the record says ``"native": null`` with the
reason, and times PIL alone.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import time

import numpy as np

from opadpo_torch.tools import common

TOOL = "bench_image_pipeline"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--images", type=int, default=64)
    ap.add_argument("--size", type=int, default=640,
                    help="source image edge (COCO-scale)")
    ap.add_argument("--out", default=None,
                    help=f"the JSON record (default build/tools/{TOOL}.json)")
    return ap.parse_args(argv)


def make_jpegs(n: int, hw: int, seed: int = 0) -> list:
    """``n`` seeded JPEGs of ``hw`` x ``hw``: smooth 16-pixel blocks, as
    the JAX script's ``make_jpegs``."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        base = rng.normal(size=(hw // 16, hw // 16, 3))
        arr = np.kron(base, np.ones((16, 16, 1)))
        arr = ((arr - arr.min()) / (arr.max() - arr.min() + 1e-9) * 255)
        buf = io.BytesIO()
        Image.fromarray(arr.astype(np.uint8)).save(buf, format="JPEG",
                                                   quality=90)
        out.append(buf.getvalue())
    return out


def best_of(fn, n: int = 3) -> float:
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def _both(fn, native: bool):
    """(native seconds or None, PIL seconds) of ``fn``, best of 3 each."""
    from opadpo_torch.data import image_processing as ip

    saved = ip._PIL_ONLY
    try:
        t_native = None
        if native:
            ip.set_pil_preprocess(False)
            fn()                                          # warm
            t_native = best_of(fn)
        ip.set_pil_preprocess(True)
        fn()
        t_pil = best_of(fn)
    finally:
        ip.set_pil_preprocess(saved)
    return t_native, t_pil


def run(args, model=None) -> dict:
    """The measurement -> the record (``model`` is not used: the pipeline
    runs on the host)."""
    from opadpo_torch.data import native_image
    from opadpo_torch.data.char_tokenizer import CharTokenizer
    from opadpo_torch.data.datasets import QueryDataset
    from opadpo_torch.data.image_processing import preprocess_images

    n = args.images
    jpegs = make_jpegs(n, args.size)
    native = native_image.native_available()
    rec = {"tool": TOOL, "images": n, "source_edge": args.size,
           "cores": os.cpu_count(),
           "native": ({"library": os.path.relpath(
               native_image.library_path(), common.REPO)}
               if native else None)}
    if not native:
        rec["native_reason"] = native_image.build_error or "not built"

    t_native, t_pil = _both(lambda: preprocess_images(jpegs, size=336),
                            native)
    rec["batch_preprocess"] = {"pil_ms_per_image": t_pil / n * 1e3}
    if native:
        rec["batch_preprocess"].update(
            native_ms_per_image=t_native / n * 1e3, speedup=t_pil / t_native)

    rows = [{"queries": f"<image>\nDescribe image {i}.",
             "image_bytes": base64.b64encode(j).decode(),
             "standard_response": "x", "image_id": f"img{i}.jpg"}
            for i, j in enumerate(jpegs)]
    qds = QueryDataset(rows, CharTokenizer(), query_len=128, image_size=336)

    def load_all():
        for i in range(len(qds)):
            qds[i]

    t_native, t_pil = _both(load_all, native)
    rec["rollout_rows"] = {"pil_rows_per_sec": n / t_pil}
    if native:
        rec["rollout_rows"].update(native_rows_per_sec=n / t_native,
                                   speedup=t_pil / t_native)
    return rec


def main(argv=None) -> int:
    args = parse_args(argv)
    rec = run(args)
    print(json.dumps(rec), flush=True)
    common.write_record(rec, args.out or common.default_out(TOOL))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
