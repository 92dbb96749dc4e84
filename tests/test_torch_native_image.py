"""The port's native JPEG pipeline (``opadpo_torch/data/native_image.py``
over its own ``csrc/image_pipeline.cpp``) and the dispatch of
``data/image_processing.preprocess_images``, against the JAX package's
pipeline on the same JPEG bytes.

- port native against JAX native: equal to 1e-6 (the same source and
  flags);
- port native against PIL: mean |diff| < 0.02 normalised units, the JAX
  package's bound (float separable bicubic against Pillow's fixed point);
- a PNG falls back to PIL (exactly ``clip_preprocess``);
- ``preprocess_images`` sends JPEG bytes, base64 and paths to the native
  batch and the rest to PIL, as the JAX dispatch does; the PIL-only
  switch sends everything to PIL;
- the library is built under ``build/``, never under ``native/``.

No timing assertion: a shared machine makes one flaky.
"""

import base64
import io
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from opadpo_tpu.data import image_processing as jax_ip
from opadpo_tpu.data import native_image as jax_native
from opadpo_torch.data import image_processing as ip
from opadpo_torch.data import native_image as native

ROOT = Path(__file__).resolve().parent.parent


def _image(seed, hw=(120, 160)):
    """A smooth random RGB image (JPEG loss stays small)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(hw[0] // 10, hw[1] // 10, 3))
    arr = np.kron(base, np.ones((10, 10, 1)))
    return ((arr - arr.min()) / (arr.max() - arr.min()) * 255).astype(
        np.uint8)


def _encode(arr, fmt, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt, **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def jpegs():
    return [_encode(_image(s, hw), "JPEG", quality=90)
            for s, hw in ((0, (120, 160)), (1, (200, 150)), (2, (96, 96)))]


@pytest.fixture(autouse=True)
def _native_mode():
    ip.set_pil_preprocess(False)
    yield
    ip.set_pil_preprocess(False)


def test_native_builds_under_build_not_native():
    """The library builds at first use into ``build/opadpo_torch_image/``
    and is never the JAX package's ``native/libopadpo_image.so``."""
    assert native.native_available(), native.build_error
    path = native.library_path()
    assert path.exists()
    assert path.is_relative_to(ROOT / "build" / "opadpo_torch_image")
    assert not path.is_relative_to(ROOT / "native")
    assert native.SOURCE == ROOT / "opadpo_torch" / "csrc" / \
        "image_pipeline.cpp"


@pytest.mark.parametrize("size", [336, 64])
def test_native_batch_matches_jax_native(jpegs, size):
    ours = native.preprocess_jpeg_batch(jpegs, out_size=size)
    want = jax_native.preprocess_jpeg_batch(jpegs, out_size=size)
    assert ours.shape == (len(jpegs), size, size, 3)
    np.testing.assert_allclose(ours, want, atol=1e-6, rtol=0)
    one = native.preprocess_jpeg(jpegs[1], out_size=size)
    np.testing.assert_allclose(one, want[1], atol=1e-6, rtol=0)


def test_native_rgb_matches_jax_native_and_pil():
    arr = _image(5, (90, 130))
    ours = native.preprocess_rgb(arr, out_size=336)
    np.testing.assert_allclose(ours, jax_native.preprocess_rgb(arr, 336),
                               atol=1e-6, rtol=0)
    ref = ip.clip_preprocess(Image.fromarray(arr), size=336)
    assert np.abs(ours - ref).mean() < 0.02


def test_native_within_pil_bound(jpegs):
    ours = native.preprocess_jpeg_batch(jpegs, out_size=336)
    for i, j in enumerate(jpegs):
        ref = ip.clip_preprocess(Image.open(io.BytesIO(j)), size=336)
        diff = np.abs(ours[i] - ref)
        assert diff.mean() < 0.02, (i, diff.mean())


def test_png_and_corrupt_jpeg_fall_back_to_pil(jpegs):
    arr = _image(7)
    png = _encode(arr, "PNG")
    bad = jpegs[0][:40]                        # a JPEG header, cut short
    out = native.preprocess_jpeg_batch([png, jpegs[0]], out_size=64)
    np.testing.assert_allclose(
        out[0], ip.clip_preprocess(Image.fromarray(arr), size=64), atol=1e-6)
    np.testing.assert_allclose(
        out[1], native.preprocess_jpeg_batch([jpegs[0]], out_size=64)[0],
        atol=0)
    assert native.preprocess_jpeg(png) is None
    # libjpeg refuses the cut file, so PIL is asked, and cannot read it
    assert native.preprocess_jpeg(bad) is None
    with pytest.raises(OSError):
        native.preprocess_jpeg_batch([bad], out_size=64)


def test_preprocess_images_dispatch_matches_jax(jpegs, tmp_path):
    """JPEG bytes, a JPEG path and base64 JPEG go native, a PNG and a PIL
    image go to PIL: the result equals the JAX ``preprocess_images`` on the
    same sources, and each entry equals its own path's output."""
    arr = _image(9)
    png = _encode(arr, "PNG")
    (tmp_path / "a.jpg").write_bytes(jpegs[1])
    sources = [jpegs[0], "a.jpg", base64.b64encode(jpegs[2]).decode(), png,
               Image.fromarray(arr)]
    out = ip.preprocess_images(sources, image_dir=str(tmp_path))
    want = jax_ip.preprocess_images(sources, image_dir=str(tmp_path))
    np.testing.assert_allclose(out, want, atol=1e-6, rtol=0)
    nat = native.preprocess_jpeg_batch(jpegs, out_size=336)
    np.testing.assert_array_equal(out[0], nat[0])
    np.testing.assert_array_equal(out[1], nat[1])
    np.testing.assert_array_equal(out[2], nat[2])
    pil = ip.clip_preprocess(Image.fromarray(arr))
    np.testing.assert_allclose(out[3], pil, atol=1e-6)
    np.testing.assert_allclose(out[4], pil, atol=1e-6)
    single = ip.preprocess_image(jpegs[0])
    np.testing.assert_array_equal(single, nat[0])
    # pad_to_square off takes PIL, as in the JAX dispatch
    flat = ip.preprocess_images([jpegs[0]], pad_to_square=False)
    np.testing.assert_allclose(
        flat[0], ip.clip_preprocess(Image.open(io.BytesIO(jpegs[0])),
                                    pad_to_square=False), atol=1e-6)


def test_pil_only_switch(jpegs, monkeypatch):
    """``set_pil_preprocess(True)`` sends JPEGs to PIL (and never builds or
    calls the library), as the JAX switch does; the environment variable
    sets it at import."""
    ip.set_pil_preprocess(True)
    monkeypatch.setattr(native, "preprocess_jpeg_batch", None)
    out = ip.preprocess_images(jpegs[:2])
    for i in range(2):
        ref = ip.clip_preprocess(Image.open(io.BytesIO(jpegs[i])))
        np.testing.assert_allclose(out[i], ref, atol=1e-6)
    jax_ip.set_pil_preprocess(True)
    try:
        np.testing.assert_allclose(out, jax_ip.preprocess_images(jpegs[:2]),
                                   atol=1e-6)
    finally:
        jax_ip.set_pil_preprocess(False)
    import subprocess
    import sys
    code = ("import opadpo_torch.data.image_processing as m; "
            "print(m._PIL_ONLY)")
    for value, want in (("1", "True"), ("0", "False")):
        got = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            cwd=str(ROOT), env={"OPADPO_PIL_PREPROCESS": value,
                                "PATH": "/usr/bin:/bin"})
        assert got.stdout.strip() == want, got.stderr


def test_cli_flags_set_the_pil_mode(monkeypatch):
    """``--pil-preprocess`` of the eval drivers sets the PIL-only mode when
    the model is set up (``load_for_eval``); without it the native path
    stays on."""
    from opadpo_torch.eval import model_vqa
    from opadpo_torch.pipeline import runtime
    monkeypatch.setattr(runtime, "setup_model",
                        lambda *a, **kw: (None, None, None))
    for flag, want in (([], False), (["--pil-preprocess"], True)):
        ip.set_pil_preprocess(False)
        args = model_vqa.parse_args(
            ["--model-path", "/m", "--question-file", "q", "--answers-file",
             "a", "--device", "cpu"] + flag)
        model_vqa.load_for_eval(args)
        assert ip._PIL_ONLY is want
