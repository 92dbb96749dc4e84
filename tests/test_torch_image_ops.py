"""The port's ``ops/image_ops.preprocess_images_device`` against the JAX
package's (``opadpo_tpu/ops/image_ops.py``: square padding on the CLIP
mean, ``jax.image.resize`` bicubic, normalisation) on the same pixels.

- against JAX: |diff| <= 1e-4 normalised units on uniform uint8 noise
  (the hardest input for the products' rounding), for square, portrait
  and landscape frames, an upscale (200 x 160 -> 336), a downscale
  (640 x 480 -> 336), a frame already 336 square, and float input;
- the weight matrix of each axis against
  ``jax._src.image.scale.compute_weight_mat`` with the Keys cubic, 1e-6;
- against the host path (PIL's ``clip_preprocess``) at the JAX test's
  bounds: mean |diff| < 0.05, 95th percentile < 0.2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from opadpo_tpu.ops import image_ops as jax_image_ops
from opadpo_torch.data.image_processing import clip_preprocess
from opadpo_torch.ops import image_ops

TOL = 1e-4


def _frames(hw, seed, b=2):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b, *hw, 3)).astype(np.uint8)


@pytest.mark.parametrize("hw", [
    (400, 400),      # square, downscale
    (480, 320),      # portrait
    (320, 480),      # landscape
    (160, 200),      # 200 x 160 (w x h), upscale
    (480, 640),      # 640 x 480 (w x h), downscale
    (200, 160),      # portrait upscale
    (336, 336),      # no resize
], ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_preprocess_images_device_matches_jax(hw):
    frames = _frames(hw, seed=sum(hw))
    ref = np.asarray(jax_image_ops.preprocess_images_device(
        jnp.asarray(frames), 336))
    out = image_ops.preprocess_images_device(torch.from_numpy(frames), 336)
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    assert tuple(out.shape) == (2, 336, 336, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=0)


def test_preprocess_images_device_float_input_and_other_size():
    frames = _frames((120, 90), seed=5).astype(np.float32) + 0.25
    ref = np.asarray(jax_image_ops.preprocess_images_device(
        jnp.asarray(frames), 224))
    out = image_ops.preprocess_images_device(torch.from_numpy(frames), 224)
    assert tuple(out.shape) == (2, 224, 224, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("n_in", [640, 480, 200, 160, 100])
def test_resize_weights_match_jax(n_in):
    from jax._src.image import scale as jax_scale

    ref = np.asarray(jax_scale.compute_weight_mat(
        n_in, 336, 336 / n_in, 0.0, jax_scale._fill_keys_cubic_kernel,
        True))
    got = image_ops.resize_weights(n_in, 336).numpy()
    assert got.shape == (n_in, 336)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_preprocess_images_device_close_to_host_path():
    rng = np.random.default_rng(3)
    base = rng.normal(size=(10, 12, 3))
    arr = np.kron(base, np.ones((20, 20, 1)))
    arr = ((arr - arr.min()) / (arr.max() - arr.min()) * 255).astype(
        np.uint8)
    host = clip_preprocess(Image.fromarray(arr), size=336)
    dev = image_ops.preprocess_images_device(
        torch.from_numpy(arr)[None], 336)[0].numpy()
    diff = np.abs(host - dev)
    assert diff.mean() < 0.05
    assert np.quantile(diff, 0.95) < 0.2
