"""Image-side ops, port of ``opadpo_tpu/ops/image_ops.py``: CLIP
normalisation, the device-side preprocess and the exact-count CoPO masks.

- ``random``: int(H*W*ratio) random pixels of each image -> the image mean;
- ``blockwise``: int(num_blocks*ratio) random 14x14 blocks -> the mean;
- ``attention``: pixels kept, int(P*ratio) random patches masked out of the
  attention instead.

Draws come from an explicit ``torch.Generator``; its stream differs from
JAX's, so only the counts and shapes of the masks are comparable across the
two packages.

``preprocess_images_device`` computes what ``jax.image.resize(...,
"bicubic")`` computes after the square padding: per axis a dense weight
matrix of the Keys cubic (a = -0.5), widened when downsampling
(antialias), applied as two f32 products.  ``F.interpolate``'s bicubic is
a = -0.75 without antialias, a different function.
"""

from __future__ import annotations

import torch

# HF CLIPImageProcessor constants (openai/clip-vit-large-patch14-336)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] float in [0, 1] -> CLIP-normalised."""
    mean = torch.tensor(CLIP_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(CLIP_STD, dtype=images.dtype, device=images.device)
    return (images - mean) / std


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """The Keys cubic kernel (a = -0.5) at distances ``x`` >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def resize_weights(in_size: int, out_size: int, device="cpu"
                   ) -> torch.Tensor:
    """f32 [in_size, out_size] weights of one axis of an antialiased
    bicubic resize, as ``jax._src.image.scale.compute_weight_mat`` builds
    them: the kernel widened by max(1 / scale, 1), each output's weights
    divided by their sum (zero where that sum is <= 1000 eps), and outputs
    whose sample falls outside [-0.5, in_size - 0.5] zero."""
    f32 = torch.float32
    # the scale's inverse in double, then f32, as JAX takes a Python scale
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=f32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(out_size, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=f32)[:, None]).abs()
    w = _keys_cubic(x / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    eps = torch.finfo(f32).eps
    w = torch.where(total.abs() > 1000.0 * eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(device)


def preprocess_images_device(images: torch.Tensor,
                             out_size: int = 336) -> torch.Tensor:
    """[B, H, W, 3] uint8 or float in [0, 255], on any device -> CLIP-
    normalised f32 [B, out_size, out_size, 3] on that device: padded to a
    square on the CLIP-mean background (the image at ((side - h) // 2,
    (side - w) // 2)), resized by the antialiased bicubic, clipped to [0,
    255] and normalised.  The products run in f32 with TF32 off."""
    b, h, w, c = images.shape
    dev = images.device
    side = max(h, w)
    bg = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=dev) * 255.0
    x = bg.expand(b, side, side, c).clone()
    off_y, off_x = (side - h) // 2, (side - w) // 2
    x[:, off_y:off_y + h, off_x:off_x + w] = images.to(torch.float32)
    if side != out_size:
        weights = resize_weights(side, out_size, dev)
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            x = torch.einsum("bhwc,hH->bHwc", x, weights)
            x = torch.einsum("bHwc,wW->bHWc", x, weights)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
    x = torch.clamp(x, 0.0, 255.0) / 255.0
    return normalize_images(x)


def _exact_count_mask(generator: torch.Generator, rows: int, n: int,
                      count: int, device) -> torch.Tensor:
    """Boolean [rows, n], exactly ``count`` True per row, uniformly at
    random: the ``count`` smallest of n uniform draws."""
    if count <= 0:
        return torch.zeros((rows, n), dtype=torch.bool, device=device)
    noise = torch.rand((rows, n), generator=generator,
                       device=generator.device).to(device)
    threshold = torch.sort(noise, dim=1).values[:, count - 1:count]
    return noise <= threshold


def mask_images_random(generator: torch.Generator, images: torch.Tensor,
                       ratio: float) -> torch.Tensor:
    """Per image: int(H*W*ratio) random pixels -> the image's mean value
    (all channels share the pixel selection and the scalar mean)."""
    b, h, w, _ = images.shape
    m = _exact_count_mask(generator, b, h * w, int(h * w * ratio),
                          images.device).reshape(b, h, w, 1)
    mean = images.mean(dim=(1, 2, 3), keepdim=True)
    return torch.where(m, mean, images)


def mask_images_blockwise(generator: torch.Generator, images: torch.Tensor,
                          ratio: float, block_size: int = 14) -> torch.Tensor:
    """Per image: int(num_blocks*ratio) random ``block_size`` blocks -> the
    image's mean value."""
    b, h, w, c = images.shape
    hb, wb = h // block_size, w // block_size
    m = _exact_count_mask(generator, b, hb * wb, int(hb * wb * ratio),
                          images.device).reshape(b, hb, 1, wb, 1, 1)
    m = m.expand(b, hb, block_size, wb, block_size, c).reshape(b, h, w, c)
    mean = images.mean(dim=(1, 2, 3), keepdim=True)
    return torch.where(m, mean, images)


def mask_patches_per_row(generator: torch.Generator, batch: int,
                         num_patches: int, ratio: float,
                         device="cpu") -> torch.Tensor:
    """int32 [B, num_patches] validity mask with exactly
    int(num_patches*ratio) zeros per row."""
    m = _exact_count_mask(generator, batch, num_patches,
                          int(num_patches * ratio), device)
    return (~m).to(torch.int32)
