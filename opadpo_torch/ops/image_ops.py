"""Image-side ops, port of ``opadpo_tpu/ops/image_ops.py``: CLIP
normalisation and the exact-count CoPO masks.

- ``random``: int(H*W*ratio) random pixels of each image -> the image mean;
- ``blockwise``: int(num_blocks*ratio) random 14x14 blocks -> the mean;
- ``attention``: pixels kept, int(P*ratio) random patches masked out of the
  attention instead.

Draws come from an explicit ``torch.Generator``; its stream differs from
JAX's, so only the counts and shapes of the masks are comparable across the
two packages.
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
