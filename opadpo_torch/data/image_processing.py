"""Host-side image preprocessing with HF CLIPImageProcessor numerics: copy
of the PIL path of ``opadpo_tpu/data/image_processing.py``.

PIL is imported inside the functions that decode images, so a server on a
machine without Pillow still answers requests that carry no image: their
black image is made with numpy alone (``black_image``).  Output is
channel-last float32 ``[H, W, 3]``.
"""

from __future__ import annotations

import base64
import io
import os
from typing import Optional, Tuple

import numpy as np

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
CROP_SIZE = 336


def _normalise(arr: np.ndarray) -> np.ndarray:
    arr = arr / 255.0
    mean = np.asarray(CLIP_MEAN, np.float32)
    std = np.asarray(CLIP_STD, np.float32)
    return (arr - mean) / std


def black_image(size: int = CROP_SIZE) -> np.ndarray:
    """The normalised black square, what ``clip_preprocess`` makes of
    ``Image.new("RGB", (size, size))``, without PIL."""
    return _normalise(np.zeros((size, size, 3), np.float32))


def expand2square(pil_img, background_color: Tuple[int, int, int]):
    """Pad to square with the CLIP mean colour."""
    from PIL import Image

    width, height = pil_img.size
    if width == height:
        return pil_img
    if width > height:
        result = Image.new(pil_img.mode, (width, width), background_color)
        result.paste(pil_img, (0, (width - height) // 2))
        return result
    result = Image.new(pil_img.mode, (height, height), background_color)
    result.paste(pil_img, ((height - width) // 2, 0))
    return result


def _resize_shortest_edge(img, target: int):
    from PIL import Image

    w, h = img.size
    short, long = (w, h) if w <= h else (h, w)
    if short == target:
        return img
    new_long = int(target * long / short)
    new_w, new_h = (target, new_long) if w <= h else (new_long, target)
    return img.resize((new_w, new_h), Image.BICUBIC)


def _center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top = (h - size) // 2
    left = (w - size) // 2
    return arr[top:top + size, left:left + size]


def clip_preprocess(img, pad_to_square: bool = True,
                    size: int = CROP_SIZE) -> np.ndarray:
    """PIL image -> normalised float32 [size, size, 3]."""
    img = img.convert("RGB")
    if pad_to_square:
        img = expand2square(img, tuple(int(x * 255) for x in CLIP_MEAN))
    img = _resize_shortest_edge(img, size)
    arr = _center_crop(np.asarray(img, np.float32), size)
    return _normalise(arr)


def load_image(source, image_dir: Optional[str] = None):
    """Open an image from a path (under image_dir), raw bytes, a base64
    string, or pass a PIL image through."""
    from PIL import Image

    if isinstance(source, Image.Image):
        return source
    if isinstance(source, bytes):
        return Image.open(io.BytesIO(source))
    if isinstance(source, str):
        path = os.path.join(image_dir, source) if image_dir else source
        if os.path.exists(path):
            return Image.open(path)
        return Image.open(io.BytesIO(base64.b64decode(source.encode())))
    raise TypeError(f"unsupported image source: {type(source)}")


def preprocess_images(sources, image_dir: Optional[str] = None,
                      size: int = CROP_SIZE,
                      pad_to_square: bool = True) -> np.ndarray:
    """Sources (paths / bytes / base64 / PIL) -> f32 [N, size, size, 3]."""
    out = np.empty((len(sources), size, size, 3), np.float32)
    for i, s in enumerate(sources):
        out[i] = clip_preprocess(load_image(s, image_dir),
                                 pad_to_square=pad_to_square, size=size)
    return out


def preprocess_image(source, image_dir: Optional[str] = None,
                     size: int = CROP_SIZE,
                     pad_to_square: bool = True) -> np.ndarray:
    """One source (path / bytes / base64 / PIL) -> f32 [size, size, 3]."""
    return clip_preprocess(load_image(source, image_dir),
                           pad_to_square=pad_to_square, size=size)
