"""Host-side image preprocessing with HF CLIPImageProcessor numerics: port
of ``opadpo_tpu/data/image_processing.py``.

``preprocess_images`` sends JPEG bytes through the native C++ batch
pipeline (``data/native_image.py``: libjpeg and OpenMP, within a mean
|diff| of 0.02 normalised units of PIL, float separable bicubic against
Pillow's fixed point) and everything else (PNG, PIL objects, no native
library) through ``clip_preprocess``, the PIL path.  The PIL-only mode,
for strict HF-numerics parity, is ``set_pil_preprocess(True)``, the
drivers' ``--pil-preprocess``, or ``OPADPO_PIL_PREPROCESS=1``.

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
    return Image.open(io.BytesIO(_resolve_bytes(source, image_dir)))


_PIL_ONLY = bool(int(os.environ.get("OPADPO_PIL_PREPROCESS", "0")))


def set_pil_preprocess(flag: bool) -> None:
    """Force the PIL path everywhere (strict HF-numerics parity mode)."""
    global _PIL_ONLY
    _PIL_ONLY = bool(flag)


def _resolve_bytes(source, image_dir: Optional[str]) -> bytes:
    """The encoded bytes of raw bytes, a path (under image_dir) or a base64
    string, each file read once."""
    if isinstance(source, bytes):
        return source
    if isinstance(source, str):
        path = os.path.join(image_dir, source) if image_dir else source
        if os.path.exists(path):
            with open(path, "rb") as f:
                return f.read()
        return base64.b64decode(source.encode())
    raise TypeError(f"unsupported image source: {type(source)}")


def preprocess_images(sources, image_dir: Optional[str] = None,
                      size: int = CROP_SIZE,
                      pad_to_square: bool = True) -> np.ndarray:
    """Sources (paths / bytes / base64 / PIL) -> f32 [N, size, size, 3]:
    the JPEGs through one native batch call (unless PIL-only, or
    ``pad_to_square`` is off, or the library is unavailable), the rest
    one by one through ``clip_preprocess``."""
    out = np.empty((len(sources), size, size, 3), np.float32)
    # each source resolved once: paths, bytes and base64 to bytes, a PIL
    # image as it is
    enc = [_resolve_bytes(s, image_dir) if isinstance(s, (bytes, str))
           else s for s in sources]
    native_idx = []
    if not _PIL_ONLY and pad_to_square:
        from opadpo_torch.data.native_image import _is_jpeg, native_available
        if native_available():
            native_idx = [i for i, b in enumerate(enc)
                          if isinstance(b, bytes) and _is_jpeg(b)]
    if native_idx:
        from opadpo_torch.data.native_image import preprocess_jpeg_batch
        out[native_idx] = preprocess_jpeg_batch([enc[i] for i in native_idx],
                                                out_size=size)
    done = set(native_idx)
    for i, b in enumerate(enc):
        if i not in done:
            out[i] = clip_preprocess(load_image(b),
                                     pad_to_square=pad_to_square, size=size)
    return out


def preprocess_image(source, image_dir: Optional[str] = None,
                     size: int = CROP_SIZE,
                     pad_to_square: bool = True) -> np.ndarray:
    """One source (path / bytes / base64 / PIL) -> f32 [size, size, 3],
    dispatched as ``preprocess_images`` dispatches."""
    return preprocess_images([source], image_dir=image_dir, size=size,
                             pad_to_square=pad_to_square)[0]
