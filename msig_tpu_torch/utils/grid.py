"""Sample-grid rendering: labeled image grids as PNGs (PIL only).

Copy of ``msig_tpu/utils/grid.py``, after the reference's grid artifacts
(reference utils.py:9-68): shadowed white text labels drawn at (10, 10),
images arranged ``nrow`` per
row with 2px padding, values mapped from [-1, 1] to [0, 255]
(torchvision ``save_image(normalize=True, value_range=(-1,1))`` semantics).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw, ImageFont

_PAD = 2  # torchvision make_grid default padding


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1,1] float HWC -> uint8 HWC."""
    x = np.clip((np.asarray(img, np.float32) + 1.0) * 0.5, 0.0, 1.0)
    return (x * 255.0 + 0.5).astype(np.uint8)


def add_text_to_image(img_u8: np.ndarray, text: str) -> np.ndarray:
    """White text with a 1px black shadow at (10,10) (reference utils.py:9-41)."""
    pil = Image.fromarray(img_u8)
    draw = ImageDraw.Draw(pil)
    try:
        font = ImageFont.load_default(size=15)
    except (AttributeError, TypeError):
        font = ImageFont.load_default()
    x, y = 10, 10
    for dx, dy in ((-1, -1), (-1, 1), (1, -1), (1, 1)):
        draw.text((x + dx, y + dy), text, font=font, fill="black")
    draw.text((x, y), text, font=font, fill="white")
    return np.asarray(pil)


def save_sample_grid(
    samples: np.ndarray,
    path: str,
    nrow: int = 4,
    domain_names: Optional[Sequence[str]] = None,
) -> None:
    """Save [N,H,W,3] images in [-1,1] as a labeled grid PNG."""
    samples = np.asarray(samples)
    n, h, w, _ = samples.shape
    tiles = []
    for i in range(n):
        u8 = to_uint8(samples[i])
        if domain_names is not None and i < len(domain_names):
            u8 = add_text_to_image(u8, domain_names[i])
        tiles.append(u8)
    rows = (n + nrow - 1) // nrow
    grid = np.zeros(
        (rows * h + (rows + 1) * _PAD, nrow * w + (nrow + 1) * _PAD, 3), np.uint8
    )
    for i, tile in enumerate(tiles):
        r, c = divmod(i, nrow)
        top = _PAD + r * (h + _PAD)
        left = _PAD + c * (w + _PAD)
        grid[top : top + h, left : left + w] = tile
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(grid).save(path)


def save_image(img: np.ndarray, path: str) -> None:
    """Save one HWC image: [-1,1] float, or uint8 passed through unconverted
    (the serving engine converts on device — inference output,
    reference inference.py:293-299)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    img = np.asarray(img)
    u8 = img if img.dtype == np.uint8 else to_uint8(img)
    Image.fromarray(u8).save(path)
