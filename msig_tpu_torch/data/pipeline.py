"""Inference image decode (PIL).

Copy of ``msig_tpu/data/pipeline.py::load_inference_image`` with the PIL
backend only; the native loader is ported later.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def load_inference_image(path: str, size: int) -> np.ndarray:
    """Decode + Resize((size, size)) bilinear -> uint8 [size, size, 3]."""
    with Image.open(path) as img:
        img = img.convert("RGB").resize((size, size), Image.BILINEAR)
        return np.asarray(img, dtype=np.uint8)
