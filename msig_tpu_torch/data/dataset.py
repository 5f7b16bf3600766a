"""Image listing and inference-domain discovery (host side).

Copies of ``msig_tpu/data/dataset.py::list_image_files`` and
``discover_inference_domains`` (reference dataset.py:58-64,
inference.py:188-204): the six glob patterns, concatenated then sorted;
domains are the sorted subdirectories, and target index = position + 1.
"""

from __future__ import annotations

import glob
import os
from typing import List

IMAGE_EXTENSIONS = ["*.jpg", "*.jpeg", "*.png", "*.JPG", "*.JPEG", "*.PNG"]


def list_image_files(directory: str) -> List[str]:
    files: List[str] = []
    for ext in IMAGE_EXTENSIONS:
        files.extend(glob.glob(os.path.join(directory, ext)))
    return sorted(files)


def discover_inference_domains(ref_domains_dir: str) -> List[str]:
    """Sorted subdir names; target idx = position + 1."""
    if not os.path.isdir(ref_domains_dir):
        raise ValueError(f"No such directory: {ref_domains_dir}")
    return sorted(
        d for d in os.listdir(ref_domains_dir)
        if os.path.isdir(os.path.join(ref_domains_dir, d))
    )
