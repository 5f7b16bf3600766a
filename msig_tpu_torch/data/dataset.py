"""Dataset discovery and sampling semantics (host side).

Copies of ``msig_tpu/data/dataset.py`` (reference dataset.py):

  - file listing: the six glob patterns ``*.jpg *.jpeg *.png`` upper and
    lower case, concatenated then sorted (dataset.py:58-64);
  - target domains are the sorted subdirectories of the target root that
    hold at least one image; the source is domain 0, targets 1..N
    (dataset.py:29-48), and inference discovery agrees with it;
  - a sample couples ``source[index % len(source)]`` with a uniformly random
    target domain and a uniformly random file in it (dataset.py:66-88), drawn
    from an explicit ``numpy.random.Generator``;
  - epoch length ``max(len(source), max_d len(target_d))`` (dataset.py:90-92).
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, List, Tuple

import numpy as np

IMAGE_EXTENSIONS = ["*.jpg", "*.jpeg", "*.png", "*.JPG", "*.JPEG", "*.PNG"]


def list_image_files(directory: str) -> List[str]:
    files: List[str] = []
    for ext in IMAGE_EXTENSIONS:
        files.extend(glob.glob(os.path.join(directory, ext)))
    return sorted(files)


def discover_target_domains(target_root: str) -> List[Tuple[str, List[str]]]:
    """Sorted (domain_name, files) for each non-empty subdirectory."""
    if not os.path.isdir(target_root):
        return []
    out = []
    for name in sorted(
        d for d in os.listdir(target_root) if os.path.isdir(os.path.join(target_root, d))
    ):
        files = list_image_files(os.path.join(target_root, name))
        if files:
            out.append((name, files))
    return out


@dataclasses.dataclass
class MultiDomainDataset:
    """Source domain (index 0) + N target domains (indices 1..N)."""

    source_files: List[str]
    domains: List[str]  # ['source', <sorted target names>]
    domain_to_idx: Dict[str, int]
    target_files_by_domain: Dict[str, List[str]]

    @staticmethod
    def build(source_root: str, target_root: str) -> "MultiDomainDataset":
        source_files = list_image_files(source_root)
        domains = ["source"]
        domain_to_idx = {"source": 0}
        target_files: Dict[str, List[str]] = {}
        for name, files in discover_target_domains(target_root):
            domain_to_idx[name] = len(domains)
            domains.append(name)
            target_files[name] = files
        if len(domains) == 1:
            raise ValueError(f"No target domains found in {target_root}")
        return MultiDomainDataset(source_files, domains, domain_to_idx, target_files)

    @property
    def num_domains(self) -> int:
        return len(self.domains)

    @property
    def num_target_domains(self) -> int:
        return len(self.domains) - 1

    def __len__(self) -> int:
        return max(len(self.source_files),
                   max(len(f) for f in self.target_files_by_domain.values()))

    def sample_paths(self, index: int, rng: np.random.Generator) -> Tuple[str, str, int]:
        """(source_path, target_path, target_domain_idx) for one sample."""
        source_path = self.source_files[index % len(self.source_files)]
        names = list(self.target_files_by_domain.keys())
        domain_name = names[int(rng.integers(len(names)))]
        files = self.target_files_by_domain[domain_name]
        target_path = files[int(rng.integers(len(files)))]
        return source_path, target_path, self.domain_to_idx[domain_name]


def discover_inference_domains(ref_domains_dir: str) -> List[str]:
    """Sorted subdir names; target idx = position + 1."""
    if not os.path.isdir(ref_domains_dir):
        raise ValueError(f"No such directory: {ref_domains_dir}")
    return sorted(
        d for d in os.listdir(ref_domains_dir)
        if os.path.isdir(os.path.join(ref_domains_dir, d))
    )
