"""ctypes bindings for the native (C++) data-loader core.

Counterpart of ``msig_tpu/data/native_loader.py``, with its API: ``available``,
``image_size``, ``decode_resize`` and ``load_batch`` over the library that
``native/msig_loader.cpp`` builds (JPEG/PNG decode, fused crop + bilinear
box-resize with PIL's BILINEAR semantics, k*90 rotation, threaded batches).

The library is built at first use with the flags of ``native/Makefile``
(``g++ -O3 -fPIC -std=c++17 -shared ... -ljpeg -lpng -lpthread``) into
``build/msig_loader/libmsig_loader-<hash>.so`` at the repository root, the hash
taken over the source and the flags; ``native/`` is never written. An
``fcntl`` lock on a file beside it and an atomic rename make concurrent first
uses (several processes, several threads) build it once between them.

Without a compiler, ``libjpeg`` or ``libpng``, ``available()`` is False and
the pipeline decodes with PIL instead, as the JAX package does; that is logged
once. Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "msig_loader.cpp"
BUILD_DIR = ROOT / "build" / "msig_loader"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LDLIBS = ("-ljpeg", "-lpng", "-lpthread")

_lib = None
_lib_lock = threading.Lock()
_load_failed = False


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(" ".join(CXXFLAGS + LDLIBS).encode())
    h.update(SOURCE.read_bytes())
    return Path(build_dir) / f"libmsig_loader-{h.hexdigest()[:16]}.so"


def _mtime(path: Path) -> Optional[int]:
    try:
        return path.stat().st_mtime_ns
    except FileNotFoundError:
        return None


def build_library(build_dir: Path = BUILD_DIR, stale: Optional[int] = None) -> Tuple[Path, bool]:
    """Build the library into ``build_dir`` unless it is there; returns
    (path, whether this call compiled it). ``stale`` (the modification time of
    a library that failed to load here, e.g. one built on another machine)
    rebuilds that file unless another caller already has. Raises
    ``RuntimeError`` when the compiler is missing or fails. Safe against
    concurrent callers: they take an ``fcntl`` lock in turn and the compiler
    writes a temporary file that is renamed into place."""
    out = library_path(build_dir)
    if _mtime(out) not in (None, stale):
        return out, False
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH")
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if _mtime(out) not in (None, stale):  # another caller built it meanwhile
                return out, False
            tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE), *LDLIBS]
            try:
                r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
                if r.returncode != 0:
                    why = next((ln.strip() for ln in r.stderr.splitlines()
                                if "error" in ln or "cannot" in ln),
                               r.stderr.strip()[-300:])
                    raise RuntimeError(f"g++ {SOURCE.name} exited {r.returncode}: {why}")
                os.replace(tmp, out)
            finally:
                tmp.unlink(missing_ok=True)
            return out, True
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _get_lib():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            path, built = build_library(BUILD_DIR)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError:
                if built:
                    raise
                # built elsewhere (a copied tree) against libraries this machine lacks
                path, _ = build_library(BUILD_DIR, stale=_mtime(path))
                lib = ctypes.CDLL(str(path))
        except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
            # no toolchain or image libraries: the PIL path takes over
            logger.warning("native loader unavailable (%s); decoding with PIL", e)
            _load_failed = True
            return None
        lib.msig_image_size.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.msig_image_size.restype = ctypes.c_int
        lib.msig_decode_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
        lib.msig_decode_resize.restype = ctypes.c_int
        lib.msig_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        lib.msig_load_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _get_lib() is not None


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) from the file header only."""
    lib = _get_lib()
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.msig_image_size(path.encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
        raise IOError(f"cannot read image header: {path}")
    return w.value, h.value


def decode_resize(path: str, out_size: int,
                  crop: Optional[Tuple[int, int, int, int]] = None,  # (top, left, h, w)
                  rot_k: int = 0) -> np.ndarray:
    """Decode, crop (the whole image by default), resize to ``out_size``² and
    rotate by ``rot_k`` x 90 degrees -> uint8 [out_size, out_size, 3]."""
    lib = _get_lib()
    out = np.empty((out_size, out_size, 3), np.uint8)
    top, left, ch, cw = crop if crop else (0, 0, -1, -1)
    rc = lib.msig_decode_resize(path.encode(), out_size, top, left, ch, cw, rot_k,
                                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise IOError(f"decode failed: {path}")
    return out


def load_batch(paths: Sequence[str], out_size: int,
               crops: Optional[Sequence[Tuple[int, int, int, int]]] = None,
               rots: Optional[Sequence[int]] = None, n_threads: int = 4) -> np.ndarray:
    """Threaded decode of a whole batch -> uint8 [N, S, S, 3]."""
    lib = _get_lib()
    n = len(paths)
    out = np.empty((n, out_size, out_size, 3), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    crops_np = rots_np = None  # kept referenced until the call returns
    crops_arr = rots_arr = None
    if crops is not None:
        crops_np = np.ascontiguousarray(np.asarray(crops, np.int32).reshape(n, 4))
        crops_arr = crops_np.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    if rots is not None:
        rots_np = np.ascontiguousarray(np.asarray(rots, np.int32).reshape(n))
        rots_arr = rots_np.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    failures = lib.msig_load_batch(arr, n, out_size, crops_arr, rots_arr,
                                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                   n_threads)
    if failures:
        raise IOError(f"{failures}/{n} images failed to decode")
    return out
