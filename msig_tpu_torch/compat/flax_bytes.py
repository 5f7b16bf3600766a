"""``flax.serialization.to_bytes`` / ``from_bytes`` for trees of arrays, without flax.

The root ``inference.py`` reads ``--mapping_params`` with
``flax.serialization.from_bytes``; the port reads and writes the same files
with neither flax nor msgpack installed. This is the subset of flax's format
that such a file holds (flax 0.12, ``flax/serialization.py``):

  - msgpack, written as ``msgpack.packb(tree, use_bin_type=True,
    strict_types=True)`` writes it: each value in its smallest encoding,
    doubles for floats, ``str`` as str, ``bytes`` as bin;
  - maps with string keys (flax's state dict of a nested dict), strings,
    ints, floats, bools and None;
  - every numpy array as ext type 1, whose data is itself msgpack: the array
    ``(shape, dtype name, C-order bytes)``; a numpy scalar as ext type 3, the
    same triple of a 0-d array.

Flax cuts arrays over 2**30 bytes into chunks; a mapping network's are far
below that, and such a tree is refused here.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
MAX_CHUNK_SIZE = 2**30  # flax's limit for an array leaf written whole


# ------------------------------------------------------------------ writing

def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out += struct.pack("B", n)
    elif -0x20 <= n < 0:
        out += struct.pack("b", n)
    elif 0x80 <= n <= 0xFF:
        out += struct.pack(">BB", 0xCC, n)
    elif -0x80 <= n < 0:
        out += struct.pack(">Bb", 0xD0, n)
    elif 0xFF < n <= 0xFFFF:
        out += struct.pack(">BH", 0xCD, n)
    elif -0x8000 <= n < -0x80:
        out += struct.pack(">Bh", 0xD1, n)
    elif 0xFFFF < n <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xCE, n)
    elif -0x80000000 <= n < -0x8000:
        out += struct.pack(">Bi", 0xD2, n)
    elif 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        out += struct.pack(">BQ", 0xCF, n)
    elif -0x8000000000000000 <= n < -0x80000000:
        out += struct.pack(">Bq", 0xD3, n)
    else:
        raise OverflowError(f"integer {n} does not fit msgpack")


def _pack_header(n: int, fix: int, fix_max: int, sized, out: bytearray) -> None:
    """A str / array / map header: ``fix | n`` below ``fix_max``, else the first
    ``(code, struct format, largest length)`` of ``sized`` that holds ``n``."""
    if n < fix_max:
        out += struct.pack("B", fix | n)
        return
    for code, fmt, limit in sized:
        if n <= limit:
            out += struct.pack(fmt, code, n)
            return
    raise ValueError(f"length {n} does not fit msgpack")


_STR_SIZES = ((0xD9, ">BB", 0xFF), (0xDA, ">BH", 0xFFFF), (0xDB, ">BI", 0xFFFFFFFF))
_ARRAY_SIZES = ((0xDC, ">BH", 0xFFFF), (0xDD, ">BI", 0xFFFFFFFF))
_MAP_SIZES = ((0xDE, ">BH", 0xFFFF), (0xDF, ">BI", 0xFFFFFFFF))


def _pack_bin(b: bytes, out: bytearray) -> None:
    n = len(b)
    if n <= 0xFF:
        out += struct.pack(">BB", 0xC4, n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", 0xC5, n)
    else:
        out += struct.pack(">BI", 0xC6, n)
    out += b


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out += struct.pack(">Bb", fixed[n], code)
    elif n <= 0xFF:
        out += struct.pack(">BBb", 0xC7, n, code)
    elif n <= 0xFFFF:
        out += struct.pack(">BHb", 0xC8, n, code)
    else:
        out += struct.pack(">BIb", 0xC9, n, code)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack of ``(shape, dtype name, C bytes)``."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    out = bytearray()
    _pack((tuple(arr.shape), arr.dtype.name, arr.tobytes("C")), out, strict=False)
    return bytes(out)


def _pack(obj: Any, out: bytearray, strict: bool = True) -> None:
    """``msgpack.packb(obj, use_bin_type=True, strict_types=strict)`` with flax's
    ``default`` for arrays; tuples are arrays only when not ``strict``, as in
    msgpack."""
    t = type(obj)
    if obj is None:
        out += b"\xc0"
    elif t is bool:
        out += b"\xc3" if obj else b"\xc2"
    elif t is int:
        _pack_int(obj, out)
    elif t is float:
        out += struct.pack(">Bd", 0xCB, obj)
    elif t is str:
        b = obj.encode("utf-8")
        _pack_header(len(b), 0xA0, 32, _STR_SIZES, out)
        out += b
    elif t is bytes:
        _pack_bin(obj, out)
    elif t is dict:
        _pack_header(len(obj), 0x80, 16, _MAP_SIZES, out)
        for k, v in obj.items():
            _pack(k, out, strict)
            _pack(v, out, strict)
    elif t is list or (t is tuple and not strict):
        _pack_header(len(obj), 0x90, 16, _ARRAY_SIZES, out)
        for v in obj:
            _pack(v, out, strict)
    elif isinstance(obj, np.ndarray):
        if obj.size * obj.dtype.itemsize > MAX_CHUNK_SIZE:
            raise ValueError("arrays over 2**30 bytes are chunked by flax; not supported here")
        _pack_ext(EXT_NDARRAY, _ndarray_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)), out)
    else:
        raise TypeError(f"cannot serialize {t.__name__}")


def _state_dict(tree: Any) -> Any:
    """flax's ``to_state_dict`` on nested dicts: string keys, in order."""
    if isinstance(tree, dict):
        keys = [str(k) for k in tree]
        if len(set(keys)) != len(keys):
            raise ValueError(f"dict keys without a unique string form: {list(tree)}")
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if hasattr(tree, "detach"):  # a torch tensor
        return tree.detach().cpu().numpy()
    return tree


def to_bytes(tree: Any) -> bytes:
    """The bytes ``flax.serialization.to_bytes(tree)`` gives for a nested dict of
    numpy arrays (torch tensors are taken as numpy arrays)."""
    out = bytearray()
    _pack(_state_dict(tree), out)
    return bytes(out)


# ------------------------------------------------------------------ reading

class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data, self.pos, self.raw = data, 0, raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == EXT_NPSCALAR:
            return _ndarray_from_bytes(data)[()]
        raise ValueError(f"unsupported msgpack ext type {code}")

    def value(self) -> Any:
        b = self.unpack("B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lens:
            return self.take(self.unpack(lens[b]))
        lens = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in lens:
            return self.str_(self.unpack(lens[b]))
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map_(self.unpack(">H" if b == 0xDE else ">I"))
        fixed = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixed:
            return self.ext(fixed[b])
        lens = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in lens:
            return self.ext(self.unpack(lens[b]))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map_(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = _Reader(data, raw=True).value()
    name = dtype_name.decode("ascii")
    if name == "bfloat16":
        raise ValueError("bfloat16 arrays need ml_dtypes; write the tree in float32")
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape, order="C")


def msgpack_restore(data: bytes) -> Any:
    """The tree of a flax msgpack file, arrays as numpy arrays."""
    r = _Reader(data, raw=False)
    tree = r.value()
    if r.pos != len(data):
        raise ValueError(f"{len(data) - r.pos} bytes after the msgpack object")
    return tree


def _restore(target: Any, state: Any, path: str) -> Any:
    if isinstance(target, dict):
        if not isinstance(state, dict):
            raise ValueError(f"{path or '/'}: the file holds {type(state).__name__}, not a dict")
        missing = {str(k) for k in target} - set(state)
        if missing:
            raise ValueError(f"the target dict keys and state dict keys do not match: target "
                             f"keys {sorted(missing)} are not in the file at {path or '/'}")
        return {k: _restore(v, state[str(k)], f"{path}/{k}") for k, v in target.items()}
    return state


def from_bytes(target: Any, data: bytes) -> Any:
    """``flax.serialization.from_bytes(target, data)`` for a nested dict ``target``:
    the file's tree, checked against the target's keys (flax's rule: every key
    of the target must be in the file) and given the target's structure."""
    return _restore(target, msgpack_restore(data), "")
