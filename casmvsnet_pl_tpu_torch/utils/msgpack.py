"""The subset of msgpack that the JAX package's checkpoints are written in.

``casmvsnet_pl_tpu/utils/checkpoints.py::save_checkpoint`` writes a nested
dict with ``flax.serialization.msgpack_serialize``. The port imports
neither flax nor the ``msgpack`` package (the card's machine has no
``msgpack``), so it reads and writes that format itself:

  - maps, arrays, str, bin, ints, floats, bool and nil;
  - ext type 1, an ndarray: a msgpack array ``(shape, dtype name, C-order
    bytes)``; ext type 3, a numpy scalar, in the same form (read as a 0-d
    array's item, as flax reads it);
  - flax's chunked form of a leaf over ``2**30`` bytes: a map
    ``{"__msgpack_chunked_array__": True, "shape": {"0": n, ...},
    "chunks": {"0": flat array, ...}}``, joined back into one array.

Anything else (another ext type, a map key that is not a string, a
truncated buffer, bytes after the object, a dtype other than bool and
numbers) raises :class:`MsgpackError`, naming what was found and where.

:func:`serialize` writes the bytes ``msgpack_serialize`` writes for the
same tree (dict keys sorted, as its ``jax.tree_util`` copy sorts them).
"""
from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_BYTES = 2 ** 30


class MsgpackError(ValueError):
    """The bytes are not in the subset of msgpack that flax writes."""


# -- reading ----------------------------------------------------------------

_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
# first byte -> (struct format of the value or length, kind)
_SIZED = {
    0xCC: (">B", "int"), 0xCD: (">H", "int"), 0xCE: (">I", "int"),
    0xCF: (">Q", "int"), 0xD0: (">b", "int"), 0xD1: (">h", "int"),
    0xD2: (">i", "int"), 0xD3: (">q", "int"),
    0xCA: (">f", "float"), 0xCB: (">d", "float"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
    0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, buf, start: int, end: int):
        self.buf, self.pos, self.end = buf, start, end

    def take(self, n: int, what: str) -> int:
        """Advance over ``n`` bytes; returns where they start."""
        if self.pos + n > self.end:
            raise MsgpackError(f"truncated: {what} needs {n} bytes at offset "
                               f"{self.pos}, {self.end - self.pos} left")
        start = self.pos
        self.pos += n
        return start

    def unpack(self, fmt: str, what: str):
        start = self.take(struct.calcsize(fmt), what)
        return struct.unpack_from(fmt, self.buf, start)[0]

    def read(self) -> Any:
        at = self.take(1, "a type byte")
        b = self.buf[at]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, at)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b in _FIXED:
            return _FIXED[b]
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b], at)
        if b not in _SIZED:
            raise MsgpackError(f"unknown type byte 0x{b:02x} at offset {at}")
        fmt, kind = _SIZED[b]
        value = self.unpack(fmt, kind)
        if kind in ("int", "float"):
            return value
        if kind == "str":
            return self.str(value)
        if kind == "bin":
            start = self.take(value, "bin data")
            return bytes(self.buf[start:start + value])
        if kind == "array":
            return [self.read() for _ in range(value)]
        if kind == "map":
            return self.map(value, at)
        return self.ext(value, at)

    def str(self, n: int) -> str:
        start = self.take(n, "str data")
        try:
            return bytes(self.buf[start:start + n]).decode("utf-8")
        except UnicodeDecodeError as e:
            raise MsgpackError(f"str at offset {start} is not UTF-8: {e}") \
                from None

    def map(self, n: int, at: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            if not isinstance(key, (str, bytes)):
                raise MsgpackError(f"map at offset {at} has a key of type "
                                   f"{type(key).__name__}, not str")
            out[key] = self.read()
        return out

    def ext(self, n: int, at: int) -> Any:
        code = self.unpack(">b", "ext type")
        start = self.take(n, "ext data")
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise MsgpackError(f"ext type {code} at offset {at}: only 1 "
                               "(ndarray) and 3 (numpy scalar) are read")
        arr = _ndarray(self.buf, start, start + n)
        return arr[()] if code == EXT_NPSCALAR else arr


def _ndarray(buf, start: int, end: int) -> np.ndarray:
    """An ext payload ``(shape, dtype name, bytes)`` -> array (read-only,
    as flax's)."""
    inner = _Reader(buf, start, end)
    head = inner.read()
    if inner.pos != end:
        raise MsgpackError(f"ndarray at offset {start}: {end - inner.pos} "
                           "bytes after its (shape, dtype, data)")
    if (not isinstance(head, list) or len(head) != 3
            or not isinstance(head[0], list)
            or not all(isinstance(d, int) and d >= 0 for d in head[0])
            or not isinstance(head[1], (str, bytes))
            or not isinstance(head[2], bytes)):
        raise MsgpackError(f"ndarray at offset {start}: not (shape, dtype "
                           "name, bytes)")
    shape, name, data = head
    name = name.decode("ascii") if isinstance(name, bytes) else name
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise MsgpackError(f"ndarray at offset {start}: unknown dtype "
                           f"{name!r}") from None
    if dtype.kind not in "biufc":
        raise MsgpackError(f"ndarray at offset {start}: dtype {name!r} is "
                           "not bool or a number")
    count = int(np.prod(shape, dtype=np.int64))
    if len(data) != count * dtype.itemsize:
        raise MsgpackError(f"ndarray at offset {start}: {len(data)} bytes "
                           f"for shape {tuple(shape)} of {name}")
    return np.frombuffer(data, dtype=dtype).reshape(shape)


def unpackb(data: bytes) -> Any:
    """One msgpack object from ``data``, which it must fill exactly."""
    buf = memoryview(data).cast("B")
    reader = _Reader(buf, 0, len(buf))
    out = reader.read()
    if reader.pos != len(buf):
        raise MsgpackError(f"{len(buf) - reader.pos} bytes after the object "
                           f"(which ends at offset {reader.pos})")
    return out


def _unchunk(d: dict) -> np.ndarray:
    try:
        shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
        chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    except (KeyError, TypeError, ValueError) as e:
        raise MsgpackError(f"malformed chunked array: {e!r}") from None


def _unchunk_leaves(tree):
    """Chunked leaves joined, where flax's ``msgpack_restore`` joins them:
    the tree itself and the values of its maps, recursively."""
    if isinstance(tree, dict):
        if CHUNKED in tree:
            return _unchunk(tree)
        return {k: _unchunk_leaves(v) for k, v in tree.items()}
    return tree


def restore(data: bytes) -> Any:
    """The counterpart of ``flax.serialization.msgpack_restore``."""
    return _unchunk_leaves(unpackb(data))


# -- writing ----------------------------------------------------------------

def _pack_len(out: bytearray, n: int, fix: int | None, fix_max: int,
              codes: tuple) -> None:
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n <= 0xFF:
        out += struct.pack(">BB", codes[0], n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", codes[1], n)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise MsgpackError(f"length {n} beyond msgpack's 2**32 - 1")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif 0 <= v <= 0xFF:
        out += struct.pack(">BB", 0xCC, v)
    elif -0x80 <= v < 0:
        out += struct.pack(">Bb", 0xD0, v)
    elif 0 <= v <= 0xFFFF:
        out += struct.pack(">BH", 0xCD, v)
    elif -0x8000 <= v < 0:
        out += struct.pack(">Bh", 0xD1, v)
    elif 0 <= v <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xCE, v)
    elif -0x80000000 <= v < 0:
        out += struct.pack(">Bi", 0xD2, v)
    elif 0 <= v <= 0xFFFFFFFFFFFFFFFF:
        out += struct.pack(">BQ", 0xCF, v)
    elif -0x8000000000000000 <= v < 0:
        out += struct.pack(">Bq", 0xD3, v)
    else:
        raise MsgpackError(f"integer {v} does not fit in 64 bits")


def _pack_ext(out: bytearray, code: int, arr: np.ndarray) -> None:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise MsgpackError(f"cannot write an array of dtype {arr.dtype}")
    payload = bytearray()
    _pack((arr.shape, arr.dtype.name, arr.tobytes("C")), payload)
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += payload


def _pack(obj, out: bytearray) -> None:
    if isinstance(obj, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, obj)
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, np.asarray(obj))
    elif obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise MsgpackError(f"cannot write a {type(obj).__name__}")


def _chunk(arr: np.ndarray, max_chunk_bytes: int) -> dict:
    size = max(1, int(max_chunk_bytes / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _prepare(tree, max_chunk_bytes: int, chunk: bool = True):
    """Dict keys sorted; arrays over ``max_chunk_bytes`` chunked where
    flax chunks them: the tree itself and map values reached through maps
    only (never inside a list)."""
    if isinstance(tree, dict):
        return {k: _prepare(tree[k], max_chunk_bytes, chunk)
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_prepare(v, max_chunk_bytes, False) for v in tree)
    if (chunk and isinstance(tree, np.ndarray)
            and tree.size * tree.dtype.itemsize > max_chunk_bytes):
        return _chunk(tree, max_chunk_bytes)
    return tree


def serialize(tree, max_chunk_bytes: int = MAX_CHUNK_BYTES) -> bytes:
    """The counterpart of ``flax.serialization.msgpack_serialize``: nested
    dicts, lists and tuples of numpy arrays and scalars, Python numbers,
    strings, bytes, bool and None. ``max_chunk_bytes`` is flax's
    ``MAX_CHUNK_SIZE``."""
    out = bytearray()
    _pack(_prepare(tree, max_chunk_bytes), out)
    return bytes(out)
