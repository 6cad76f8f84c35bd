"""Read and write the JAX package's model files: `flax.serialization`
msgpack, in plain Python and numpy (no `msgpack` package).

`grove_tpu.api.GroveForCausalLM.save_pretrained` writes a model directory
as `config.json` and `flax_model.msgpack`, the bytes of
`flax.serialization.to_bytes(params)`: msgpack maps of str keys down to
the leaves, each array an ext of type 1 whose payload is itself msgpack,
`(shape, dtype name, the C-order bytes)`; a numpy scalar is an ext 3 of the
same payload, a Python complex an ext 2 of `(real, imag)`; an array of
more than `MAX_CHUNK_SIZE` bytes is written as the map
`{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
"chunks": {"0": flat piece, ...}}`.

* `load(path)` reads a file through `mmap` (a copy-on-write map: the file
  is never written): each array is `np.frombuffer` over the map, so no
  leaf is copied on the host before the caller moves it (a chunked array
  is joined, a copy). bf16 arrays (dtype name `bfloat16`, which numpy
  lacks) come back as `torch.bfloat16` tensors over the same bytes; every
  other array is a numpy array. A truncated or malformed file raises
  ValueError naming the file and the byte offset.
* `dump(tree, f)` writes a nested dict whose leaves are numpy arrays or
  torch tensors (of any device: each is copied to the host just before it
  is written, one at a time), numpy scalars, str, bytes, int, float, bool
  or None: for a dict of numpy arrays and scalars, the bytes of
  `flax.serialization.to_bytes`. `save_jax_pretrained` writes a port
  model as the JAX package's model directory.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Any, BinaryIO, Dict

import numpy as np
import torch

from .convert import jax_tree_from_model

MAX_CHUNK_SIZE = 2 ** 30     # flax.serialization.MAX_CHUNK_SIZE
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
MODEL_FILE = "flax_model.msgpack"


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

# msgpack's type bytes beyond the fix ranges
_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
            0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I")}


class _Reader:
    """A recursive-descent msgpack parser over a buffer (bytes or an
    mmap), bounded by `end`."""

    def __init__(self, buf, name: str):
        self.buf = buf
        self.name = name
        self.pos = 0

    def fail(self, what: str, at: int):
        raise ValueError(f"{self.name}: {what} at byte {at}")

    def take(self, n: int, end: int) -> int:
        """The offset of the next n bytes, which it consumes."""
        at = self.pos
        if at + n > end:
            self.fail(f"truncated: {n} bytes needed, {end - at} left", at)
        self.pos = at + n
        return at

    def unpack(self, fmt: str, end: int):
        at = self.take(struct.calcsize(fmt), end)
        return struct.unpack_from(fmt, self.buf, at)[0]

    def value(self, end: int) -> Any:
        at = self.pos
        b = self.unpack("B", end)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, end, at)
        if 0x90 <= b <= 0x9F:
            return [self.value(end) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F, end)
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4), end)
        if b in _FIXED:
            return _FIXED[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b], end)
        if b not in _SIZED:
            self.fail(f"type byte 0x{b:02x} is not msgpack", at)
        kind, fmt = _SIZED[b]
        n = self.unpack(fmt, end)
        if kind == "bin":
            return bytes(self.buf[self.take(n, end):self.pos])
        if kind == "str":
            return self.str(n, end)
        if kind == "array":
            return [self.value(end) for _ in range(n)]
        if kind == "map":
            return self.map(n, end, at)
        return self.ext(n, end)

    def str(self, n: int, end: int) -> str:
        at = self.take(n, end)
        try:
            return bytes(self.buf[at:self.pos]).decode("utf-8")
        except UnicodeDecodeError:
            self.fail("a str that is not UTF-8", at)

    def map(self, n: int, end: int, at: int) -> Dict:
        out = {}
        for _ in range(n):
            key = self.value(end)
            if isinstance(key, (dict, list)):
                self.fail("a map key that is a map or an array", at)
            out[key] = self.value(end)
        if CHUNKED in out:
            return self.unchunk(out, at)
        return out

    def ext(self, n: int, end: int):
        code = self.unpack("b", end)
        start = self.take(n, end)
        self.pos = start
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            arr = self.array(start + n)
            out = arr if code == EXT_NDARRAY else arr[()]
        elif code == EXT_COMPLEX:
            parts = self.value(start + n)
            if (not isinstance(parts, list) or len(parts) != 2
                    or not all(isinstance(p, (int, float)) for p in parts)):
                self.fail("a complex ext that is not (real, imag)", start)
            out = complex(*parts)
        else:
            self.fail(f"ext type {code} (flax writes 1, 2 and 3)", start - 1)
        if self.pos != start + n:
            self.fail(f"an ext payload of {n} bytes holding "
                      f"{self.pos - start}", start)
        return out

    def array(self, end: int):
        """An ndarray payload `(shape, dtype name, bytes)`: an array over
        the buffer's bytes (a torch bf16 tensor for `bfloat16`)."""
        at = self.pos
        if self.unpack("B", end) != 0x93:
            self.fail("an ndarray payload that is not a 3-array", at)
        shape = self.value(end)
        name = self.value(end)
        if isinstance(name, bytes):
            name = name.decode("ascii", "replace")
        if (not isinstance(shape, list)
                or not all(isinstance(d, int) and d >= 0 for d in shape)
                or not isinstance(name, str)):
            self.fail("an ndarray payload without shape and dtype", at)
        b = self.unpack("B", end)
        if _SIZED.get(b, ("",))[0] != "bin":
            self.fail("an ndarray payload whose data is not bin", self.pos - 1)
        n = self.unpack(_SIZED[b][1], end)
        start = self.take(n, end)
        bf16 = name == "bfloat16"
        try:
            dtype = np.dtype(np.int16 if bf16 else name)
        except TypeError:
            self.fail(f"dtype {name!r}", at)
        if dtype.hasobject or n != int(np.prod(shape)) * dtype.itemsize:
            self.fail(f"{n} bytes for a {name} array of shape {shape}", at)
        arr = np.frombuffer(self.buf, dtype, n // dtype.itemsize,
                            start).reshape(shape)
        if bf16:
            # a read-only buffer (bytes) is copied: torch wants writable
            # memory; `load`'s copy-on-write map is writable
            return torch.from_numpy(arr if arr.flags.writeable
                                    else arr.copy()).view(torch.bfloat16)
        return arr

    def unchunk(self, m: Dict, at: int):
        try:
            shape = [m["shape"][str(i)] for i in range(len(m["shape"]))]
            chunks = [m["chunks"][str(i)] for i in range(len(m["chunks"]))]
        except (KeyError, TypeError):
            self.fail("a chunked array without its shape and chunks", at)
        if all(isinstance(c, np.ndarray) for c in chunks):
            return np.concatenate(chunks).reshape(shape)
        return torch.cat([torch.as_tensor(c) for c in chunks]).reshape(shape)


def loads(data, name: str = "<bytes>"):
    """The tree of flax msgpack bytes (`flax.serialization.msgpack_restore`
    of them)."""
    r = _Reader(data, name)
    tree = r.value(len(data))
    if r.pos != len(data):
        r.fail(f"{len(data) - r.pos} trailing bytes", r.pos)
    return tree


def load(path: str):
    """The tree of a flax msgpack file, its arrays over a copy-on-write
    `mmap` of it (see the module docstring)."""
    with open(path, "rb") as f:
        if os.fstat(f.fileno()).st_size == 0:
            raise ValueError(f"{path}: truncated: an empty file at byte 0")
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    return loads(buf, path)


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _header(n: int, small: int, small_max: int, codes) -> bytes:
    """A size header: a fix byte `small | n` up to `small_max`, else the
    first of `codes` ((byte, fmt, max)) that holds n."""
    if small is not None and n <= small_max:
        return struct.pack("B", small | n)
    for code, fmt, top in codes:
        if n <= top:
            return struct.pack(">B" + fmt, code, n)
    raise ValueError(f"msgpack: size {n} too large")


def _map_header(n):
    return _header(n, 0x80, 0x0F, ((0xDE, "H", 0xFFFF),
                                   (0xDF, "I", 0xFFFFFFFF)))


def _array_header(n):
    return _header(n, 0x90, 0x0F, ((0xDC, "H", 0xFFFF),
                                   (0xDD, "I", 0xFFFFFFFF)))


def _str_header(n):
    return _header(n, 0xA0, 0x1F, ((0xD9, "B", 0xFF), (0xDA, "H", 0xFFFF),
                                   (0xDB, "I", 0xFFFFFFFF)))


def _bin_header(n):
    return _header(n, None, 0, ((0xC4, "B", 0xFF), (0xC5, "H", 0xFFFF),
                                (0xC6, "I", 0xFFFFFFFF)))


def _ext_header(n: int, code: int) -> bytes:
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fix:
        head = struct.pack("B", fix[n])
    else:
        head = _header(n, None, 0, ((0xC7, "B", 0xFF), (0xC8, "H", 0xFFFF),
                                    (0xC9, "I", 0xFFFFFFFF)))
    return head + struct.pack("b", code)


def _int(v: int) -> bytes:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        return struct.pack("b" if v < 0 else "B", v)
    for lo, hi, code, fmt in ((0x80, 0xFF, 0xCC, "B"), (-0x80, -1, 0xD0, "b"),
                              (0x100, 0xFFFF, 0xCD, "H"),
                              (-0x8000, -0x81, 0xD1, "h"),
                              (0x10000, 0xFFFFFFFF, 0xCE, "I"),
                              (-0x80000000, -0x8001, 0xD2, "i"),
                              (0x100000000, 0xFFFFFFFFFFFFFFFF, 0xCF, "Q"),
                              (-0x8000000000000000, -0x80000001, 0xD3, "q")):
        if lo <= v <= hi:
            return struct.pack(">B" + fmt, code, v)
    raise OverflowError(f"msgpack: integer {v} out of range")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _str_header(len(b)) + b


def _host_array(x):
    """(a C-contiguous numpy array of x on the host, its dtype name): a
    torch tensor is copied off its device here; bf16 is viewed as int16."""
    if not isinstance(x, torch.Tensor):
        arr = np.asarray(x)        # (np.ascontiguousarray makes 0-d 1-d)
        if not arr.flags.c_contiguous:
            arr = arr.copy(order="C")
        return arr, arr.dtype.name
    t = x.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    arr = t.numpy()
    return arr, arr.dtype.name


def _array_payload_header(shape, name: str, nbytes: int) -> bytes:
    """The msgpack of `(shape, name, data)` up to the data's own bytes."""
    return (_array_header(3)
            + _array_header(len(shape)) + b"".join(_int(d) for d in shape)
            + _str(name) + _bin_header(nbytes))


def _write_array(f: BinaryIO, arr: np.ndarray, name: str, code: int):
    head = _array_payload_header(arr.shape, name, arr.nbytes)
    f.write(_ext_header(len(head) + arr.nbytes, code))
    f.write(head)
    f.write(arr.reshape(-1).view(np.uint8).data)


def _write(f: BinaryIO, x):
    if x is None:
        f.write(b"\xc0")
    elif type(x) is bool:
        f.write(b"\xc3" if x else b"\xc2")
    elif type(x) is int:
        f.write(_int(x))
    elif type(x) in (bytes, bytearray):
        f.write(_bin_header(len(x)) + bytes(x))
    elif type(x) is str:
        f.write(_str(x))
    elif type(x) is float:
        f.write(struct.pack(">Bd", 0xCB, x))
    elif type(x) is complex:
        payload = b"\x92" + b"".join(struct.pack(">Bd", 0xCB, v)
                                     for v in (x.real, x.imag))
        f.write(_ext_header(len(payload), EXT_COMPLEX) + payload)
    elif type(x) in (list, tuple):
        f.write(_array_header(len(x)))
        for v in x:
            _write(f, v)
    elif isinstance(x, dict):
        f.write(_map_header(len(x)))
        for k, v in x.items():
            _write(f, str(k))
            _write(f, v)
    elif isinstance(x, np.generic):
        arr = np.asarray(x)
        _write_array(f, arr, arr.dtype.name, EXT_NPSCALAR)
    elif isinstance(x, (np.ndarray, torch.Tensor)) or hasattr(x,
                                                               "__array__"):
        arr, name = _host_array(x)
        if arr.nbytes > MAX_CHUNK_SIZE:
            _write(f, _chunked(arr, name))
        else:
            _write_array(f, arr, name, EXT_NDARRAY)
    elif isinstance(x, _Named):
        _write_array(f, x.arr, x.name, EXT_NDARRAY)
    else:
        raise TypeError(f"flax msgpack: cannot write {type(x).__name__}")


class _Named:
    """A host array written under a dtype name of its own (a chunk of a
    bf16 array, held as int16)."""

    def __init__(self, arr: np.ndarray, name: str):
        self.arr, self.name = arr, name


def _chunked(arr: np.ndarray, name: str) -> Dict:
    """flax's `_chunk`: the map of a flat array's pieces of at most
    MAX_CHUNK_SIZE bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): _Named(flat[j:j + size], name)
                       for i, j in enumerate(range(0, flat.size, size))}}


def dump(tree, f: BinaryIO) -> None:
    """Write `tree` to the binary file `f` (see the module docstring)."""
    _write(f, tree)


def dumps(tree) -> bytes:
    import io
    buf = io.BytesIO()
    dump(tree, buf)
    return buf.getvalue()


def save(path: str, tree) -> int:
    """`tree` into the file `path`, written beside it and renamed into
    place; returns the bytes written."""
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            dump(tree, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return os.path.getsize(path)


def save_jax_pretrained(lm, save_dir: str) -> int:
    """Write a port model (`api.model.GroveForCausalLM`) as the JAX
    package's model directory (`grove_tpu/api/model.py:190-199`):
    `config.json` and `flax_model.msgpack` of `checkpoint.convert.
    jax_tree_from_model`, each tensor in the model's own dtype. The JAX
    package's `from_pretrained(save_dir)` reads it, and so does the
    port's. Returns the bytes of the model file."""
    os.makedirs(save_dir, exist_ok=True)
    lm.cfg.save_json(os.path.join(save_dir, "config.json"))
    return save(os.path.join(save_dir, MODEL_FILE),
                jax_tree_from_model(lm.model))
