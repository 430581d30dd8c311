"""Reader and writer for the JAX package's flax msgpack checkpoints,
without flax.

``druggen_tpu/train/checkpoint.py`` writes parameter trees with
``flax.serialization.to_bytes``: a msgpack map of maps whose array leaves
are msgpack extension objects of type 1, each holding a msgpack array
``(shape, dtype name, raw bytes)``.  This module decodes that format in
plain Python (no ``msgpack`` package) into a nested dict of numpy arrays,
bit-equal to ``flax.serialization.msgpack_restore``, and performs the
stacked -> unrolled encoder conversion of ``load_params_auto``
(``checkpoint.py:57-77``) so ``scan_layers`` checkpoints load too, and
:func:`stack_block_params` the other way, so that the port writes them.
:func:`msgpack_serialize` writes a nested dict of numpy arrays in the same
format, which ``flax.serialization.from_bytes`` reads.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        t = self.take(1)[0]
        if t <= 0x7F:                       # positive fixint
            return t
        if t >= 0xE0:                       # negative fixint
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.str(t & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {
            0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
            0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
        }
        if t in sized:
            kind, fmt = sized[t]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            return getattr(self, kind)(n)
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if t in scalars:
            return self.unpack(scalars[t])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            return self.ext(fixext[t])
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        raise ValueError(f"unsupported msgpack extension type {code}")


def _ndarray(data: bytes) -> np.ndarray:
    """flax's ndarray payload: msgpack ``[shape, dtype name, bytes]``."""
    r = _Reader(data)
    shape, name, raw = r.obj()
    if isinstance(name, bytes):
        name = name.decode()
    if name == "bfloat16":
        # numpy has no bfloat16: widen exactly to float32 (bf16 is the top
        # half of an f32)
        bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    """Reassemble arrays flax split into ``__msgpack_chunked_array__``."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes):
    """Decode flax msgpack bytes into a nested dict of numpy arrays."""
    r = _Reader(data)
    tree = r.obj()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)


def unstack_block_params(tree):
    """``{'blocks': {'block': stacked}}`` (scan_layers layout) ->
    ``{'block_0': …, 'block_{d-1}': …}`` anywhere in the tree (numpy copy of
    ``druggen_tpu.models.layers.unstack_block_params``)."""
    if not isinstance(tree, dict):
        return tree
    if set(tree) == {"blocks"} and isinstance(tree["blocks"], dict) \
            and set(tree["blocks"]) == {"block"}:
        stacked = tree["blocks"]["block"]
        depth = _first_leaf(stacked).shape[0]
        return {f"block_{i}": _index_leaves(stacked, i) for i in range(depth)}
    return {k: unstack_block_params(v) for k, v in tree.items()}


def stack_block_params(tree):
    """``{'block_0': …, 'block_{d-1}': …}`` (unrolled) -> ``{'blocks':
    {'block': stacked}}`` (scan_layers layout, each leaf with a leading
    depth axis) anywhere in the tree; the inverse of
    :func:`unstack_block_params` (numpy copy of
    ``druggen_tpu.models.layers.stack_block_params``, the stacked subtree's
    keys in the sorted order ``jax.tree_util.tree_map`` gives them)."""
    if not isinstance(tree, dict):
        return tree
    keys = [k for k in tree if k.startswith("block_") and k[6:].isdigit()]
    if keys and len(keys) == len(tree):
        keys.sort(key=lambda k: int(k[6:]))
        return {"blocks": {"block": _stack_leaves(
            [stack_block_params(tree[k]) for k in keys])}}
    return {k: stack_block_params(v) for k, v in tree.items()}


def _stack_leaves(subs: list):
    if isinstance(subs[0], dict):
        return {k: _stack_leaves([s[k] for s in subs]) for k in sorted(subs[0])}
    return np.stack([np.asarray(leaf) for leaf in subs])


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _index_leaves(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index_leaves(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def read_flax_checkpoint(path: str) -> dict:
    """Read a ``*-G.ckpt`` parameter file in the unrolled layout."""
    with open(path, "rb") as f:
        return unstack_block_params(msgpack_restore(f.read()))


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

_MAX_ARRAY_BYTES = 2 ** 31 - 1   # flax would chunk larger arrays


def _pack_len(out: bytearray, n: int, fix: int | None, fix_max: int,
              codes: tuple[int, int, int]) -> None:
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif n < 2 ** 8 and codes[0]:
        out += bytes([codes[0], n])
    elif n < 2 ** 16:
        out += bytes([codes[1]]) + struct.pack(">H", n)
    else:
        out += bytes([codes[2]]) + struct.pack(">I", n)


def _pack(out: bytearray, obj) -> None:
    if isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (0, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, str(k))
            _pack(out, v)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (0, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, bytes):
        _pack_len(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (bool, np.bool_)):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, (int, np.integer)) and not isinstance(obj, np.ndarray):
        n = int(obj)
        if 0 <= n < 128:
            out.append(n)
        elif -32 <= n < 0:
            out.append(n & 0xFF)
        elif n >= 0:
            for code, fmt, top in ((0xCC, ">B", 2 ** 8), (0xCD, ">H", 2 ** 16),
                                   (0xCE, ">I", 2 ** 32), (0xCF, ">Q", 2 ** 64)):
                if n < top:
                    out += bytes([code]) + struct.pack(fmt, n)
                    break
        else:
            for code, fmt, bits in ((0xD0, ">b", 7), (0xD1, ">h", 15),
                                    (0xD2, ">i", 31), (0xD3, ">q", 63)):
                if n >= -(2 ** bits):
                    out += bytes([code]) + struct.pack(fmt, n)
                    break
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)          # keeps a 0-d array 0-d; tobytes("C") below
        if arr.nbytes > _MAX_ARRAY_BYTES:
            raise ValueError(f"array of {arr.nbytes} bytes is too large to "
                             "write unchunked")
        payload = bytearray()
        _pack(payload, [list(arr.shape), arr.dtype.name, arr.tobytes("C")])
        code = _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(fixext[n])
        else:
            _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", code) + payload
    else:
        raise TypeError(f"cannot serialise {type(obj).__name__}")


def msgpack_serialize(tree) -> bytes:
    """A nested dict of numpy arrays -> flax msgpack bytes (the format of
    ``flax.serialization.to_bytes``)."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)
