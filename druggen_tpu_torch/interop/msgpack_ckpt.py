"""Reader for the JAX package's flax msgpack checkpoints, without flax.

``druggen_tpu/train/checkpoint.py`` writes parameter trees with
``flax.serialization.to_bytes``: a msgpack map of maps whose array leaves
are msgpack extension objects of type 1, each holding a msgpack array
``(shape, dtype name, raw bytes)``.  This module decodes that format in
plain Python (no ``msgpack`` package) into a nested dict of numpy arrays,
bit-equal to ``flax.serialization.msgpack_restore``, and performs the
stacked -> unrolled encoder conversion of ``load_params_auto``
(``checkpoint.py:57-77``) so ``scan_layers`` checkpoints load too.
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
