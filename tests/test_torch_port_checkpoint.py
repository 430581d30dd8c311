"""The port's own flax-msgpack reader against flax.serialization.

Every tracked ``*-G.ckpt`` must decode to the same keys and bit-equal
arrays as ``flax.serialization.msgpack_restore``; a stacked
(``scan_layers``) checkpoint must come out as ``load_params_auto`` loads it
into an unrolled Generator.
"""

import glob
import os

import msgpack
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax import serialization

from druggen_tpu.models.layers import stack_block_params
from druggen_tpu.models.models import Generator as FlaxGenerator
from druggen_tpu.train.checkpoint import load_params_auto
from druggen_tpu_torch.interop import msgpack_ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = sorted(os.path.relpath(p, REPO) for p in
               glob.glob(os.path.join(REPO, "experiments", "**", "*-G.ckpt"),
                         recursive=True))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _assert_trees_bit_equal(got, want):
    got_l, want_l = dict(_leaves(got)), dict(_leaves(want))
    assert set(got_l) == set(want_l)
    for k, w in want_l.items():
        g = got_l[k]
        assert isinstance(g, (np.ndarray, np.generic)), k
        assert type(g) is type(w) or isinstance(w, jax.Array), k
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


def test_tracked_checkpoints_exist():
    assert len(CKPTS) >= 7
    assert any("r2_scale" in p and p.endswith("DrugGEN-G.ckpt") for p in CKPTS)


@pytest.mark.parametrize("path", CKPTS)
def test_reader_is_bit_equal_to_flax(path):
    with open(os.path.join(REPO, path), "rb") as f:
        data = f.read()
    _assert_trees_bit_equal(msgpack_ckpt.msgpack_restore(data),
                            serialization.msgpack_restore(data))


def test_stacked_checkpoint_loads_like_load_params_auto(tmp_path):
    """scan_layers layout (``blocks/block`` with a depth axis) is unstacked
    exactly as load_params_auto unstacks it for an unrolled template."""
    kw = dict(act="relu", vertexes=9, edges=5, nodes=8, dropout=0.0, dim=32,
              depth=2, heads=4, mlp_ratio=3)
    z_e, z_n = jnp.zeros((1, 9, 9, 5)), jnp.zeros((1, 9, 8))
    template = FlaxGenerator(**kw).init(jax.random.PRNGKey(0), z_e, z_n)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda x: rng.normal(size=x.shape).astype(np.float32), template)
    stacked = stack_block_params(params)
    assert "blocks" in stacked["params"]["trunk"]["encoder"]
    path = tmp_path / "stacked-G.ckpt"
    path.write_bytes(serialization.to_bytes(stacked))
    want = serialization.to_state_dict(load_params_auto(str(path), template))
    _assert_trees_bit_equal(msgpack_ckpt.read_flax_checkpoint(str(path)), want)


@pytest.mark.parametrize("value", [
    {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 - 1,
              -1, -32, -33, -128, -129, -32768, -32769, -2**31 - 1, -2**63]},
    {"floats": [0.0, -1.5, 1e300, float("inf")], "none": None,
     "flags": [True, False]},
    {"s" * 40: "x" * 300, "long": "y" * 70000, "bin": b"\x00\x01" * 200},
    {str(i): i for i in range(20)},
    {"nested": {"list": list(range(20)), "empty": {}}},
])
def test_reader_decodes_plain_msgpack(value):
    data = msgpack.packb(value, use_bin_type=True)
    assert msgpack_ckpt.msgpack_restore(data) == value


@pytest.mark.parametrize("dtype", ["float32", "float64", "int8", "int32",
                                   "uint16", "bool", "float16"])
def test_reader_decodes_arrays(dtype):
    arr = (np.arange(24) % 7 - 3).astype(dtype).reshape(2, 3, 4)
    tree = {"a": arr, "scalar": np.asarray(arr)[0, 0, 0]}
    data = serialization.msgpack_serialize(tree)
    _assert_trees_bit_equal(msgpack_ckpt.msgpack_restore(data),
                            serialization.msgpack_restore(data))


def test_reader_widens_bfloat16_exactly():
    arr = jnp.asarray([[1.0, -2.5, 3.140625], [0.0, 65280.0, -1e-3]],
                      jnp.bfloat16)
    data = serialization.msgpack_serialize({"w": np.asarray(arr)})
    got = msgpack_ckpt.msgpack_restore(data)["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(arr.astype(jnp.float32)))


def test_reader_rejects_truncated_data():
    data = serialization.msgpack_serialize({"w": np.ones(8, np.float32)})
    with pytest.raises(ValueError):
        msgpack_ckpt.msgpack_restore(data[:-3])
