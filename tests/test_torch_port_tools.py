"""The port's tools against the JAX package's, on the CPU: SimpleDisc,
``interop/torch_ckpt.py`` and the ``import_torch_ckpt`` CLI, the torch-file
branch of ``train/checkpoint.py::load_params_auto``, ``utils/profiling.py``,
``utils/diagnostics.py`` and ``entry.py``.

SimpleDisc and ``entry()``'s Generator forward agree with flax on the same
weights (through the converters) at rtol 1e-5 / 1e-4 (f32 sums in another
order); the converters give the JAX converters' trees (same keys in the same
order, equal arrays), with and without the ``module.`` prefix and in the
``scan_layers`` layout, and the CLI writes the JAX CLI's bytes;
``grad_flow_summary`` gives the JAX rows on the same gradients.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from druggen_tpu.interop import torch_ckpt as jax_tc
from druggen_tpu.models import Generator as JaxGenerator
from druggen_tpu.models import SimpleDisc as JaxSimpleDisc
from druggen_tpu.utils import diagnostics as jax_diag
from druggen_tpu_torch import import_torch_ckpt as port_cli
from druggen_tpu_torch.chem.vocab import CHEMBL_VOCAB
from druggen_tpu_torch.entry import entry
from druggen_tpu_torch.interop import torch_ckpt as tc
from druggen_tpu_torch.interop.weights import to_torch_tensors
from druggen_tpu_torch.models import Discriminator, Generator, SimpleDisc
from druggen_tpu_torch.train.checkpoint import load_params_auto
from druggen_tpu_torch.utils import diagnostics, profiling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import import_torch_ckpt as jax_cli  # noqa: E402  (the JAX tool, scripts/)

N, M_DIM, B_DIM, DIM, HEADS = 9, 5, 4, 16, 4


def _models():
    g = Generator(act="relu", vertexes=N, edges=B_DIM, nodes=M_DIM, dropout=0.0,
                  dim=DIM, depth=2, heads=HEADS, mlp_ratio=2)
    d = Discriminator(act="relu", vertexes=N, edges=B_DIM, nodes=M_DIM, dropout=0.0,
                      dim=DIM, depth=2, heads=HEADS, mlp_ratio=2)
    return {"generator": g, "discriminator": d,
            "simple_disc": SimpleDisc("relu", M_DIM, N, B_DIM)}


def _flat(tree, prefix=""):
    """(path, leaf) in insertion order: the order a msgpack file keeps."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _same_tree(got, want):
    g, w = list(_flat(got)), list(_flat(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and np.array_equal(a, b), p


def test_simple_disc_matches_flax():
    """The port's weights through the bridge into the flax module (whose
    tree they must fit: ``jax.eval_shape`` of its ``init``)."""
    jm = JaxSimpleDisc(act="relu", m_dim=M_DIM, vertexes=N, b_dim=B_DIM)
    feats = N * M_DIM + N * N * B_DIM
    x = np.random.default_rng(0).normal(size=(3, feats)).astype(np.float32)
    port = SimpleDisc("relu", M_DIM, N, B_DIM)
    assert [k for k in port.state_dict()][::2] == [f"predictor.{i}.weight"
                                                   for i in (0, 2, 4, 6, 8, 10)]
    variables = tc.torch_simple_disc_to_flax(port.state_dict())
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: a.shape == b.shape and a.dtype == b.dtype, variables, shapes))
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    back = to_torch_tensors(tc.flax_simple_disc_to_torch(variables))
    assert all(torch.equal(back[k], v) for k, v in port.state_dict().items())


@pytest.mark.parametrize("kind", ["generator", "discriminator", "simple_disc"])
@pytest.mark.parametrize("prefix", ["", "module."])
def test_converters_match_jax(kind, prefix):
    sd = {prefix + k: v for k, v in _models()[kind].state_dict().items()}
    convert = {"generator": "torch_generator_to_flax",
               "discriminator": "torch_discriminator_to_flax",
               "simple_disc": "torch_simple_disc_to_flax"}[kind]
    for scan in ((False, True) if kind != "simple_disc" else (False,)):
        kw = {"scan_layers": True} if scan else {}
        got = getattr(tc, convert)(sd, **kw)
        _same_tree(got, getattr(jax_tc, convert)(sd, **kw))
        back = getattr(tc, f"flax_{kind}_to_torch")(got)
        assert set(back) == {k[len(prefix):] for k in sd}
        for k, v in back.items():
            assert np.array_equal(v, sd[prefix + k].numpy()), k


def test_converters_refuse_the_wrong_model():
    d = _models()["discriminator"].state_dict()
    with pytest.raises(ValueError, match="unconverted"):
        tc.torch_generator_to_flax({**_models()["generator"].state_dict(),
                                    "node_mlp.0.weight": d["node_mlp.0.weight"]})
    with pytest.raises(ValueError, match="Encoder_Blocks"):
        tc.torch_generator_to_flax(_models()["simple_disc"].state_dict())


@pytest.mark.parametrize("kind", ["generator", "discriminator", "simple_disc"])
def test_import_cli_writes_the_jax_bytes(kind, tmp_path):
    """torch -> flax msgpack: the JAX CLI's bytes (also with a ``module.``
    prefix and --scan-layers); --reverse gives back the state_dict."""
    sd = _models()[kind].state_dict()
    for prefix in ("", "module."):
        ckpt = str(tmp_path / f"in{prefix}.ckpt")
        torch.save({prefix + k: v for k, v in sd.items()}, ckpt)
        for scan in ([[]] if kind == "simple_disc" else [[], ["--scan-layers"]]):
            args = ["--model", kind, "--input", ckpt] + scan
            assert port_cli.main(args + ["--output", str(tmp_path / "p.msgpack")]) == 0
            assert jax_cli.main(args + ["--output", str(tmp_path / "j.msgpack")]) == 0
            assert ((tmp_path / "p.msgpack").read_bytes()
                    == (tmp_path / "j.msgpack").read_bytes())
            rev = str(tmp_path / "rev.ckpt")
            assert port_cli.main(["--reverse", "--model", kind, "--input",
                                  str(tmp_path / "p.msgpack"), "--output", rev]) == 0
            back = torch.load(rev, weights_only=True)
            assert set(back) == set(sd)
            assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_load_params_auto_reads_torch_files(tmp_path):
    """A reference {submodel}-G.ckpt, plain or with the ``module.`` prefix,
    and its msgpack import give the same state_dict."""
    g = _models()["generator"]
    sd = g.state_dict()
    torch.save(sd, tmp_path / "plain-G.ckpt")
    torch.save({"module." + k: v for k, v in sd.items()}, tmp_path / "dp-G.ckpt")
    port_cli.main(["--model", "generator", "--input", str(tmp_path / "dp-G.ckpt"),
                   "--output", str(tmp_path / "flax-G.ckpt")])
    for name in ("plain-G.ckpt", "dp-G.ckpt", "flax-G.ckpt"):
        assert tc.is_torch_file(str(tmp_path / name)) == (name != "flax-G.ckpt")
        got = load_params_auto(str(tmp_path / name))
        assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd), name
    g2 = Generator(act="relu", vertexes=N, edges=B_DIM, nodes=M_DIM, dropout=0.0,
                   dim=DIM, depth=2, heads=HEADS, mlp_ratio=2,
                   generator=torch.Generator().manual_seed(9))
    g2.load_state_dict(load_params_auto(str(tmp_path / "dp-G.ckpt")))
    z_e = torch.nn.functional.one_hot(torch.randint(0, B_DIM, (2, N, N)), B_DIM).float()
    z_n = torch.nn.functional.one_hot(torch.randint(0, M_DIM, (2, N)), M_DIM).float()
    with torch.no_grad():
        assert all(torch.equal(a, b) for a, b in zip(g(z_e, z_n), g2(z_e, z_n)))


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(None) as prof:
        assert prof is None
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].startswith("trace_") and files[0].endswith(".json")
    with open(tmp_path / "tr" / files[0]) as f:
        assert json.load(f)["traceEvents"]
    assert any("mm" in e.key for e in prof.key_averages())
    timer = profiling.StepTimer()
    for _ in range(3):
        with timer:
            pass
    assert set(timer.stats()) == {"step_avg_s", "step_p50_s", "step_p90_s", "step_p99_s"}


@pytest.mark.parametrize("kind", ["generator", "discriminator", "simple_disc"])
def test_grad_flow_summary_matches_jax(kind, tmp_path):
    """The same gradients (random, in the JAX layout, carried over by the
    bridge): the JAX rows, names and numbers."""
    model = _models()[kind]
    to_flax = {"generator": tc.torch_generator_to_flax,
               "discriminator": tc.torch_discriminator_to_flax,
               "simple_disc": tc.torch_simple_disc_to_flax}[kind]
    rng = np.random.default_rng(0)
    grads = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32),
        to_flax(model.state_dict()))
    to_torch = getattr(tc, f"flax_{kind}_to_torch")(grads)
    for name, p in model.named_parameters():
        p.grad = torch.from_numpy(to_torch[name])
    got = diagnostics.grad_flow_summary(model)
    assert got == jax_diag.grad_flow_summary(grads) and got[0][0].startswith("params/")
    if kind == "simple_disc":
        # the card's machine has no matplotlib: a clear ImportError there
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(sys.modules, "matplotlib", None)
            with pytest.raises(ImportError, match="plot_grad_flow needs matplotlib"):
                diagnostics.plot_grad_flow(model, "D", 3, str(tmp_path))
        assert not os.listdir(tmp_path)


def test_grad_flow_summary_of_other_modules():
    m = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    m(torch.ones(1, 3)).sum().backward()
    rows = diagnostics.grad_flow_summary(m)
    assert [r[0] for r in rows] == ["0.weight", "1.weight"]
    assert rows[1][1] == pytest.approx(m[1].weight.grad.abs().mean().item())


def test_entry_matches_the_jax_entry():
    """entry() on the CPU: the default-config Generator forward (dim 128,
    depth 1, 8 heads, mlp_ratio 3, the ChEMBL vocabulary), batch 8, N 45.
    The JAX entry() initialises its weights eagerly (~11 s here), so the
    port's weights go the other way: the JAX entry's Generator, applied to
    them through the bridge and to the same inputs, gives the same logits."""
    fn, (params, z_e, z_n) = entry(device="cpu")
    b_dim, m_dim = CHEMBL_VOCAB.b_dim, CHEMBL_VOCAB.m_dim
    assert tuple(z_e.shape) == (8, 45, 45, b_dim) and tuple(z_n.shape) == (8, 45, m_dim)
    with torch.no_grad():
        got = fn(params, z_e, z_n)
    assert [tuple(t.shape) for t in got] == [(8, 45, m_dim), (8, 45, 45, b_dim)]
    jm = JaxGenerator(act="relu", vertexes=45, edges=b_dim, nodes=m_dim, dropout=0.0,
                      dim=128, depth=1, heads=8, mlp_ratio=3)
    want = jax.jit(jm.apply)(tc.torch_generator_to_flax(params), jnp.asarray(z_e.numpy()),
                             jnp.asarray(z_n.numpy()))[2:]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            entry()
