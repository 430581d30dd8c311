"""K9, the whole-generator kernel, and ``use_pallas`` serving in the PyTorch port.

The port's plain version of K9 (what ``fused_generator_logits`` runs for a
CPU tensor) is held against the JAX package's Pallas kernel run through the
interpreter (``fused_generator_logits(..., interpret=True)``) on the same
numpy inputs, with the flax parameters carried across by
``flax_generator_to_torch`` and then :func:`extract_generator_weights`, at
the JAX K9 tests' own size (N 9, dim 16, 4 heads, m_dim 12, b_dim 5).

Tolerances.  f32: atol 2e-5 + rtol 2e-5 (JAX's own limits; the same
products summed in another order).  bf16: XLA on the CPU keeps excess
precision inside the interpreted kernel's fused operations, so the Pallas
kernel does not round at every op there and its logits move by about one
bf16 ulp: max |err| <= 3e-2 + 2^-7 |ref| and mean <= 4e-3; a label may then
change only where the reference's top two logits lie within that bound of
each other (random weights give near ties); on the trained r2_scale weights
at full width (decisive logits) >= 99 % of the labels must be equal.  With
``--xla_allow_excess_precision=false`` (a JAX process of its own, since the
flag is read when XLA starts) the plain version is held bit-equal to the
Pallas kernel, which pins every rounding point.

The slice: the port's ``InferenceEngine`` with ``use_pallas`` against the
JAX engine with ``use_pallas`` on the trained r2_scale checkpoint at full
width, one 8-graph batch in f32: identical labels and SMILES; and against
the port's own engine without it: identical labels.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from druggen_tpu.chem.vocab import Vocab as JaxVocab
from druggen_tpu.config import InferenceConfig as JaxInferenceConfig
from druggen_tpu.infer.engine import InferenceEngine as JaxInferenceEngine
from druggen_tpu.models import Generator as FlaxGenerator
from druggen_tpu.ops import fused_generator as jax_fg
from druggen_tpu_torch import inference as port_cli
from druggen_tpu_torch.chem.vocab import Vocab
from druggen_tpu_torch.config import InferenceConfig
from druggen_tpu_torch.infer.engine import InferenceEngine
from druggen_tpu_torch.interop import weights
from druggen_tpu_torch.models import Generator
from druggen_tpu_torch.ops import fused_generator as port

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, M_DIM, B_DIM, DIM, HEADS, BATCH = 9, 12, 5, 16, 4, 2


def _symmetric_onehots(seed, b=BATCH, n=N):
    rng = np.random.default_rng(seed)
    lab = np.triu(rng.integers(0, B_DIM, (b, n, n)), 1)
    lab = lab + lab.transpose(0, 2, 1)
    z_e = np.eye(B_DIM, dtype=np.float32)[lab]
    z_n = np.eye(M_DIM, dtype=np.float32)[rng.integers(0, M_DIM, (b, n))]
    return z_e, z_n


@functools.cache
def _flax_params(depth):
    g = FlaxGenerator(act="relu", vertexes=N, edges=B_DIM, nodes=M_DIM, dropout=0.0,
                      dim=DIM, depth=depth, heads=HEADS, mlp_ratio=3)
    return g.init(jax.random.PRNGKey(0), jnp.zeros((1, N, N, B_DIM)), jnp.zeros((1, N, M_DIM)))


def _port_generator(params, depth):
    G = Generator(act="relu", vertexes=N, edges=B_DIM, nodes=M_DIM, dropout=0.0, dim=DIM,
                  depth=depth, heads=HEADS, mlp_ratio=3)
    G.load_state_dict(weights.to_torch_tensors(weights.flax_generator_to_torch(
        jax.tree_util.tree_map(np.asarray, params))))
    return G.eval()


@functools.cache
def _pallas_run(depth, name):
    """One interpreted Pallas K9 on numpy inputs (once per file), and the
    port's Generator on the same parameters."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[name]
    params = _flax_params(depth)
    z_e, z_n = _symmetric_onehots(depth)
    want = jax_fg.fused_generator_logits(params, jnp.asarray(z_e, jdt), jnp.asarray(z_n, jdt),
                                         heads=HEADS, interpret=True)
    return tdt, _port_generator(params, depth), (z_e, z_n), want


def _got(G, z_e, z_n, tdt):
    return port.fused_generator_logits(G, torch.from_numpy(z_e).to(tdt),
                                       torch.from_numpy(z_n).to(tdt), heads=HEADS)


@pytest.mark.parametrize("depth", [1, 2])
def test_plain_matches_pallas_f32(depth):
    tdt, G, (z_e, z_n), want = _pallas_run(depth, "f32")
    for got, ref in zip(_got(G, z_e, z_n, tdt), want):
        assert got.dtype == torch.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_plain_matches_pallas_bf16():
    tdt, G, (z_e, z_n), want = _pallas_run(1, "bf16")
    for got, ref in zip(_got(G, z_e, z_n, tdt), want):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        got = got.float().numpy()
        ref = np.asarray(ref.astype(jnp.float32))
        err = np.abs(got - ref)
        bound = 3e-2 + 2 ** -7 * np.abs(ref)
        assert (err <= bound).all(), err.max()
        assert err.mean() <= 4e-3, err.mean()
        # a label may differ only at a near tie: the reference's logit of the
        # port's label within twice the error bound of its top logit
        lab_g, lab_r = got.argmax(-1), ref.argmax(-1)
        top = np.take_along_axis(ref, lab_r[..., None], -1)[..., 0]
        mine = np.take_along_axis(ref, lab_g[..., None], -1)[..., 0]
        limit = np.take_along_axis(2 * bound, lab_r[..., None], -1)[..., 0]
        assert ((lab_g == lab_r) | (top - mine <= limit)).all()


_NO_EXCESS = r"""
import sys
import numpy as np
import jax.numpy as jnp
from druggen_tpu.ops.fused_generator import fused_generator_logits
out, heads = sys.argv[1], int(sys.argv[2])
z = np.load(out + ".in.npz")
res = {}
for depth in (1, 2):
    params = {}
    for key, value in np.load(f"{out}.params{depth}.npz").items():
        *path, leaf = key.split("/")
        node = params
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(value)
    nl, el = fused_generator_logits(params, jnp.asarray(z[f"z_e{depth}"], jnp.bfloat16),
                                    jnp.asarray(z[f"z_n{depth}"], jnp.bfloat16), heads=heads,
                                    interpret=True)
    res[f"node{depth}"] = np.asarray(nl.astype(jnp.float32))
    res[f"edge{depth}"] = np.asarray(el.astype(jnp.float32))
np.savez(out, **res)
"""


@pytest.fixture(scope="module")
def no_excess_run(tmp_path_factory):
    """bf16 K9 through the interpreter in a JAX process of its own with
    ``--xla_allow_excess_precision=false``, at depth 1 and 2."""
    out = str(tmp_path_factory.mktemp("k9_no_excess") / "k9")
    inputs = {}
    for depth in (1, 2):
        inputs[f"z_e{depth}"], inputs[f"z_n{depth}"] = _symmetric_onehots(10 + depth)
        flat = jax.tree_util.tree_flatten_with_path(_flax_params(depth))[0]
        np.savez(f"{out}.params{depth}.npz", **{
            "/".join(p.key for p in path): np.asarray(leaf) for path, leaf in flat})
    np.savez(out + ".in.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, "-c", _NO_EXCESS, out, str(HEADS)], env=env, check=True,
                   timeout=300)
    return inputs, dict(np.load(out + ".npz"))


@pytest.mark.parametrize("depth", [1, 2])
def test_plain_is_bit_equal_to_pallas_without_excess_precision(depth, no_excess_run):
    """bf16: with XLA rounding at every operation, the Pallas kernel's
    logits and the plain version's are the same bits."""
    inputs, want = no_excess_run
    G = _port_generator(_flax_params(depth), depth)
    got_n, got_e = _got(G, inputs[f"z_e{depth}"], inputs[f"z_n{depth}"], torch.bfloat16)
    np.testing.assert_array_equal(got_n.float().numpy(), want[f"node{depth}"])
    np.testing.assert_array_equal(got_e.float().numpy(), want[f"edge{depth}"])


def test_weights_bit_equal_to_jax():
    """The ordered weight list from the port's Generator (and from its
    state_dict) against JAX's from the flax parameters: order, shapes,
    values, bit-equal, at depth 2."""
    params = _flax_params(2)
    want, depth_j = jax_fg.extract_generator_weights(params)
    G = _port_generator(params, 2)
    for source in (G, G.state_dict()):
        got, depth = port.extract_generator_weights(source)
        assert depth == depth_j == 2 and len(got) == len(want) == 42
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, i
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=str(i))


def test_every_weight_form_gives_the_same_logits_as_the_generator():
    """A Generator, its state_dict, ``(weights, depth)`` and a
    ``GeneratorWeights`` give the same logits; in f32 they match the port's
    eager Generator on a symmetric input (1e-5: the same math in another
    order, the symmetrisation skipped)."""
    G = _port_generator(_flax_params(2), 2)
    z_e, z_n = (torch.from_numpy(a) for a in _symmetric_onehots(5))
    forms = (G, G.state_dict(), port.extract_generator_weights(G),
             port.GeneratorWeights.of(G))
    outs = [port.fused_generator_logits(f, z_e, z_n, heads=HEADS) for f in forms]
    for o in outs[1:]:
        for a, b in zip(o, outs[0]):
            assert torch.equal(a, b)
    with torch.no_grad():
        _, _, nl, el = G(z_e, z_n)
    torch.testing.assert_close(outs[0][0], nl, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(outs[0][1], el, atol=1e-5, rtol=1e-5)


def test_debug_rejects_an_asymmetric_z_e():
    G = _port_generator(_flax_params(1), 1)
    z_e, z_n = (torch.from_numpy(a) for a in _symmetric_onehots(6))
    port.fused_generator_logits(G, z_e, z_n, heads=HEADS, debug=True)
    z_e[0, 0, 1] = torch.roll(z_e[0, 0, 1], 1)
    with pytest.raises(AssertionError, match="symmetric"):
        port.fused_generator_logits(G, z_e, z_n, heads=HEADS, debug=True)


# --- the slice: use_pallas serving --------------------------------------------

CKPT_DIR = os.path.join(
    REPO, "experiments", "r2_scale", "models",
    "r2_scale_DrugGEN_glr1e-05_dlr1e-05_dim128_depth1_heads8_batch512_epoch35"
    "_datasetchembl_like_150k45_dropout0.0")
VOCAB_JSON = os.path.join(REPO, "data", "cache", "vocab",
                          "vocab_akt1_drugs_chembl_like_150k_45.json")
SMILES_FILE = os.path.join(REPO, "data", "chembl_like_150k.smi")
SERVE = 8


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The JAX engine with ``use_pallas`` (given the parameters that the
    plain JAX engine loaded, so that no template init runs the Pallas
    attention), and the port's engines with and without it (the second given
    the first's state_dict), on one trained checkpoint, f32, CPU."""
    tmp = tmp_path_factory.mktemp("serve_pallas")
    smi = tmp / "inf.smi"
    with open(SMILES_FILE) as src:
        smi.write_text("".join(line for _, line in zip(range(64), src)))
    with open(VOCAB_JSON) as f:
        vocab_json = f.read()
    common = dict(submodel="DrugGEN", inference_model=CKPT_DIR, sample_num=SERVE,
                  disable_correction=True, inf_smiles=str(smi), train_smiles=str(smi),
                  train_drug_smiles=str(smi), inf_batch_size=SERVE, inf_max_batches=1,
                  seed=1)
    jax_plain = JaxInferenceEngine(JaxInferenceConfig(**common, mol_data_dir=str(tmp / "jax")),
                                   vocab=JaxVocab.from_json(vocab_json))
    jax_engine = JaxInferenceEngine(
        JaxInferenceConfig(**common, mol_data_dir=str(tmp / "jax"), use_pallas=True),
        vocab=JaxVocab.from_json(vocab_json), g_params=jax_plain.g_params)
    cfg = InferenceConfig(**common, mol_data_dir=str(tmp / "port"),
                          output_dir=str(tmp / "out"), device="cpu", use_pallas=True)
    port_engine = InferenceEngine(cfg, vocab=Vocab.from_json(vocab_json))
    port_plain = InferenceEngine(dataclasses.replace(cfg, use_pallas=False),
                                 vocab=port_engine.vocab,
                                 g_state_dict=port_engine.G.state_dict())
    return jax_engine, port_engine, port_plain


def test_use_pallas_engine_same_labels_and_smiles_as_jax(served, monkeypatch):
    jax_engine, port_engine, _ = served
    assert port_engine.k9_weights is not None and port_engine.k9_weights.depth == 1
    x, a = port_engine.data.x[:SERVE], port_engine.data.a[:SERVE]
    calls = []
    orig = port.fused_generator_logits_reference
    monkeypatch.setattr(port, "fused_generator_logits_reference",
                        lambda *args, **kw: calls.append(1) or orig(*args, **kw))
    n_p, e_p = port_engine.forward(a, x)
    assert calls == [1]
    n_j, e_j = jax_engine._forward(jax_engine.g_params, a, x)
    assert n_p.dtype == torch.int32 and n_p.shape == (SERVE, 45)
    np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(e_p.numpy(), np.asarray(e_j))
    kept_j, decoded_j, _, _ = jax_engine.sample()
    kept_p, decoded_p = port_engine.sample()
    assert decoded_p == decoded_j and kept_p == kept_j and kept_p
    assert len(port_engine.timings) == 1


def test_use_pallas_engine_same_labels_as_the_plain_engine(served):
    _, port_engine, port_plain = served
    x, a = port_engine.data.x[:SERVE], port_engine.data.a[:SERVE]
    for got, want in zip(port_engine.forward(a, x), port_plain.forward(a, x)):
        assert torch.equal(got, want)


def test_cli_serves_with_use_pallas_on_cpu(tmp_path):
    smi = tmp_path / "inf.smi"
    with open(SMILES_FILE) as src:
        smi.write_text("".join(line for _, line in zip(range(40), src)))
    vocab_dir = tmp_path / "data" / "vocab"
    vocab_dir.mkdir(parents=True)
    with open(VOCAB_JSON) as f:
        (vocab_dir / "vocab_inf_inf_45.json").write_text(f.read())
    before = port.fused_generator_logits.launches
    results = port_cli.main([
        "--submodel", "DrugGEN", "--inference_model", CKPT_DIR,
        "--inf_smiles", str(smi), "--train_smiles", str(smi),
        "--train_drug_smiles", str(smi), "--mol_data_dir", str(tmp_path / "data"),
        "--output_dir", str(tmp_path / "out"), "--inf_batch_size", "4",
        "--inf_max_batches", "1", "--sample_num", "4", "--compute_dtype", "bf16",
        "--use_pallas", "--disable_correction", "--device", "cpu"])
    assert port.fused_generator_logits.launches == before   # the plain version ran
    assert set(results) == {"submodel", "validity", "generator_validity", "uniqueness"}
    assert (tmp_path / "out" / "DrugGEN" / "inference_drugs.csv").read_text().startswith("SMILES")


def test_plain_matches_pallas_bf16_on_the_trained_generator(served):
    """bf16 at full width on the trained r2_scale weights (decisive logits),
    one 8-graph corpus batch: K9's plain version against the Pallas kernel
    in the interpreter, max <= 3e-2 + 2^-7 |ref|, mean <= 4e-3, and the
    labels equal on >= 99 % of the entries."""
    jax_engine, port_engine, _ = served
    x, a = port_engine.data.x[:SERVE], port_engine.data.a[:SERVE]
    z_e = np.eye(port_engine.b_dim, dtype=np.float32)[a]
    z_n = np.eye(port_engine.m_dim, dtype=np.float32)[x]
    want = jax_fg.fused_generator_logits(
        jax_engine.g_params, jnp.asarray(z_e, jnp.bfloat16), jnp.asarray(z_n, jnp.bfloat16),
        heads=port_engine.cfg.heads, interpret=True)
    got = port.fused_generator_logits(port_engine.k9_weights, torch.from_numpy(z_e).bfloat16(),
                                      torch.from_numpy(z_n).bfloat16(),
                                      heads=port_engine.cfg.heads)
    same = total = 0
    for g, w in zip(got, want):
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        err = np.abs(g - w)
        assert (err <= 3e-2 + 2 ** -7 * np.abs(w)).all(), err.max()
        assert err.mean() <= 4e-3, err.mean()
        same += int((g.argmax(-1) == w.argmax(-1)).sum())
        total += g.argmax(-1).size
    assert same / total >= 0.99, same / total
