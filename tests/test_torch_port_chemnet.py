"""The port's ChemNet (``druggen_tpu_torch/metrics/chemnet.py``) and FCD
against the JAX package's, on the CPU.

Both ChemNets are built from one seed (the same numpy draws) or one weight
file and must agree in f32 at rtol 2e-4, atol 2e-5 (the tolerance of
``tests/test_chemnet_torch_parity.py``): a small config with an odd and an
even conv kernel (keras SAME padding puts the extra zero on the right) and
two LSTMs, on SMILES of very different lengths, an empty SMILES included
(the JAX masked scan keeps its zero state).  The weight files round-trip
both ways.  FCD with the surrogate embedder is the JAX value exactly, with a
random-init ChemNet within rtol 1e-3.  A call switches TF32 off for itself
only.
"""

import numpy as np
import pytest
import torch

from druggen_tpu.metrics import chemnet as jax_chemnet
from druggen_tpu.metrics import fcd as jax_fcd
from druggen_tpu_torch.metrics import chemnet, fcd

CONFIG = [
    {"type": "conv", "filters": 8, "kernel": 5, "activation": "selu"},
    {"type": "conv", "filters": 12, "kernel": 4, "activation": "selu"},
    {"type": "lstm", "units": 16, "return_sequences": True},
    {"type": "lstm", "units": 24, "return_sequences": False},
]
SMILES = [
    "CC(=O)Oc1ccccc1C(=O)O",
    "c1ccccc1",
    "C",
    "CCN(CC)CCOC(=O)C(Cl)c1ccc(Br)cc1",
    "CC(=O)Oc1ccccc1C(=O)O" * 8,
    "N#Cc1ccccc1[Si](C)(C)C",
    "CC(C)Cc1ccc(cc1)C(C)C(=O)O",
]
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module")
def nets():
    return (jax_chemnet.ChemNet.random_init(3, CONFIG),
            chemnet.ChemNet.random_init(3, CONFIG, device="cpu"))


def test_tokens_and_one_hot_are_the_jax_ones():
    assert chemnet.CHEMNET_SYMBOLS == jax_chemnet.CHEMNET_SYMBOLS
    assert (chemnet.VOCAB_SIZE, chemnet.PAD_LEN) == (jax_chemnet.VOCAB_SIZE, jax_chemnet.PAD_LEN)
    assert chemnet.default_config() == jax_chemnet.default_config()
    for s in SMILES + ["", "[Na+].[Cl-]", "C%10CC%10"]:
        assert chemnet.tokenize(s) == jax_chemnet.tokenize(s)
    np.testing.assert_array_equal(chemnet.one_hot_batch(SMILES),
                                  jax_chemnet.one_hot_batch(SMILES))


def test_same_seed_same_weights(nets):
    for got, ref in zip(nets[1].params, nets[0].params):
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("batch_size", [3, 16])
def test_activations_match_jax(nets, batch_size):
    got = nets[1](SMILES, batch_size=batch_size)
    ref = nets[0](SMILES, batch_size=batch_size)
    assert got.shape == ref.shape == (len(SMILES), 24) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_an_empty_smiles_gives_the_jax_zero_state(nets):
    """The JAX ``__call__`` pads its last chunk with "" (all-pad rows); the
    port's forward must give such a row what the masked scan gives it."""
    x = chemnet.one_hot_batch(["", "CCO", ""])
    ref = np.asarray(nets[0]._jit(x, [tuple(w) for w in nets[0].params]))
    got = nets[1].forward(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got[[0, 2]], 0.0)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert nets[1]([""]).shape == (0, 24)


@pytest.mark.parametrize("kernel", [3, 4, 9, 10])
def test_same_padding_matches_xla(kernel):
    """An odd and an even kernel (default_config's third conv has 10: XLA
    pads 4 on the left and 5 on the right)."""
    cfg = [{"type": "conv", "filters": 6, "kernel": kernel, "activation": "selu"}]
    j = jax_chemnet.ChemNet.random_init(kernel, cfg)
    p = chemnet.ChemNet.random_init(kernel, cfg, device="cpu")
    x = chemnet.one_hot_batch(SMILES[:3])
    ref = np.asarray(jax_chemnet._conv1d(x, *j.params[0], "selu"))
    with torch.inference_mode():
        k = p.layers[0].kernel_size[0]
        y = p.layers[0](torch.nn.functional.pad(torch.from_numpy(x).transpose(1, 2),
                                                ((k - 1) // 2, k // 2)))
        got = torch.nn.functional.selu(y).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_last_layer_returning_sequences_reads_the_last_step():
    cfg = [dict(layer) for layer in CONFIG]
    cfg[-1]["return_sequences"] = True
    j = jax_chemnet.ChemNet.random_init(5, cfg)
    p = chemnet.ChemNet.random_init(5, cfg, device="cpu")
    smiles = SMILES[:2] + ["C" * 400]       # only a full row has a step 349
    got, ref = p(smiles), j(smiles)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert np.abs(got[2]).max() > 0 and not got[:2].any()


def test_npz_round_trips_both_ways(nets, tmp_path):
    nets[1].save_npz(str(tmp_path / "port.npz"))
    nets[0].save_npz(str(tmp_path / "jax.npz"))
    from_port = jax_chemnet.ChemNet.load(str(tmp_path / "port.npz"))
    from_jax = chemnet.ChemNet.load(str(tmp_path / "jax.npz"), device="cpu")
    assert from_port.config == from_jax.config == CONFIG
    ref = nets[0](SMILES)
    np.testing.assert_allclose(from_jax(SMILES), ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(from_port(SMILES), ref)


def test_fcd_torch_style_pt_loads_as_in_jax(tmp_path):
    """The entries file of ``tests/test_chemnet_torch_parity.py``: keras
    layers with their weights, conv kernels ``[k, in, out]``."""
    rng = np.random.default_rng(0)
    entries, c = [], chemnet.VOCAB_SIZE
    for name, size in (("conv_1", (5, 8)), ("conv_2", (4, 12)), ("lstm_1", 16),
                       ("lstm_2", 24)):
        if name.startswith("conv"):
            k, f = size
            entries.append((name, {"weights": [
                (rng.standard_normal((k, c, f)) / np.sqrt(k * c)).astype(np.float32),
                (rng.standard_normal(f) * 0.1).astype(np.float32)]}))
            c = f
        else:
            entries.append((name, {"weights": [
                (rng.standard_normal((c, 4 * size)) / np.sqrt(c)).astype(np.float32),
                (rng.standard_normal((size, 4 * size)) / np.sqrt(size)).astype(np.float32),
                (rng.standard_normal(4 * size) * 0.1).astype(np.float32)]}))
            c = size
    path = str(tmp_path / "chemnet.pt")
    torch.save(entries, path)
    j = jax_chemnet.ChemNet.load(path)
    p = chemnet.ChemNet.load(path, device="cpu")
    assert p.config == j.config
    assert [layer["type"] for layer in p.config] == ["conv", "conv", "lstm", "lstm"]
    np.testing.assert_allclose(p(SMILES), j(SMILES), rtol=RTOL, atol=ATOL)


def test_fcd_matches_jax(nets):
    from druggen_tpu.data.corpus import DRUGLIKE_SMILES

    gen, ref = DRUGLIKE_SMILES[:30], DRUGLIKE_SMILES[20:]
    assert fcd.FCD()(gen, ref) == jax_fcd.FCD()(gen, ref)
    got = fcd.FCD(featurizer=nets[1])(gen, ref)
    want = jax_fcd.FCD(featurizer=nets[0])(gen, ref)
    assert np.isfinite(got) and got == pytest.approx(want, rel=1e-3)


def test_a_call_turns_tf32_off_for_itself_only(nets, monkeypatch):
    seen = []
    lstm = nets[1].layers[2]
    forward = lstm.forward

    def record(*args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return forward(*args, **kwargs)

    monkeypatch.setattr(lstm, "forward", record)
    for flag in (True, False):
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", flag)
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", flag)
        nets[1](SMILES[:2])
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (
            flag, flag)
    assert seen == [(False, False)] * 2


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chemnet.ChemNet.random_init(0, CONFIG)
