"""The port's reference-topology corrector (``infer/seq2seq_ref.py``,
``interop/corrector_ckpt.py``), its trainer and evaluator
(``train_corrector.py``), the mining tool and the serving hook
(``infer/corrector.py``) against the JAX package's, on the CPU.

At ``tests/test_corrector_interop.py``'s sizes (hid 64, 4 heads, pf 128, 2
layers, 24 positions): ``init_params`` bit-equal, ``forward`` at rtol 1e-5 /
atol 1e-5 (sums in another order; logits up to ~5), ``greedy_translate``'s
tokens equal through each row's first EOS; a reference-shaped ``.pkg`` with
shim vocab ``.pth`` files through ``ReferenceCorrector.load``; the
reference-topology corrector the JAX package trained
(``experiments/corrector_r4/ref_arch``) through ``load_trained``;
``train_reference_corrector``: at 0 steps byte-equal files, at 3 steps the
weights at relative norm 1e-5 (each leaf at 1e-4 and the key biases to
Adam's bound, as in ``test_torch_port_seq2seq.py``); ``evaluate_corrector``
equal to the JAX script's; the environment's choice of corrector, as
``test_smiles_corrector_env_selection``; the mining and training CLIs end
to end.
"""

import json
import os
import sys
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from druggen_tpu.infer import seq2seq_ref as J
from druggen_tpu.infer.corrector import SmilesCorrector as JaxSmilesCorrector
from druggen_tpu.interop import corrector_ckpt as JC
from druggen_tpu_torch import train_corrector as port_tc
from druggen_tpu_torch.infer import seq2seq_ref as P
from druggen_tpu_torch.infer.corrector import SmilesCorrector
from druggen_tpu_torch.infer.seq2seq import Seq2SeqCorrector
from druggen_tpu_torch.interop import corrector_ckpt as PC

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import train_corrector as jax_tc  # noqa: E402  (the JAX tool, scripts/)

REF_ARCH = os.path.join(REPO, "experiments", "corrector_r4", "ref_arch")
HID, HEADS, PF, LAYERS, MAXLEN, VOC = 64, 4, 128, 2, 24, 37
SMILES = ["CCO", "c1ccccc1O", "CC(=O)N", "CC((", "C1CC", "OCC(N)C=O"]
CORPUS = ["CCO", "CCN", "c1ccccc1", "CC(=O)O", "CCCC", "C1CCCCC1",
          "Clc1ccccc1", "CC(C)O", "CCOC", "OCCO"]
ITOS = (["<unk>", "<pad>", "<sos>", "<eos>"] + list("Cc1()O=Nn2[]#+-oS3sFBrl")
        + ["Cl", "Br"])
ITOS = ITOS + ["X"] * (VOC - len(ITOS))


# one compile in place of an eager dispatch of every op
_jax_forward = jax.jit(J.forward, static_argnames=("heads",))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def ref():
    params = J.init_params(3, VOC, VOC, hid=HID, pf=PF, n_layers=LAYERS,
                           max_len=MAXLEN - 2)
    port = PC.ReferenceCorrector(P.init_params(3, VOC, VOC, hid=HID, pf=PF,
                                               n_layers=LAYERS, max_len=MAXLEN - 2),
                                 {s: i for i, s in enumerate(ITOS)}, ITOS,
                                 heads=HEADS, max_len=MAXLEN - 2, device="cpu")
    return params, port


def _vocab_pth(path):
    PC.install_torchtext_shim()
    import torchtext.vocab as tv

    v = tv.Vocab.__new__(tv.Vocab)
    v.__dict__.update({"freqs": Counter(), "itos": ITOS,
                       "stoi": defaultdict(tv._default_unk_index,
                                           {s: i for i, s in enumerate(ITOS)}),
                       "vectors": None})
    torch.save(v, path)
    return path


def test_init_params_bit_equal(ref):
    params, port = ref
    got = P.init_params(3, VOC, VOC, hid=HID, pf=PF, n_layers=LAYERS, max_len=MAXLEN - 2)
    same = jax.tree_util.tree_map(lambda a, b: a.dtype == b.dtype and np.array_equal(a, b),
                                  got, params)
    assert jax.tree_util.tree_all(same)
    # the module holds those weights, under the reference's keys
    back = PC.convert_corrector_state_dict(port.model.state_dict())
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, back, params))
    assert "decoder.layers.1.encoder_attention.fc_q.weight" in port.model.state_dict()


def test_forward_matches_jax(ref):
    params, port = ref
    rng = np.random.default_rng(0)
    src = rng.integers(4, VOC, (3, 11))
    trg = rng.integers(4, VOC, (3, 9))
    src[:, -2:] = J.PAD
    trg[0, -3:] = J.PAD
    want = np.asarray(_jax_forward(params, jnp.asarray(src), jnp.asarray(trg), heads=HEADS))
    with torch.no_grad():
        got = port.model(torch.as_tensor(src), torch.as_tensor(trg)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_greedy_translate_matches_jax(ref):
    params, port = ref
    rng = np.random.default_rng(1)
    src = rng.integers(4, VOC, (4, 10))
    src[:, 0], src[:, -1] = J.SOS, J.EOS
    want = np.asarray(J.greedy_translate(params, jnp.asarray(src), heads=HEADS,
                                         max_len=MAXLEN - 2))
    got = P.greedy_translate(port.model, torch.as_tensor(src), max_len=MAXLEN - 2).numpy()
    np.testing.assert_array_equal(_through_eos(got), _through_eos(want))
    assert [J.decode_tokens(r, ITOS) for r in got] == [J.decode_tokens(r, ITOS) for r in want]


def _through_eos(rows):
    """Each row up to and with its first EOS, PAD after it (the port stops
    once every row has an EOS; JAX's scan writes on)."""
    rows = np.array(rows)
    for r in rows:
        hit = np.flatnonzero(r == J.EOS)
        if hit.size:
            r[hit[0] + 1:] = J.PAD
    return rows


def test_reference_pkg_loads_through_the_shim(ref, tmp_path):
    """A reference-shaped .pkg (the module's state_dict, torch.save) with
    torchtext vocab .pth files: the port's and the JAX package's
    ReferenceCorrector.load translate alike."""
    _, port = ref
    pkg = str(tmp_path / "model.pkg")
    torch.save(port.model.state_dict(), pkg)
    src_p, trg_p = _vocab_pth(str(tmp_path / "src.pth")), _vocab_pth(str(tmp_path / "trg.pth"))
    itos, stoi = PC.load_torchtext_vocab(src_p)
    assert itos == ITOS and stoi["C"] == 4 and stoi["<pad>"] == 1
    got = PC.ReferenceCorrector.load(pkg, src_p, trg_p, heads=HEADS, max_len=MAXLEN - 2,
                                     device="cpu")
    want = JC.ReferenceCorrector.load(pkg, src_p, trg_p, heads=HEADS, max_len=MAXLEN - 2)
    np.testing.assert_array_equal(got._encode_src(SMILES), want._encode_src(SMILES))
    assert got.translate_batch(SMILES) == want.translate_batch(SMILES)
    assert got.translate_batch([]) == []


def test_load_trained_ref_arch_matches_jax():
    """The reference-topology corrector the JAX package trained (vocab 82,
    hid 256, 8 heads, pf 512, 3 layers, max_len 202): teacher-forced logits
    of two held-out pairs, and greedy tokens with a buffer of 48."""
    want = JC.ReferenceCorrector.load_trained(REF_ARCH)
    got = PC.ReferenceCorrector.load_trained(REF_ARCH, device="cpu")
    assert got.trg_itos == want.trg_itos and got.max_len == want.max_len == 202
    with open(os.path.join(REF_ARCH, "..", "holdout_pairs.json")) as f:
        holdout = json.load(f)[:2]
    src = got._encode_src([s for s, _ in holdout])
    np.testing.assert_array_equal(src, want._encode_src([s for s, _ in holdout]))
    trg = got._encode_src([t[::-1] for _, t in holdout])
    jl = np.asarray(_jax_forward(want.params, jnp.asarray(src), jnp.asarray(trg)))
    with torch.no_grad():
        pl = got.model(torch.as_tensor(src).long(), torch.as_tensor(trg).long()).numpy()
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=1e-4)
    jt = np.asarray(J.greedy_translate(want.params, jnp.asarray(src[:, :60]), max_len=48))
    pt = P.greedy_translate(got.model, torch.as_tensor(src[:, :60]).long(), max_len=48)
    np.testing.assert_array_equal(_through_eos(pt.numpy()), _through_eos(jt))
    assert (jt == J.EOS).any(axis=1).all()          # both rows end before the buffer


def test_train_reference_corrector_matches_jax(tmp_path, capsys):
    """0 steps: the JAX tool's files byte for byte.  3 steps from the same
    init_params weights and batches: the first loss and the weights."""
    corpus, pairs = CORPUS, [("CCOO)C", "CCOC(O)C"), ("c1ccc(", "c1ccccc1")]
    kw = dict(batch=4, lr=1e-3, hid=32, n_layers=1, max_len=20)
    for steps in (0, 3):
        jd, pd = tmp_path / f"jax{steps}", tmp_path / f"port{steps}"
        jax_tc.train_reference_corrector(corpus, pairs, steps=steps, out_dir=str(jd), **kw)
        want_loss = capsys.readouterr().out
        ref = port_tc.train_reference_corrector(corpus, pairs, steps=steps, out_dir=str(pd),
                                                device="cpu", **kw)
        assert (pd / "vocab.json").read_bytes() == (jd / "vocab.json").read_bytes()
        if steps == 0:
            assert (pd / "params.msgpack").read_bytes() == (jd / "params.msgpack").read_bytes()
            continue
        # the JAX tool prints the loss of step 0 to 4 decimals
        first = float(want_loss.split("ref-corrector step 0: loss ")[1].split()[0])
        assert abs(ref.train_log["losses"][0] - first) <= 5e-5
        assert np.isfinite(ref.train_log["losses"]).all() and len(ref.train_log["losses"]) == 3
        got = PC.ReferenceCorrector.load_trained(str(pd), device="cpu")
        want = JC.ReferenceCorrector.load_trained(str(jd))
        gl = jax.tree_util.tree_leaves(PC.convert_corrector_state_dict(got.model.state_dict()))
        wl = jax.tree_util.tree_flatten_with_path(jax.device_get(want.params))[0]
        init = jax.tree_util.tree_leaves(J.init_params(0, len(got.trg_itos), len(got.trg_itos),
                                                       hid=32, n_layers=1, max_len=20))
        assert len(gl) == len(wl) == len(init)
        held_g, held_w = [], []
        for g, (path, w), w0 in zip(gl, wl, init):
            if "fc_k" in jax.tree_util.keystr(path) and path[-1].key == "bias":
                # the key bias: exact gradient 0 (the softmax cancels it),
                # see test_torch_port_seq2seq.py; held to Adam's bound
                for leaf in (g, w):
                    assert np.abs(leaf - w0).max() <= 3 * kw["lr"] * 1.01
                continue
            assert _rel(g, w) <= 1e-4, jax.tree_util.keystr(path)
            held_g.append(g.ravel())
            held_w.append(w.ravel())
        assert _rel(np.concatenate(held_g), np.concatenate(held_w)) <= 1e-5
        assert max(_rel(w, i) for (_, w), i in zip(wl, init)) > 1e-4   # the steps moved them


def test_evaluate_corrector_matches_the_jax_script(ref):
    """The six keys, in the JAX tool's order, equal on a small holdout."""
    _, port = ref
    holdout = [("CC((", "CCO"), ("c1ccc(", "c1ccccc1"), ("N1CC", "CCN"), ("CCOO)C", "CCOC")]

    class Fixed:
        def __init__(self, outs):
            self.outs = outs

        def translate_batch(self, xs):
            return self.outs[:len(xs)]

    for outs in (["CCO", "c1ccccc1O", "", "C(("], port.translate_batch([s for s, _ in holdout])):
        got = port_tc.evaluate_corrector(Fixed(outs), holdout)
        want = jax_tc.evaluate_corrector(Fixed(outs), holdout)
        assert list(got) == list(want) == ["n_holdout", "validity_before", "validity_after",
                                           "exact_repair_rate", "mean_tanimoto_to_target",
                                           "n_similarity_pairs"]
        assert got == want


def test_env_selection(ref, tmp_path, monkeypatch):
    """As the JAX package: $DRUGGEN_REFERENCE_CORRECTOR (pkg:src:trg or a
    trained directory) first, then $DRUGGEN_CORRECTOR_CKPT; the corrector
    rewrites the invalid SMILES, and correct() returns the JAX pipeline's
    output on the same weights."""
    _, port = ref
    pkg = str(tmp_path / "m.pkg")
    torch.save(port.model.state_dict(), pkg)
    spec = ":".join([pkg, _vocab_pth(str(tmp_path / "s.pth")),
                     _vocab_pth(str(tmp_path / "t.pth"))])
    monkeypatch.setenv("DRUGGEN_REFERENCE_CORRECTOR", spec)
    monkeypatch.setenv("DRUGGEN_CORRECTOR_CKPT", str(tmp_path / "nowhere"))
    corr = SmilesCorrector.default(device="cpu")
    assert isinstance(corr.neural, PC.ReferenceCorrector)
    # the JAX package's ReferenceCorrector of this spec uses heads 8; give
    # both the same module and compare the pipelines
    jax_corr = JaxSmilesCorrector(neural=JC.ReferenceCorrector.load(
        pkg, str(tmp_path / "s.pth"), str(tmp_path / "t.pth"), heads=HEADS,
        max_len=MAXLEN - 2))
    corr.neural = PC.ReferenceCorrector.load(pkg, str(tmp_path / "s.pth"),
                                             str(tmp_path / "t.pth"), heads=HEADS,
                                             max_len=MAXLEN - 2, device="cpu")
    batch = ["CCO", "CC((", "OCC", "C1CC", "c1ccccc1O"]
    out = corr.correct(batch)
    assert out == jax_corr.correct(batch) and "CCO" in out

    # a trained reference-topology directory
    monkeypatch.setenv("DRUGGEN_REFERENCE_CORRECTOR", REF_ARCH)
    corr = SmilesCorrector.default(device="cpu")
    assert isinstance(corr.neural, PC.ReferenceCorrector) and corr.neural.max_len == 202

    # $DRUGGEN_CORRECTOR_CKPT alone: a native corrector directory
    native = tmp_path / "native"
    Seq2SeqCorrector.load(os.path.join(REPO, "experiments", "corrector_r4"),
                          device="cpu").save(str(native))
    monkeypatch.delenv("DRUGGEN_REFERENCE_CORRECTOR")
    monkeypatch.setenv("DRUGGEN_CORRECTOR_CKPT", str(native))
    corr = SmilesCorrector.default(device="cpu")
    assert isinstance(corr.neural, Seq2SeqCorrector)
    monkeypatch.delenv("DRUGGEN_CORRECTOR_CKPT")
    assert SmilesCorrector.default(device="cpu").neural is None


def test_decode_tokens_reversed():
    itos = ["<unk>", "<pad>", "<sos>", "<eos>", "C", "O", "N"]
    ids = [4, 5, 6, P.EOS, 4]          # C O N <eos> (then junk)
    assert P.decode_tokens(ids, itos, reverse=True) == "NOC"
    assert P.decode_tokens(ids, itos, reverse=False) == "CON"
    assert P.decode_tokens(ids, itos) == J.decode_tokens(ids, itos)


def test_mine_and_train_corrector_clis(tmp_path):
    """``mine_corrector_pairs`` over two cadence exports (copies of the
    tracked JAX-trained NoTarget Generator, whose failures repair) writes
    the JAX tool's JSON layout, each checkpoint on a fresh slice of graphs;
    ``train_corrector.main --arch both`` on those pairs holds out JAX's
    ``random.Random(13)`` split and writes both layouts and the six-key
    ``eval.json``s."""
    import random
    import shutil

    from druggen_tpu_torch import mine_corrector_pairs
    from druggen_tpu_torch.chem.smiles import mol_from_smiles

    gen = os.path.join(REPO, "experiments", "r2_notarget", "models",
                       "r2_notarget_NoTarget_glr1e-05_dlr1e-05_dim128_depth1_heads8_batch512"
                       "_epoch15_datasetchembl_like_150k45_dropout0.0", "NoTarget-G.ckpt")
    models = tmp_path / "models"
    models.mkdir()
    for name in ("1-16-G.ckpt", "1-8-G.ckpt", "DrugGEN-G.ckpt"):
        shutil.copy(gen, models / name)
    smi = tmp_path / "corpus.smi"
    with open(os.path.join(REPO, "data", "chembl_like_150k.smi")) as f:
        smi.write_text("".join(line for _, line in zip(range(96), f)))
    (tmp_path / "vocab").mkdir()
    shutil.copy(os.path.join(REPO, "data", "cache", "vocab",
                             "vocab_akt1_drugs_chembl_like_150k_45.json"),
                tmp_path / "vocab" / "vocab_corpus_corpus_45.json")
    got = mine_corrector_pairs.main([
        "--model_dir", str(models), "--smiles", str(smi), "--samples_per_ckpt", "64",
        "--batch", "32", "--out", str(tmp_path / "pairs.json"), "--device", "cpu"])
    written = json.loads((tmp_path / "pairs.json").read_text())
    assert list(written) == ["pairs", "per_ckpt", "model_dir", "samples_per_ckpt"]
    assert [c["ckpt"] for c in written["per_ckpt"]] == ["1-8-G.ckpt", "1-16-G.ckpt"]
    assert all(c["samples"] == 64 for c in written["per_ckpt"])
    pairs = [tuple(p) for p in written["pairs"]]
    assert pairs == [tuple(p) for p in got["pairs"]] and len(pairs) >= 4
    assert len({s for s, _ in pairs}) == len(pairs) == sum(c["fresh"] for c in written["per_ckpt"])
    assert all(mol_from_smiles(t) is not None for _, t in pairs)

    out = tmp_path / "corrector"
    result = port_tc.main(["--smiles", str(smi), "--pairs-file", str(tmp_path / "pairs.json"),
                           "--arch", "both", "--steps", "2", "--batch", "4", "--hid", "32",
                           "--layers", "1", "--max-len", "40", "--out", str(out),
                           "--device", "cpu"])
    random.Random(13).shuffle(pairs)
    holdout = pairs[:max(1, int(len(pairs) * 0.1))]
    assert result["holdout"] == holdout and result["pairs"] == len(pairs)
    assert json.loads((out / "holdout_pairs.json").read_text()) == [list(p) for p in holdout]
    for d in (out, out / "ref_arch"):
        metrics = json.loads((d / "eval.json").read_text())
        assert list(metrics) == ["n_holdout", "validity_before", "validity_after",
                                 "exact_repair_rate", "mean_tanimoto_to_target",
                                 "n_similarity_pairs"] and metrics["n_holdout"] == len(holdout)
    assert Seq2SeqCorrector.load(str(out), device="cpu").model.meta()["hid"] == 32
    assert PC.ReferenceCorrector.load_trained(str(out / "ref_arch"), device="cpu").max_len == 40
    assert len(result["native"].train_log["losses"]) == 2
