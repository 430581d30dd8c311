"""The port's native SMILES corrector (``druggen_tpu_torch/infer/seq2seq.py``)
against the JAX package's, on the CPU.

At hid 32, 4 heads, pf 64, 2 layers, max_len 16, in f32, from the same
weights (the port's initialisation through the weight bridge): the tokenizer
and the pair functions give the same output, the logits agree at rtol 1e-5 /
atol 1e-6 (sums in another order), greedy decoding gives the same tokens,
3 steps of ``train_corrector`` match JAX's jitted ``optax.adamw`` step
(the losses at 1e-5, all the weights at relative norm 1e-5 and each leaf
at 1e-4, but the key biases, whose exact gradient is 0), and ``save`` writes the
JAX ``Seq2SeqCorrector.save`` bytes.  Then the full-width corrector the JAX
package trained (``experiments/corrector_r4``), loaded by both: logits on
two held-out pairs and greedy tokens with a decode buffer of 48.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

from druggen_tpu.chem.vocab import CHEMBL_VOCAB as JAX_VOCAB
from druggen_tpu.data.corpus import DRUGLIKE_SMILES
from druggen_tpu.data.dataset import featurize_smiles as jax_featurize
from druggen_tpu.infer import seq2seq as J
from druggen_tpu_torch.chem.vocab import CHEMBL_VOCAB
from druggen_tpu_torch.infer import seq2seq as P
from druggen_tpu_torch.interop.corrector_weights import flax_to_seq2seq, seq2seq_to_flax

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R4 = os.path.join(REPO, "experiments", "corrector_r4")
CORPUS = ["CCO", "CCN", "c1ccccc1", "CC(=O)O", "CCCC", "C1CCCCC1",
          "Clc1ccccc1", "CC(C)O", "CCOC", "OCCO"]
HID, HEADS, PF, LAYERS, MAX_LEN = 32, 4, 64, 2, 16
RTOL, ATOL = 1e-5, 1e-6


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


@pytest.fixture(scope="module")
def small():
    """The JAX model, the port's model, and the port's initial weights as
    the JAX variables (through the bridge: an eager JAX ``init`` costs ~5 s
    here, and the bridge is held against flax's own tree below)."""
    tok = J.Tokenizer.build(CORPUS)
    model = J.Seq2Seq(vocab_size=tok.size, hid=HID, heads=HEADS, pf=PF,
                      n_layers=LAYERS, max_len=MAX_LEN)
    src = np.stack([tok.encode(s, MAX_LEN) for s in CORPUS])
    port = P.Seq2Seq(tok.size, HID, HEADS, PF, LAYERS, MAX_LEN).eval()
    return tok, model, seq2seq_to_flax(port.state_dict(), HEADS), port, src


def test_tokenizer_and_corruption_pairs_match():
    extra = ["[NH4+]", "%12CC%12", "C@@H", "Brc1ccsc1"]
    jt, pt = J.Tokenizer.build(CORPUS + extra), P.Tokenizer.build(CORPUS + extra)
    assert pt.to_json() == jt.to_json()
    for s in CORPUS + extra:
        np.testing.assert_array_equal(pt.encode(s, 12), jt.encode(s, 12))
        assert pt.decode(pt.encode(s, 32)) == jt.decode(jt.encode(s, 32))
    jr, pr = np.random.default_rng(5), np.random.default_rng(5)
    assert P.corruption_pairs(DRUGLIKE_SMILES, pr) == J.corruption_pairs(DRUGLIKE_SMILES, jr)
    assert pr.integers(0, 2 ** 31) == jr.integers(0, 2 ** 31)   # the same draws


def test_generator_failure_pairs_match():
    """Label matrices of real molecules with random bonds added: the same
    (invalid, repaired) pairs from both packages."""
    data = jax_featurize(DRUGLIKE_SMILES[:24], JAX_VOCAB, 30, use_native=False)
    rng = np.random.default_rng(0)
    a = data.a.copy()
    b, n = a.shape[:2]
    for _ in range(6 * b):
        g, i, j = rng.integers(0, b), rng.integers(0, n), rng.integers(0, n)
        if i != j and data.x[g, i] and data.x[g, j]:
            a[g, i, j] = a[g, j, i] = rng.integers(1, JAX_VOCAB.b_dim)
    want = J.generator_failure_pairs(data.x, a, JAX_VOCAB)
    got = P.generator_failure_pairs(data.x, a, CHEMBL_VOCAB)
    assert got == want and len(want) >= 3


def test_weight_bridge_round_trip(small):
    """The bridge's flax tree has flax's structure, shapes and dtypes, and
    goes back to the same state_dict bit for bit."""
    _, model, params, port, src = small
    want = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(src[:1]),
                          jnp.asarray(src[:1]))
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(want)
    for x, y in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(want)):
        assert x.shape == y.shape and x.dtype == y.dtype
    back = flax_to_seq2seq(params)
    assert set(back) == set(port.state_dict())
    assert all(torch.equal(back[k], v) for k, v in port.state_dict().items())


def test_logits_match(small):
    _, model, params, port, src = small
    tgt = np.roll(src, 1, axis=0)
    want = np.asarray(model.apply(params, jnp.asarray(src), jnp.asarray(tgt)))
    with torch.no_grad():
        got = port(torch.as_tensor(src).long(), torch.as_tensor(tgt).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_greedy_tokens_match(small):
    _, model, params, port, src = small
    want = np.asarray(J.greedy_decode(model, params, jnp.asarray(src)))
    got = P.greedy_decode(port, torch.as_tensor(src).long()).numpy()
    np.testing.assert_array_equal(got, want)


def test_train_steps_match_jax_adamw(small):
    """3 steps of the port's train_corrector from the JAX initial weights
    against the JAX package's step (train_corrector's jitted
    value_and_grad + optax.adamw) on the same batches."""
    # JAX train_corrector's set-up and draws, in its order, from the
    # fixture's weights
    tok, model, params, _, _ = small
    steps, batch, lr, seed = 3, 4, 1e-3, 0
    rng = np.random.default_rng(seed)
    pairs = J.corruption_pairs(CORPUS, rng)
    src = np.stack([tok.encode(c, MAX_LEN) for c, _ in pairs])
    tgt = np.stack([tok.encode(g, MAX_LEN) for _, g in pairs])
    opt = optax.adamw(lr)

    @jax.jit
    def train_step(params, opt_state, src_b, tgt_b):
        def loss_fn(p):
            logits = model.apply(p, src_b, tgt_b)
            labels = tgt_b[:, 1:]
            lg = logits[:, :-1]
            mask = labels != J.PAD
            ll = optax.softmax_cross_entropy_with_integer_labels(lg, labels)
            return (ll * mask).sum() / jnp.maximum(mask.sum(), 1)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    jp, state, want_losses = params, opt.init(params), []
    for _ in range(steps):
        idx = rng.integers(0, len(src), size=batch)
        jp, state, loss = train_step(jp, state, jnp.asarray(src[idx]), jnp.asarray(tgt[idx]))
        want_losses.append(float(loss))

    got = P.train_corrector(CORPUS, steps=steps, batch=batch, lr=lr, hid=HID,
                            heads=HEADS, pf=PF, n_layers=LAYERS, max_len=MAX_LEN,
                            seed=seed, log_every=0, device="cpu",
                            init=flax_to_seq2seq(params))
    assert got.tokenizer.to_json() == tok.to_json()
    assert len(got.train_log["losses"]) == steps and got.train_log["step_ms"] is None
    for g, w in zip(got.train_log["losses"], want_losses):
        assert abs(g - w) <= 1e-5 * abs(w), (got.train_log["losses"], want_losses)
    got_flax = seq2seq_to_flax(got.model.state_dict(), HEADS)
    moved, flat_got, flat_want = 0.0, [], []
    for path, w in jax.tree_util.tree_flatten_with_path(jax.device_get(jp))[0]:
        g, w0 = _leaf(got_flax, path), _leaf(params, path)
        name = jax.tree_util.keystr(path)
        if "['key']['bias']" in name:
            # a key bias shifts every logit of a query row alike, so the
            # softmax cancels it: its exact gradient is 0, both packages
            # compute rounding noise (~1e-9), and Adam's normalisation turns
            # that into steps of up to lr each.  Held to Adam's bound.
            for leaf in (g, w):
                assert np.abs(leaf - w0).max() <= steps * lr * 1.01, name
            continue
        # Adam divides each coordinate's step by its own gradient's size, so
        # where a small gradient's terms cancel, their f32 rounding (1e-5 to
        # 1e-4 of it) passes into the step unscaled: a leaf is held at 1e-4,
        # all the weights together at 1e-5
        assert _rel(g, w) <= 1e-4, name
        flat_got.append(g.ravel())
        flat_want.append(w.ravel())
        moved = max(moved, _rel(w, w0))
    assert _rel(np.concatenate(flat_got), np.concatenate(flat_want)) <= 1e-5
    assert moved > 1e-4          # the steps changed the weights


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def test_save_writes_the_jax_bytes(small, tmp_path):
    tok, model, params, port, _ = small
    J.Seq2SeqCorrector(model, params, tok).save(str(tmp_path / "jax"))
    P.Seq2SeqCorrector(port, P.Tokenizer.from_json(tok.to_json())).save(str(tmp_path / "port"))
    for name in ("meta.json", "tokenizer.json", "params.msgpack"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_load_reads_a_jax_save(small, tmp_path):
    """A JAX save (the same bytes as the port's, above) loads back into the
    weights it was written from."""
    tok, model, params, port, _ = small
    J.Seq2SeqCorrector(model, params, tok).save(str(tmp_path / "jax"))
    loaded = P.Seq2SeqCorrector.load(str(tmp_path / "jax"), device="cpu")
    for k, v in port.state_dict().items():
        assert torch.equal(loaded.model.state_dict()[k], v), k
    assert loaded.model.meta() == json.loads((tmp_path / "jax" / "meta.json").read_text())
    assert loaded.translate_batch(CORPUS[:4]) == [loaded.translate(s) for s in CORPUS[:4]]
    assert loaded.translate_batch([]) == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            P.Seq2SeqCorrector.load(str(tmp_path / "jax"))


@pytest.fixture(scope="module")
def trained_r4():
    with open(os.path.join(R4, "meta.json")) as f:
        model = J.Seq2Seq(**json.load(f))
    with open(os.path.join(R4, "tokenizer.json")) as f:
        tok = J.Tokenizer.from_json(f.read())
    with open(os.path.join(R4, "params.msgpack"), "rb") as f:
        params = serialization.msgpack_restore(f.read())
    pc = P.Seq2SeqCorrector.load(R4, device="cpu")
    with open(os.path.join(R4, "holdout_pairs.json")) as f:
        holdout = json.load(f)
    return J.Seq2SeqCorrector(model, params, tok), pc, holdout


def test_trained_corrector_logits_match(trained_r4):
    """The JAX-trained full-width corrector (vocab 82, hid 256, 8 heads, pf
    512, 3 layers, max_len 202): teacher-forced logits of two held-out
    pairs (sums of 256 and 512 terms in another order)."""
    jc, pc, holdout = trained_r4
    src = np.stack([jc.tokenizer.encode(s, 202) for s, _ in holdout[:2]])
    tgt = np.stack([jc.tokenizer.encode(t, 202) for _, t in holdout[:2]])
    want = np.asarray(jc.model.apply(jc.params, jnp.asarray(src), jnp.asarray(tgt)))
    with torch.no_grad():
        got = pc.model(torch.as_tensor(src).long(), torch.as_tensor(tgt).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_trained_corrector_greedy_tokens_match(trained_r4):
    jc, pc, holdout = trained_r4
    src = np.stack([jc.tokenizer.encode(s, 202) for s, _ in holdout[:2]])
    want = np.asarray(J.greedy_decode(jc.model, jc.params, jnp.asarray(src), max_len=48))
    got = P.greedy_decode(pc.model, torch.as_tensor(src).long(), max_len=48).numpy()
    np.testing.assert_array_equal(got, want)
