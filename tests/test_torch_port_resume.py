"""Full-state checkpoints and ``--resume`` of the port, on the CPU.

A state file goes both ways between the packages: the JAX package's
``save_state`` -> the port's ``restore_state`` -> the port's ``save_state`` ->
the JAX ``restore_state`` keeps every leaf's bits, guarded and unguarded and
across both migrations of the guard's layout.  A resumed run equals the
uninterrupted one bit for bit (parameters, Adam moments, step, checkpoint
files), with and without dropout.  Also: the ``{epoch}-{iter}`` resume with
fresh moments, the "already complete" return, and pruning to three files.
The JAX ``GANState`` is built with ``init_state`` (no JAX step compiles).
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
from flax import serialization

from druggen_tpu.config import TrainConfig as JaxTrainConfig
from druggen_tpu.data.corpus import DRUGLIKE_SMILES, TARGET_SMILES, write_corpus
from druggen_tpu.models import Discriminator as JaxD
from druggen_tpu.models import Generator as JaxG
from druggen_tpu.train import checkpoint as jax_ckpt
from druggen_tpu.train.step import init_state
from druggen_tpu.train.step import make_optimizers as jax_make_optimizers
from druggen_tpu_torch.config import TrainConfig
from druggen_tpu_torch.interop.weights import gan_state_to_port, port_to_gan_state
from druggen_tpu_torch.train import checkpoint as ckpt
from druggen_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

N, M_DIM, B_DIM, DIM, HEADS = 7, 5, 4, 16, 4
BATCH, STEPS, CADENCE = 8, 4, 2      # one epoch of 4 steps, states at 2 and 4


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix, np.asarray(tree)


def _assert_bit_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


def _jax_state(guarded: bool, seed: int = 0):
    """A JAX ``GANState`` at the interop sizes with every leaf filled:
    random parameters and moments, nonzero counts, counters and step."""
    cfg = JaxTrainConfig(raw_file="x.smi", drug_raw_file="y.smi",
                         nonfinite_guard=guarded)
    jg = JaxG(act="relu", vertexes=N, edges=B_DIM, nodes=M_DIM, dropout=0.0,
              dim=DIM, depth=1, heads=HEADS, mlp_ratio=2)
    jd = JaxD(act="relu", vertexes=N, edges=B_DIM, nodes=M_DIM, dropout=0.0,
              dim=DIM, depth=1, heads=HEADS, mlp_ratio=2)
    g_opt, d_opt = jax_make_optimizers(cfg)
    state = jax.device_get(init_state(jg, jd, g_opt, d_opt, jax.random.PRNGKey(seed),
                                      N, M_DIM, B_DIM))
    rng = np.random.default_rng(seed)

    def fill(x):
        x = np.asarray(x)
        if x.dtype == np.int32:
            return np.asarray(rng.integers(1, 1000), np.int32).reshape(x.shape)
        return rng.standard_normal(x.shape).astype(x.dtype)

    return jax.tree_util.tree_map(fill, state)


@pytest.fixture(scope="module")
def jax_states():
    return {guarded: _jax_state(guarded, seed=int(guarded)) for guarded in (True, False)}


@pytest.mark.parametrize("saved, restored", [(True, True), (False, False),
                                             (False, True), (True, False)])
def test_state_round_trip_jax_port_jax(jax_states, tmp_path, saved, restored):
    """``saved``/``restored``: the guard flag of the writer and of the
    reader; where they differ the reader migrates the layout (wrapping with
    zeroed counters, or unwrapping)."""
    state = jax_states[saved]
    jax_ckpt.save_state(str(tmp_path / "jax"), state)
    template = gan_state_to_port(jax_states[restored])
    port = ckpt.restore_state(str(tmp_path / "jax"), template, guarded=restored)
    want = gan_state_to_port(state)
    if not (saved and restored):
        # an unguarded side has no counters: they read 0
        for opt in ("g_opt", "d_opt"):
            for name in ("notfinite_count", "total_notfinite"):
                want[opt][name] = np.zeros((), np.int32)
    assert port["step"] == want["step"] > 0
    _assert_bit_equal({k: port[k] for k in ("g", "d", "g_opt", "d_opt")},
                      {k: want[k] for k in ("g", "d", "g_opt", "d_opt")})

    path = ckpt.save_state(str(tmp_path / "port"), port, guarded=restored)
    assert os.path.basename(path) == f"state_{want['step']}.msgpack"
    back = jax_ckpt.restore_state(str(tmp_path / "port"), jax_states[restored])
    expect = serialization.to_state_dict(state)
    if saved and not restored:
        for key in ("g_opt_state", "d_opt_state"):
            expect[key] = expect[key]["inner_state"]
    elif restored and not saved:
        zero = np.zeros((), np.int32)
        for key in ("g_opt_state", "d_opt_state"):
            expect[key] = {"notfinite_count": zero, "total_notfinite": zero,
                           "inner_state": expect[key]}
    _assert_bit_equal(serialization.to_state_dict(jax.device_get(back)), expect)
    _assert_bit_equal(port_to_gan_state(port, restored), expect)


def test_restore_of_another_shape_raises(jax_states, tmp_path):
    jax_ckpt.save_state(str(tmp_path), jax_states[True])
    template = gan_state_to_port(jax_states[True])
    template["g"] = {k: np.zeros((3,) + v.shape, v.dtype) if k.endswith("bias") else v
                     for k, v in template["g"].items()}
    with pytest.raises(ValueError, match="does not match"):
        ckpt.restore_state(str(tmp_path), template)
    assert ckpt.restore_state(str(tmp_path / "empty"), template) is None


def test_prune_keeps_three(jax_states, tmp_path):
    port = gan_state_to_port(jax_states[True])
    for step in (5, 1, 30, 12, 7):
        ckpt.save_state(str(tmp_path), dict(port, step=step))
    assert sorted(os.listdir(tmp_path)) == ["state_12.msgpack", "state_30.msgpack",
                                            "state_7.msgpack"]
    assert ckpt.latest_state_path(str(tmp_path)).endswith("state_30.msgpack")


# --------------------------------------------------------------------------
# the trainer


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resume_corpus")
    write_corpus(str(tmp / "chembl.smi"), DRUGLIKE_SMILES[:BATCH * STEPS])
    write_corpus(str(tmp / "drugs.smi"), TARGET_SMILES)
    return tmp


def _cfg(corpus, out, dropout=0.0, **kw):
    return TrainConfig(
        raw_file=str(corpus / "chembl.smi"), drug_raw_file=str(corpus / "drugs.smi"),
        submodel="DrugGEN", max_atom=25, dim=16, heads=2, batch_size=BATCH, epoch=1,
        compute_dtype="bfloat16", fused_mlp=True, fused_critic=True,
        dropout=dropout, ddropout=dropout, log_sample_step=CADENCE,
        set_seed=True, seed=7, mol_data_dir=str(corpus / "c"),
        drug_data_dir=str(corpus / "cd"), log_dir=str(out / "l"),
        sample_dir=str(out / "s"), model_save_dir=str(out / "m"), device="cpu", **kw)


def _train(cfg):
    tr = Trainer(cfg)
    assert len(tr.data) // BATCH == STEPS
    return tr.train()


def _files(model_dir):
    return {name: open(os.path.join(model_dir, name), "rb").read()
            for name in os.listdir(model_dir) if name.endswith((".ckpt", ".msgpack"))}


@pytest.fixture(scope="module", params=[0.0, 0.1], ids=["no_dropout", "dropout"])
def uninterrupted(request, corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("uninterrupted")
    tr = _train(_cfg(corpus, out, request.param))
    return request.param, tr


def test_resumed_run_equals_the_uninterrupted_one(corpus, uninterrupted, tmp_path):
    """4 steps in one run against 2 steps, then ``--resume`` from
    ``state_2`` for steps 3-4: the same bits and the same file names (the
    same bytes for every file of step 4)."""
    dropout, full = uninterrupted
    assert full.step == STEPS
    full_files = _files(full.model_dir)
    assert sorted(full_files) == ["1-2-D.ckpt", "1-2-G.ckpt", "1-4-D.ckpt", "1-4-G.ckpt",
                                  "DrugGEN-G.ckpt", "state_2.msgpack", "state_4.msgpack"]
    cfg = _cfg(corpus, tmp_path, dropout, resume=True)
    model_dir = os.path.join(cfg.model_save_dir, cfg.run_name)
    os.makedirs(model_dir)
    shutil.copy(os.path.join(full.model_dir, "state_2.msgpack"), model_dir)
    resumed = Trainer(cfg)
    assert resumed.step == CADENCE
    launches = []
    step_fn = resumed.step_fn
    resumed.step_fn = lambda *args: launches.append(1) or step_fn(*args)
    resumed.train()
    assert len(launches) == STEPS - CADENCE and resumed.step == STEPS
    got, want = resumed.state(), full.state()
    _assert_bit_equal({k: got[k] for k in ("g", "d", "g_opt", "d_opt")},
                      {k: want[k] for k in ("g", "d", "g_opt", "d_opt")})
    files = _files(resumed.model_dir)
    assert sorted(files) == ["1-4-D.ckpt", "1-4-G.ckpt", "DrugGEN-G.ckpt",
                             "state_2.msgpack", "state_4.msgpack"]
    for name, data in files.items():
        assert data == full_files[name], name


def test_resume_from_epoch_iter_keeps_fresh_moments(corpus, uninterrupted, tmp_path):
    dropout, full = uninterrupted
    cfg = _cfg(corpus, tmp_path, dropout, resume=True, resume_epoch=1,
               resume_iter=CADENCE, resume_directory=full.model_dir)
    tr = Trainer(cfg)
    want_g, want_d = ckpt.restore_gd_params(full.model_dir, 1, CADENCE)
    state = tr.state()
    _assert_bit_equal(state["g"], want_g)
    _assert_bit_equal(state["d"], want_d)
    assert state["step"] == 0 and int(state["g_opt"]["count"]) == 0
    assert not state["g_opt"]["mu"]["readout_n.weight"].any()


def test_resume_of_a_complete_run_returns_at_once(corpus, uninterrupted, tmp_path):
    dropout, full = uninterrupted
    cfg = _cfg(corpus, tmp_path, dropout, resume=True, resume_directory=full.model_dir)
    tr = Trainer(cfg)
    assert tr.step == STEPS
    tr.step_fn = None       # a step would raise
    assert tr.train() is tr
    assert not _files(tr.model_dir)
