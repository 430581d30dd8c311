"""The trainer's single-device options of the JAX trainer, in the port, on
the CPU: ``--split_step``, ``--steps_per_dispatch K`` and ``--scan_layers``.

- The split step (a D step, then a G step with a fresh Generator forward)
  is bit-equal to the one-call step without a shared fake.
- ``--steps_per_dispatch 4`` is bit-equal to four single steps, and the
  port's work items ``(epoch, it, n_steps)`` are the ones JAX
  ``Trainer._work_items`` yields (called on a stub with only ``cfg.epoch``;
  no JAX compile): the cadence, the logged losses and the checkpoint names
  fall on the same steps.
- ``--scan_layers``: every file the run writes is byte-equal to JAX
  ``stack_block_params`` of the unrolled run's file (serialised by flax);
  the G export loads through ``load_params_auto`` of both packages into
  either layout; ``--resume`` from a stacked state lands where the
  unrolled run does.
"""

import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from druggen_tpu.models import Generator as JaxG
from druggen_tpu.models.layers import stack_block_params as jax_stack
from druggen_tpu.models.layers import unstack_block_params as jax_unstack
from druggen_tpu.train import checkpoint as jax_ckpt
from druggen_tpu.train.trainer import Trainer as JaxTrainer
from druggen_tpu_torch.config import TrainConfig
from druggen_tpu_torch.data.corpus import DRUGLIKE_SMILES, TARGET_SMILES, write_corpus
from druggen_tpu_torch.interop.msgpack_ckpt import msgpack_restore
from druggen_tpu_torch.models import Discriminator, Generator
from druggen_tpu_torch.train import checkpoint as ckpt
from druggen_tpu_torch.train.optim import make_optimizers
from druggen_tpu_torch.train.step import TrainStep
from druggen_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

BATCH, STEPS, CADENCE, DEPTH = 8, 5, 2, 2


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("options_corpus")
    write_corpus(str(tmp / "chembl.smi"), DRUGLIKE_SMILES[:BATCH * STEPS])
    write_corpus(str(tmp / "drugs.smi"), TARGET_SMILES)
    return tmp


def _cfg(corpus, out, **kw):
    args = dict(
        raw_file=str(corpus / "chembl.smi"), drug_raw_file=str(corpus / "drugs.smi"),
        submodel="DrugGEN", max_atom=25, dim=16, heads=2, depth=DEPTH, ddepth=DEPTH,
        batch_size=BATCH, epoch=1, compute_dtype="bfloat16", fused_mlp=True,
        fused_critic=True, log_sample_step=CADENCE, set_seed=True, seed=7,
        mol_data_dir=str(corpus / "c"), drug_data_dir=str(corpus / "cd"),
        log_dir=str(out / "l"), sample_dir=str(out / "s"),
        model_save_dir=str(out / "m"), device="cpu")
    return TrainConfig(**{**args, **kw})


def _train(cfg):
    tr = Trainer(cfg)
    assert len(tr.data) // BATCH == STEPS
    return tr.train()


def _files(model_dir):
    return {name: open(os.path.join(model_dir, name), "rb").read()
            for name in os.listdir(model_dir) if name.endswith((".ckpt", ".msgpack"))}


def _losses(tr):
    import json

    return {r["step"]: (r["d_loss"], r["g_loss"])
            for r in map(json.loads, open(tr.logger.jsonl_path)) if "d_loss" in r}


def _assert_same_state(got, want):
    for part in ("g", "d"):
        for k, v in want[part].items():
            assert got[part][k].tobytes() == v.tobytes(), (part, k)
    for opt in ("g_opt", "d_opt"):
        for m in ("mu", "nu"):
            for k, v in want[opt][m].items():
                assert got[opt][m][k].tobytes() == v.tobytes(), (opt, m, k)
        assert int(got[opt]["count"]) == int(want[opt]["count"])
    assert got["step"] == want["step"]


@pytest.fixture(scope="module")
def unrolled(corpus, tmp_path_factory):
    return _train(_cfg(corpus, tmp_path_factory.mktemp("unrolled")))


# ------------------------------------------------------------- split step

def test_split_step_is_the_step_without_a_shared_fake():
    B, N, M, BD = 4, 7, 5, 4

    def build(**kw):
        G = Generator("relu", N, BD, M, 0.0, 16, 1, 4, 2, dtype=torch.bfloat16,
                      fused_mlp=True, generator=torch.Generator().manual_seed(1))
        D = Discriminator("relu", N, BD, M, 0.0, 16, 2, 4, 2, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(2))
        cfg = TrainConfig(raw_file="x", drug_raw_file="y", batch_size=B, max_atom=N,
                          dim=16, heads=4, mlp_ratio=2)
        return TrainStep(G, D, *make_optimizers(cfg, G, D), lambda_gp=10.0, m_dim=M,
                         b_dim=BD, compute_dtype=torch.bfloat16, g_fused=True,
                         fused_critic=True, **kw)

    split, whole = build(split=True), build(share_fake=False)
    assert split.split and not split.share_fake
    rng = np.random.default_rng(0)
    for i in range(3):
        batch = (rng.integers(0, M, (B, N)), rng.integers(0, BD, (B, N, N)),
                 rng.integers(0, M, (B, N)), rng.integers(0, BD, (B, N, N)))
        outs = []
        for step in (split, whole):
            step.generator = torch.Generator().manual_seed(i)
            outs.append(step(*batch))
        for k in ("d_loss", "g_loss", "node_logits", "edge_logits"):
            assert torch.equal(outs[0][k], outs[1][k]), (i, k)
    for a, b in zip(list(split.G.parameters()) + list(split.D.parameters()),
                    list(whole.G.parameters()) + list(whole.D.parameters())):
        assert torch.equal(a, b)


def test_split_step_trainer_halves_the_loss_window(corpus, tmp_path, capsys):
    """The losses are fetched every ``log_flush_steps // 2`` steps (JAX
    ``trainer.py:459-462``), and ``steps_per_dispatch`` is ignored."""
    tr = Trainer(_cfg(corpus, tmp_path, split_step=True, steps_per_dispatch=4,
                      log_flush_steps=4, log_sample_step=100))
    assert "split_step: steps_per_dispatch ignored" in capsys.readouterr().out
    fetched_at = []
    log = tr.logger.log

    def spy(record, step=None, echo=True):
        if "d_loss" in record:
            fetched_at.append((step, tr.step))
        return log(record, step=step, echo=echo)
    tr.logger.log = spy
    tr.train()
    assert fetched_at == [(1, 2), (2, 2), (3, 4), (4, 4), (5, 5)]


# ------------------------------------------------------ steps per dispatch

class _Batches:
    """A batch iterator of ``steps`` batches an epoch (what ``_work_items``
    reads of one)."""

    def __init__(self, steps: int):
        self.steps = steps

    def __len__(self):
        return self.steps

    def epoch_batches(self, epoch):
        for i in range(self.steps):
            yield np.full((2, 3), 100 * epoch + i), np.zeros((2, 3, 3))


def _drugs():
    i = 0
    while True:
        yield np.full((2, 3), i), np.zeros((2, 3, 3))
        i += 1


@pytest.mark.parametrize("steps,epochs,K,start", [
    (5, 2, 4, 0), (8, 2, 4, 0), (5, 3, 2, 3), (7, 2, 3, 9), (5, 1, 1, 2), (3, 2, 5, 0)])
def test_work_items_are_jax_s(steps, epochs, K, start):
    stub = SimpleNamespace(cfg=SimpleNamespace(epoch=epochs))
    want = [(e, it, n, np.asarray(arrays[0]).reshape(-1, 2, 3)[:, 0, 0].tolist())
            for e, it, n, arrays, _ in JaxTrainer._work_items(
                stub, _Batches(steps), _drugs(), K, start_step=start)]
    port = SimpleNamespace(cfg=stub.cfg)
    got = [(e, it, n, [int(b[0][0, 0]) for b in batches])
           for e, it, n, batches in Trainer._work_items(
               port, _Batches(steps), _drugs(), K, start_step=start)]
    assert got == want


def test_steps_per_dispatch_equals_single_steps(corpus, unrolled, tmp_path):
    tr = _train(_cfg(corpus, tmp_path, steps_per_dispatch=4))
    _assert_same_state(tr.state(), unrolled.state())
    # one dispatch of 4 and the tail's single step, as JAX: the losses of
    # steps 4 and 5 logged, the cadence (step % 2 < n) at step 4 only
    full = _losses(unrolled)
    assert _losses(tr) == {4: full[4], 5: full[5]}
    assert sorted(_files(tr.model_dir)) == ["1-4-D.ckpt", "1-4-G.ckpt", "DrugGEN-G.ckpt",
                                           "state_4.msgpack", "state_5.msgpack"]


# ------------------------------------------------------------- scan layers

@pytest.fixture(scope="module")
def stacked(corpus, tmp_path_factory):
    return _train(_cfg(corpus, tmp_path_factory.mktemp("stacked"), scan_layers=True))


def test_stacked_files_are_jax_stack_of_the_unrolled(unrolled, stacked):
    mine, theirs = _files(stacked.model_dir), _files(unrolled.model_dir)
    assert sorted(mine) == sorted(theirs) == [
        "1-2-D.ckpt", "1-2-G.ckpt", "1-4-D.ckpt", "1-4-G.ckpt", "DrugGEN-G.ckpt",
        "state_2.msgpack", "state_4.msgpack", "state_5.msgpack"]
    for name, data in theirs.items():
        tree = msgpack_restore(data)
        assert mine[name] == serialization.to_bytes(jax_stack(tree)), name
        assert mine[name] != data


def test_stacked_export_loads_both_ways(unrolled, stacked):
    path = os.path.join(stacked.model_dir, "DrugGEN-G.ckpt")
    want = ckpt.load_params_auto(os.path.join(unrolled.model_dir, "DrugGEN-G.ckpt"))
    got = ckpt.load_params_auto(path)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    unrolled_tree = msgpack_restore(open(os.path.join(unrolled.model_dir,
                                                      "DrugGEN-G.ckpt"), "rb").read())
    m_dim = unrolled_tree["params"]["readout_n"]["bias"].shape[0]
    b_dim = unrolled_tree["params"]["readout_e"]["bias"].shape[0]
    for scan in (False, True):
        jg = JaxG(act="relu", vertexes=25, edges=b_dim, nodes=m_dim, dropout=0.0, dim=16,
                  depth=DEPTH, heads=2, mlp_ratio=3, scan_layers=scan)
        template = jax.eval_shape(lambda: jg.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 25, 25, b_dim)), jnp.zeros((1, 25, m_dim))))
        template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), template)
        loaded = jax.device_get(jax_ckpt.load_params_auto(path, template))
        if scan:
            loaded = jax_unstack(serialization.to_state_dict(loaded))
        flat = dict(jax.tree_util.tree_leaves_with_path(serialization.to_state_dict(loaded)))
        ref = dict(jax.tree_util.tree_leaves_with_path(unrolled_tree))
        assert flat.keys() == ref.keys()
        for k, v in ref.items():
            np.testing.assert_array_equal(np.asarray(flat[k]), v)


def test_stacked_resume_lands_where_the_unrolled_run_does(corpus, unrolled, stacked,
                                                         tmp_path):
    cfg = _cfg(corpus, tmp_path, scan_layers=True, resume=True)
    model_dir = os.path.join(cfg.model_save_dir, cfg.run_name)
    os.makedirs(model_dir)
    shutil.copy(os.path.join(stacked.model_dir, "state_2.msgpack"), model_dir)
    resumed = Trainer(cfg)
    assert resumed.step == CADENCE
    resumed.train()
    _assert_same_state(resumed.state(), unrolled.state())
    assert _files(resumed.model_dir)["state_5.msgpack"] == \
        _files(stacked.model_dir)["state_5.msgpack"]
    # an unrolled run does not read a stacked state (JAX's template fixes
    # the layout)
    with pytest.raises(ValueError, match="does not match"):
        ckpt.restore_state(model_dir, unrolled.state())
