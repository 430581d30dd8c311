"""Trainer orchestration (port of ``druggen_tpu/train/trainer.py``, the
single-device path).

The analogue of the reference ``Train`` class (``train.py:25-397``): config
capture, seeding, vocab + two datasets (ChEMBL-style + drug-target), model
build with shape inference from the data, and the epoch/iteration loop with
the reference's cadence — per-step loss logging, per-``log_sample_step``
chemical metrics + sample dumps + G/D parameter exports, and the final
``{submodel}-G.ckpt`` for inference.

As in the JAX trainer, the host does not wait for the card each step: the
losses stay on the device and are fetched every ``log_flush_steps`` steps
(and at the cadence), in one transfer.  The numerics ladder escalates
through the same tiers, each switching precision on the same parameters
and optimizer state.

``use_pallas`` puts the fused edge attention (K5/K6) on the Generator only;
the critic is built without it (JAX ``trainer.py:129-143``), and the ladder's
tiers 2 and 3 switch it off.  ``fused_block`` routes each encoder block's
whole edge stream through the megablock (K7/K8): the Generator and the
critic's first-order passes run in ``fused_mlp="block"`` mode, the
gradient-penalty pass stays plain (JAX ``trainer.py:136-137, 229-234``); a
Generator with ``use_pallas`` keeps K5/K6 and the fused tail instead, and
the ladder's tiers 2 and 3 switch the megablock off.

Checkpoints carry the optimizer states and the step for an exact resume,
as in JAX: ``state_{step}.msgpack`` at every cadence and at the end (the JAX
``GANState`` layout, :mod:`.checkpoint`), and ``--resume`` continues from the
newest one on the original schedule, or (with ``--resume_epoch`` and
``--resume_iter``) from a ``{epoch}-{iter}-G/D.ckpt`` pair with fresh
optimizer states.  Each step's random draws (the gradient-penalty noise, the
dropout masks) are seeded from ``(seed, step)`` (:func:`step_seed`), as JAX
folds the step into its key, so a resumed run draws what an uninterrupted
one does.

The JAX trainer's single-device options: ``gp_mode="fwdrev"`` (the
reverse-over-forward penalty, :mod:`.step`); ``split_step`` (the D and the G
update as two steps, the loss window halved; ``steps_per_dispatch`` is then
ignored, as JAX prints); ``steps_per_dispatch K`` (K batches a work item, run
as K eager steps, the cadence, the logged losses and the checkpoint names on
the steps JAX puts them on, :meth:`Trainer._work_items`); ``scan_layers``
(the models stay unrolled, which computes the same function; the G/D exports
and the state files are written in the stacked ``{'blocks': {'block': …}}``
layout of JAX ``--scan_layers``, and ``--resume`` reads it); ``--features``
(dense node blocks of ``m_dim + 54`` in place of one-hot labels, featurised
on the Python path as in JAX; the cadence decodes the atom labels from the
one-hot prefix).

The parallel modes (:mod:`druggen_tpu_torch.parallel`; JAX
``trainer.py:60-118, 148-192``) run on ``torch.distributed``, one device a
rank.  The group is the caller's when one is up, else ``--distributed``
starts it from ``coordinator_address``/``num_processes``/``process_id``, else
``torchrun``'s environment, else the world is this one process.  The mesh:
('data', 'node') with ``mesh_node > 1`` (the edge-partitioned step,
:class:`..parallel.edge_partition.ShardedTrainStep`; the vertex axes padded
to a multiple of ``mesh_node``; ``fused_critic``, ``gp_mode`` and
``steps_per_dispatch`` apply to the single-device step and are ignored),
('data', 'model') with ``mesh_model > 1`` (the split layers of
:mod:`..parallel.tensor_parallel` under the same :class:`TrainStep`), else
('data',) over ``mesh_data`` ranks (0: all): each rank runs
:class:`TrainStep` on its rows of the global batch, drawing its rows of the
global penalty noise, and the optimizers sum the gradients over 'data'
before the guard (their ``grad_hook``), so every rank decides alike.  Every
single-device option runs on each rank.  The loss window is summed over the
mesh at each flush, so the numerics ladder escalates on the global losses on
every rank at once; rank 0 alone writes logs, samples, exports and states
(split layers gathered first), and ``--resume`` reads on rank 0 and
broadcasts.  A rank outside a mesh smaller than the world idles.  With
dropout each 'data' rank draws its own masks.
"""

from __future__ import annotations

import math
import os
import random
import time

import numpy as np
import torch

from druggen_tpu_torch.chem.fingerprints import fingerprints_for_smiles
from druggen_tpu_torch.chem.vocab import Vocab, get_vocab
from druggen_tpu_torch.config import TrainConfig
from druggen_tpu_torch.data.dataset import (
    BatchIterator,
    GraphData,
    load_dataset,
    pad_vertices,
)
from druggen_tpu_torch.infer.engine import resolve_device
from druggen_tpu_torch.interop.weights import to_torch_tensors
from druggen_tpu_torch.models import Discriminator, Generator
from druggen_tpu_torch.parallel import mesh as pmesh
from druggen_tpu_torch.parallel import tensor_parallel as tp
from druggen_tpu_torch.parallel.edge_partition import (
    EDGE_ROWS,
    NODE_ROWS,
    ShardedTrainStep,
    make_edge_mesh,
    shard_train_inputs,
)
from druggen_tpu_torch.train import checkpoint as ckpt
from druggen_tpu_torch.train.optim import make_optimizers
from druggen_tpu_torch.train.step import TrainStep
from druggen_tpu_torch.utils.logging import RunLogger
from druggen_tpu_torch.utils.prefetch import prefetch
from druggen_tpu_torch.utils.sampling import save_sample_artifacts, training_metrics

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s random draws (0-based): a function of the
    run's seed and the step alone (JAX: ``fold_in(key, state.step)``,
    ``train/step.py:260``)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)


def _derived_seed(*words: int) -> int:
    return int(np.random.SeedSequence(list(words)).generate_state(1, np.uint64)[0] >> 1)


class _NoLogger:
    """The logger of a rank that writes nothing (all but rank 0)."""

    jsonl_path = None

    def log(self, *args, **kwargs) -> None:
        pass

    def finish(self) -> None:
        pass


class Trainer:
    def __init__(self, cfg: TrainConfig, vocab: Vocab | None = None,
                 data: GraphData | None = None,
                 drug_data: GraphData | None = None):
        self.cfg = cfg
        # multi-host start-up before any device use (JAX trainer.py:60-68)
        if cfg.distributed or pmesh.launched_by_torchrun():
            pmesh.init_distributed(cfg.coordinator_address, cfg.num_processes,
                                   cfg.process_id)
        self.rank, self.world_size = pmesh.world()
        self.device = resolve_device(pmesh.rank_device(cfg.device))
        if self.device.type == "cuda" and self.world_size > 1:
            torch.cuda.set_device(self.device)
        if cfg.distributed:
            print(f"multi-host: process {self.rank}/{self.world_size}, "
                  f"device {self.device}")
        if cfg.set_seed:
            np.random.seed(cfg.seed)
            random.seed(cfg.seed)
            os.environ["PYTHONHASHSEED"] = str(cfg.seed)
            torch.manual_seed(cfg.seed)

        # ---- data (reference train.py:76-115); several ranks: rank 0 writes
        # the shared vocab and dataset caches first, the others then read them
        first = self.world_size > 1 and self.rank == 0
        if self.world_size > 1 and not first:
            torch.distributed.barrier()
        self.vocab = vocab or get_vocab(
            cfg.raw_file, cfg.drug_raw_file, cfg.max_atom,
            cache_dir=os.path.join(cfg.mol_data_dir, "vocab"),
            union_ref12=cfg.vocab_ref12)
        self.data = data if data is not None else load_dataset(
            cfg.raw_file, self.vocab, cfg.max_atom, cfg.mol_data_dir,
            features=cfg.features)
        self.drug_data = drug_data if drug_data is not None else load_dataset(
            cfg.drug_raw_file, self.vocab, cfg.max_atom, cfg.drug_data_dir,
            features=cfg.features)
        if first:
            torch.distributed.barrier()
        # shape inference (reference train.py:117-119): the atom types, or
        # the one-hot + feature block's width
        self.m_dim = self.vocab.m_dim + self.data.feature_dim
        self.b_dim = self.vocab.b_dim
        self.vertexes = int(self.data.x.shape[1])

        # edge-partitioned mode: pad the vertex axes so the 'node' axis
        # divides them (PAD labels are "no atom / no bond";
        # data.dataset.pad_vertices; JAX trainer.py:89-118)
        self.node_k = max(cfg.mesh_node, 1)
        if self.node_k > 1:
            if cfg.features:
                raise ValueError("mesh_node > 1 does not support --features")
            if cfg.dropout or cfg.ddropout:
                raise ValueError("mesh_node > 1 requires dropout=0 "
                                 "(the reference default)")
            if cfg.use_pallas:
                # JAX asserts the same when the step is first traced
                raise ValueError("mesh_node > 1 does not run the fused "
                                 "attention kernel (use_pallas)")
            local = int(os.environ.get("LOCAL_WORLD_SIZE", self.world_size))
            if self.world_size > local and local % self.node_k:
                # host-major layout: a host's ranks hold whole 'data' rows
                # iff node_k divides its rank count
                raise ValueError(
                    f"mesh_node={self.node_k} must divide the per-host "
                    f"device count ({local}) so 'data' rows do not "
                    f"straddle hosts")
            if self.vertexes % self.node_k:
                to = -(-self.vertexes // self.node_k) * self.node_k
                self.data = pad_vertices(self.data, to)
                self.drug_data = pad_vertices(self.drug_data, to)
                self.vertexes = to
                print(f"mesh_node={self.node_k}: padded vertexes to {to}")
        self.compute_dtype = _DTYPES[cfg.compute_dtype]

        # ---- models + optimizers (reference build_model, train.py:164-226);
        # initialisation and the gradient-penalty noise from explicit
        # generators seeded with cfg.seed
        init = torch.Generator().manual_seed(cfg.seed)
        common = dict(act=cfg.act, vertexes=self.vertexes, edges=self.b_dim,
                      nodes=self.m_dim, dim=cfg.dim, heads=cfg.heads,
                      mlp_ratio=cfg.mlp_ratio,
                      dtype=None if self.compute_dtype == torch.float32
                      else self.compute_dtype)
        # the fused attention goes to G only: the gradient penalty
        # differentiates D twice (JAX trainer.py:129-131); --fused_block
        # routes each block's edge stream through the megablock (JAX
        # trainer.py:136-137)
        self.fused_g = "block" if cfg.fused_block else cfg.fused_mlp
        self.fused_d = "block" if cfg.fused_block else cfg.fused_critic
        self.G = Generator(dropout=cfg.dropout, depth=cfg.depth,
                           fused_mlp=self.fused_g, use_pallas=cfg.use_pallas,
                           generator=init, **common)
        self.D = Discriminator(dropout=cfg.ddropout, depth=cfg.ddepth,
                               head_mult=cfg.d_head_mult, generator=init,
                               **common)

        # ---- the mesh (JAX trainer.py:148-192)
        self.tp_k = max(cfg.mesh_model, 1)
        if self.tp_k > 1 and self.node_k > 1:
            raise ValueError("mesh_model and mesh_node are mutually "
                             "exclusive for now")
        if self.node_k > 1:
            dp = cfg.mesh_data if cfg.mesh_data > 0 else max(
                self.world_size // self.node_k, 1)
            self.mesh = make_edge_mesh(dp, self.node_k)
        elif self.tp_k > 1:
            if cfg.dim % self.tp_k:
                raise ValueError(f"dim={cfg.dim} not divisible by "
                                 f"mesh_model={self.tp_k}")
            dp = cfg.mesh_data if cfg.mesh_data > 0 else max(
                self.world_size // self.tp_k, 1)
            self.mesh = tp.make_dp_tp_mesh(dp, self.tp_k)
        else:
            self.mesh = pmesh.make_mesh(cfg.mesh_data)
        self.parallel = self.mesh.size > 1
        self.writer = self.rank == 0
        if not self.mesh.member:
            print(f"rank {self.rank} is outside the mesh {self.mesh.shape}: idle")
            return
        if self.tp_k > 1:
            tp.shard_gan_state_tp(self.mesh, self.G, self.D)
        self.G.to(self.device)
        self.D.to(self.device)
        self.g_opt, self.d_opt = make_optimizers(cfg, self.G, self.D)
        # every rank from rank 0's initialisation (its 'model' line's first
        # rank's shards under mesh_model)
        pmesh.shard_state(self.mesh, [self.g_opt.flat, self.d_opt.flat],
                          self.mesh.axis("data") if self.tp_k > 1 else None)
        # re-seeded before every step with step_seed(cfg.seed, step); the
        # global generators too when a model drops out
        self.gp_noise = torch.Generator(device=self.device)
        self._seeds_dropout = cfg.dropout > 0 or cfg.ddropout > 0

        # ---- numerics ladder (JAX trainer.py:193-240): under bf16 compute
        # the step escalates the first time a fetched loss window shows a
        # non-finite value:
        #   tier 0  all-bf16
        #   tier 1  f32 gradient-penalty pass        (gp_f32)
        #   tier 2  + f32 softmax, fused tails off   (f32_stats)
        #   tier 3  whole step in f32 — the reference's own numerics
        # Each tier switches precision on the same parameters and optimizer
        # state; the non-finite guard keeps them clean through the
        # triggering steps.
        def _mode(name, allowed=("auto", "on", "off")):
            v = getattr(cfg, name)
            if isinstance(v, bool):                 # programmatic callers
                v = "on" if v else "off"
            if v not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got {v!r}")
            return v

        gp_f32_cfg = _mode("gp_f32")
        f32_stats_cfg = _mode("f32_stats")
        f32_full_cfg = _mode("f32_full")
        if self.compute_dtype == torch.float32:
            start_tier, ladder = 0, []
        else:
            start_tier = (2 if f32_stats_cfg == "on"
                          else 1 if gp_f32_cfg == "on" else 0)
            allowed = {1: gp_f32_cfg == "auto", 2: f32_stats_cfg == "auto",
                       3: f32_full_cfg == "auto"}
            ladder = [t for t in (1, 2, 3) if t > start_tier and allowed[t]]
        self._numerics_tier = start_tier
        self._ladder = ladder
        self._ladder_exhausted_warned = False
        if self.node_k > 1:
            for knob, on in (("steps_per_dispatch", cfg.steps_per_dispatch > 1),
                             ("fused_critic", cfg.fused_critic),
                             ("gp_mode", cfg.gp_mode != "revrev")):
                if on:
                    print(f"mesh_node > 1: {knob} ignored")
        elif cfg.split_step and cfg.steps_per_dispatch > 1:
            print("split_step: steps_per_dispatch ignored")
        self._build_step_fns(start_tier)

        # ---- dirs + logging (reference train.py:283-289)
        self.run_name = cfg.run_name
        self.model_dir = os.path.join(cfg.model_save_dir, self.run_name)
        self.sample_dir = os.path.join(cfg.sample_dir, self.run_name)
        summaries = [(name, self._whole(model)) for name, model in
                     (("G", self.G), ("D", self.D))]
        if self.writer:
            os.makedirs(self.model_dir, exist_ok=True)
            os.makedirs(self.sample_dir, exist_ok=True)
            self.logger = RunLogger(cfg.log_dir, self.run_name,
                                    use_wandb=cfg.use_wandb, online=cfg.online,
                                    config=vars(cfg))
            self._write_module_summaries(summaries)
        else:
            self.logger = _NoLogger()

        # drug fingerprints for the SNN metric (reference train.py:292-294)
        self.drug_smiles = self.drug_data.smiles
        self.drug_fps = fingerprints_for_smiles(self.drug_smiles)
        self.step = 0                       # committed training steps
        self.step_seconds: list[float] = []

        # ---- resume (JAX trainer.py:257-270): read on rank 0, broadcast
        if cfg.resume:
            directory = cfg.resume_directory or self.model_dir
            if cfg.resume_epoch is not None and cfg.resume_iter is not None:
                pair = (ckpt.restore_gd_params(directory, cfg.resume_epoch,
                                               cfg.resume_iter)
                        if self.writer else None)
                self._load_params(*pmesh.broadcast_object(self.mesh, pair))
                print(f"restored G/D params from {directory} "
                      f"{cfg.resume_epoch}-{cfg.resume_iter}")
            else:
                template = self.state()
                restored = (ckpt.restore_state(
                    directory, template, guarded=cfg.nonfinite_guard,
                    stacked=cfg.scan_layers) if self.writer else None)
                restored = pmesh.broadcast_object(self.mesh, restored)
                if restored is not None:
                    self.load_state(restored)
                    print(f"auto-resumed at step {self.step}")

    # ------------------------------------------------------------------
    def _whole(self, model, sd: dict | None = None) -> dict:
        """``model``'s state dict (or ``sd``, by its names) with the split
        layers gathered whole: collective under ``mesh_model``."""
        sd = model.state_dict() if sd is None else sd
        return tp.gather_state_dict(model, sd) if self.tp_k > 1 else sd

    def state(self) -> dict:
        """The training state as ``{g, d, g_opt, d_opt, step}`` (numpy
        copies; :func:`..interop.weights.gan_state_to_port`'s form); whole
        on every rank (collective under ``mesh_model``)."""
        def numpy(t):
            return t.detach().cpu().numpy().copy()

        def tree(model, sd=None):
            return {k: numpy(v) for k, v in self._whole(model, sd).items()}

        def opt(o, model):
            mu, nu = o.moments()
            st = o.state
            return {"count": numpy(st.count), "mu": tree(model, mu),
                    "nu": tree(model, nu),
                    "notfinite_count": numpy(st.notfinite_count),
                    "total_notfinite": numpy(st.total_notfinite)}

        return {"g": tree(self.G), "d": tree(self.D),
                "g_opt": opt(self.g_opt, self.G), "d_opt": opt(self.d_opt, self.D),
                "step": self.step}

    def _mine(self, model, sd: dict) -> dict:
        """A whole state dict as ``model`` holds it (this rank's shards)."""
        sd = to_torch_tensors(sd)
        return tp.shard_state_dict(model, sd) if self.tp_k > 1 else sd

    def _load_params(self, g_sd: dict, d_sd: dict) -> None:
        # copies into the existing parameters, which stay views of the
        # optimizers' flat buffers
        self.G.load_state_dict(self._mine(self.G, g_sd))
        self.D.load_state_dict(self._mine(self.D, d_sd))

    def load_state(self, state: dict) -> None:
        """Set parameters, optimizer states and the step from ``state``
        (the form :meth:`state` returns)."""
        self._load_params(state["g"], state["d"])
        for o, model, st in ((self.g_opt, self.G, state["g_opt"]),
                             (self.d_opt, self.D, state["d_opt"])):
            o.load_state(st["count"], self._mine(model, st["mu"]),
                         self._mine(model, st["nu"]), st["notfinite_count"],
                         st["total_notfinite"])
        self.step = int(state["step"])

    # ------------------------------------------------------------------
    def _write_module_summaries(self, summaries) -> None:
        """Param-shape dumps per model (reference print_network,
        train.py:228-248), of the whole parameters."""
        for name, sd in summaries:
            path = os.path.join(self.model_dir, f"{name}_modules.txt")
            with open(path, "w") as f:
                f.write(f"{name} ({type(self).__name__})\n")
                for key, p in sd.items():
                    f.write(f"  - {key}: {tuple(p.shape)}\n")
                f.write("Total number of parameters: "
                        f"{sum(p.numel() for p in sd.values())}\n")

    def _build_step_fns(self, tier: int) -> None:
        """The train step of a numerics-ladder tier, on the same models and
        optimizers."""
        cfg = self.cfg
        kw = dict(compute_dtype=self.compute_dtype, g_fused=self.fused_g,
                  fused_critic=self.fused_d, gp_f32=tier >= 1,
                  f32_stats=tier >= 2, g_pallas=cfg.use_pallas)
        if tier >= 3:
            kw.update(compute_dtype=torch.float32, g_fused=False,
                      fused_critic=False, gp_f32=False, f32_stats=False,
                      g_pallas=False)
        common = dict(lambda_gp=cfg.lambda_gp, m_dim=self.m_dim, b_dim=self.b_dim,
                      submodel=cfg.submodel, generator=self.gp_noise)
        if self.node_k > 1:
            # the whole step under the ('data', 'node') mesh; fused_critic,
            # gp_mode and the fused attention are the single-device step's
            self.step_fn = ShardedTrainStep(
                self.G, self.D, self.g_opt, self.d_opt, self.mesh,
                compute_dtype=kw["compute_dtype"], g_fused=kw["g_fused"],
                gp_f32=kw["gp_f32"], f32_stats=kw["f32_stats"], **common)
            return
        data = self.mesh.axis("data")
        self.step_fn = TrainStep(self.G, self.D, self.g_opt, self.d_opt,
                                 node_mode="dense" if cfg.features else "labels",
                                 gp_mode=cfg.gp_mode, split=cfg.split_step,
                                 noise_rows=(data.index, data.size), **common, **kw)
        if self.parallel:
            # each rank's loss is the mean over its rows: the mean of the
            # ranks' gradients over 'data' (the split layers' shards and the
            # whole layers' gradients are exact on each 'model' rank)
            for o in (self.g_opt, self.d_opt):
                o.grad_hook = pmesh.gradient_hook(data, divide=data.size)

    def _escalate_numerics(self) -> None:
        """Advance to the next numerics-ladder tier (JAX trainer.py:342):
        called each time a fetched loss window is non-finite and a higher
        tier remains; past the last tier, warn once and keep training
        behind the guard."""
        if not self._ladder:
            if not self._ladder_exhausted_warned:
                self._ladder_exhausted_warned = True
                print("numerics ladder exhausted: losses still non-finite "
                      "on the highest-precision program — params are "
                      "protected by the finite barrier, but the run needs "
                      "investigation (frozen critic?)", flush=True)
            return
        tier = self._ladder.pop(0)
        self._numerics_tier = tier
        names = {1: "f32 gradient-penalty pass",
                 2: "f32 gradient penalty + f32 LayerNorm/softmax",
                 3: "full-f32 step (reference numerics)"}
        print(f"numerics ladder: non-finite loss detected — escalating to "
              f"tier {tier}: {names[tier]}", flush=True)
        self._build_step_fns(tier)

    def _work_items(self, mol_iter, drug_iter, K: int = 1, start_step: int = 0):
        """Work stream ``(epoch, it, n_steps, batches)``: ``batches`` holds
        ``n_steps`` tuples ``(x, a, dx, da)`` and ``it`` is the epoch
        iteration of the last of them (JAX ``_work_items`` :370-421, whose
        ``(epoch, it, n_steps)`` this yields).  K batches a work item, and
        an epoch's tail shorter than K as single steps.  Host-side batch
        assembly that a prefetch thread overlaps with the device.

        ``start_step`` resumes the schedule mid-run: epochs and iterations
        the restored step already covers are skipped and the drug stream is
        fast-forwarded, so a resumed run continues the original epoch plan
        and checkpoint names."""
        steps_per_epoch = len(mol_iter)
        start_epoch, skip = (divmod(start_step, steps_per_epoch)
                             if steps_per_epoch else (0, 0))
        for _ in range(start_step):     # the drug stream runs on across
            next(drug_iter)             # epochs: advance by ALL done steps
        for epoch in range(start_epoch, self.cfg.epoch):
            batch_stream = mol_iter.epoch_batches(epoch)
            it = -1
            if epoch == start_epoch and skip:
                it = skip - 1
                for _ in range(skip):   # mol stream alignment
                    if next(batch_stream, None) is None:
                        break
            for x, a in batch_stream:
                batches = [(x, a, *next(drug_iter))]
                while len(batches) < K:
                    nxt = next(batch_stream, None)
                    if nxt is None:
                        break
                    batches.append((*nxt, *next(drug_iter)))
                if len(batches) == K:
                    it += K
                    yield epoch, it, K, batches
                else:
                    for batch in batches:   # tail smaller than K
                        it += 1
                        yield epoch, it, 1, [batch]

    def train(self, time_steps: bool = False) -> "Trainer":
        """Run the schedule.  ``time_steps``: end every step with
        ``torch.cuda.synchronize()`` and record its host-clock window in
        ``step_seconds`` (a measurement aid; it makes the host wait)."""
        cfg = self.cfg
        if not self.mesh.member:
            return self
        # each host its slice of every epoch; its ranks their rows of its
        # batches (JAX trainer.py:425-427)
        mol_iter = BatchIterator(self.data, cfg.batch_size, seed=cfg.seed,
                                 host_id=self.mesh.host_id,
                                 num_hosts=self.mesh.num_hosts)
        if cfg.submodel == "NoTarget":
            # the step ignores the drug inputs for NoTarget
            # (reference train.py:343-345)
            def _echo_mol():
                while True:
                    yield from mol_iter.epoch_batches(10 ** 6)

            drug_iter = _echo_mol()
        else:
            drug_iter = iter(BatchIterator(self.drug_data, cfg.batch_size,
                                           seed=cfg.seed, loop=True))
        print(f"Start training... ({len(self.data)} mols, "
              f"{len(self.drug_data)} drugs, device={self.device}, "
              f"mesh={self.mesh.shape})", flush=True)
        if self.node_k > 1:
            local, specs = (lambda *arrs: shard_train_inputs(self.mesh, *arrs),
                            (NODE_ROWS, EDGE_ROWS))
        else:
            local, specs = (lambda *arrs: pmesh.shard_batch(self.mesh, *arrs),
                            (("data", None, None), ("data", None, None, None)))
        if self.step >= cfg.epoch * max(len(mol_iter), 1):
            print(f"resume: step {self.step} already completes the "
                  f"{cfg.epoch}-epoch schedule; nothing to do")
            return self
        # the split step runs two updates a step: the window is halved (JAX
        # trainer.py:459-462)
        flush_every = max(cfg.log_flush_steps // (2 if cfg.split_step else 1), 1)
        K = 1 if cfg.split_step else max(cfg.steps_per_dispatch, 1)
        pending: list[tuple] = []   # (epoch, it, step, device metrics)

        def flush() -> None:
            if not pending:
                return
            # one transfer (the host's only wait) for the whole window
            vals = torch.stack([torch.stack([m["d_loss"].float(),
                                             m["g_loss"].float()])
                                for *_, m in pending])
            if self.parallel:
                # the global losses on every rank: the ladder decides alike
                vals = pmesh.all_reduce(vals, self.mesh.whole) / self.mesh.size
            vals = vals.cpu().tolist()
            saw_nonfinite = False
            for (ep, it_, st_, _), (d_val, g_val) in zip(pending, vals):
                saw_nonfinite |= not (math.isfinite(d_val)
                                      and math.isfinite(g_val))
                self.logger.log({"epoch": ep, "iter": it_,
                                 "d_loss": d_val, "g_loss": g_val},
                                step=st_, echo=(it_ % 50 < K))
            pending.clear()
            if saw_nonfinite:
                self._escalate_numerics()

        sync = time_steps and self.device.type == "cuda"
        work = prefetch(self._work_items(mol_iter, drug_iter, K,
                                         start_step=self.step),
                        cfg.prefetch_depth)
        for epoch, it, n_steps, batches in work:
            for x, a, dx, da in batches:
                seed = step_seed(cfg.seed, self.step)
                self.gp_noise.manual_seed(seed)
                if self._seeds_dropout:
                    # each 'data' rank its own masks ('model' ranks alike)
                    index = self.mesh.coords["data"]
                    torch.manual_seed(_derived_seed(seed, index) if index else seed)
                t0 = time.perf_counter()
                out = self.step_fn(*(np.ascontiguousarray(t)
                                     for t in local(x, a, dx, da)))
                if sync:
                    torch.cuda.synchronize(self.device)
                if time_steps:
                    self.step_seconds.append(time.perf_counter() - t0)
                self.step += 1
            # a work item logs its last step's losses (JAX logs the last of a
            # dispatch's K)
            pending.append((epoch, it, self.step, out))
            at_cadence = self.step % cfg.log_sample_step < n_steps
            if len(pending) >= flush_every or at_cadence:
                flush()
            if at_cadence:
                # the global batch's logits (collective); rank 0 writes
                node_logits, edge_logits = (
                    pmesh.unshard(self.mesh, out[key].float(), spec).cpu().numpy()
                    for key, spec in zip(("node_logits", "edge_logits"), specs))
                # the whole state is a collective under mesh_model; elsewhere
                # only the writer builds it
                if not (self.writer or self.tp_k > 1):
                    continue
                state = self.state()
                gd = [self._whole(model) for model in (self.G, self.D)]
                if not self.writer:
                    continue
                # --features: x is a dense block; the atom labels are its
                # one-hot prefix's
                x_labels = (np.argmax(x[..., :self.vocab.m_dim], -1)
                            if cfg.features else x)
                chem = training_metrics(node_logits, edge_logits, x_labels, a,
                                        self.vocab, self.drug_smiles,
                                        self.drug_fps, max_atom=self.vertexes)
                self.logger.log(chem, step=self.step)
                n_valid = save_sample_artifacts(
                    self.sample_dir, epoch, it, node_logits, edge_logits,
                    self.vocab)
                print(f"samples saved at epoch {epoch} iteration {it} "
                      f"({n_valid} valid)", flush=True)
                ckpt.save_gd_params(self.model_dir, *gd, epoch + 1, it + 1,
                                    stacked=cfg.scan_layers)
                ckpt.save_state(self.model_dir, state,
                                guarded=cfg.nonfinite_guard,
                                stacked=cfg.scan_layers)
                print(f"model saved at epoch {epoch} iteration {it}",
                      flush=True)
        flush()
        # final checkpoint + submodel export for inference
        if self.writer or self.tp_k > 1:
            state, g_sd = self.state(), self._whole(self.G)
        if self.writer:
            ckpt.save_state(self.model_dir, state, guarded=cfg.nonfinite_guard,
                            stacked=cfg.scan_layers)
            ckpt.save_generator(os.path.join(self.model_dir,
                                             f"{cfg.submodel}-G.ckpt"), g_sd,
                                stacked=cfg.scan_layers)
        self.logger.finish()
        return self
