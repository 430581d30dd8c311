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

Not ported (each raises ``NotImplementedError``): the parallel modes
(``mesh_*``, ``distributed``).
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
from druggen_tpu_torch.data.dataset import BatchIterator, GraphData, load_dataset
from druggen_tpu_torch.infer.engine import resolve_device
from druggen_tpu_torch.interop.weights import to_torch_tensors
from druggen_tpu_torch.models import Discriminator, Generator
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


def _reject_unported(cfg: TrainConfig) -> None:
    unported = {
        "mesh_model": cfg.mesh_model > 1, "mesh_node": cfg.mesh_node > 1,
        "mesh_data": cfg.mesh_data > 1, "distributed": cfg.distributed,
    }
    bad = [name for name, on in unported.items() if on]
    if bad:
        raise NotImplementedError(f"{', '.join(bad)}: not ported to "
                                  "druggen_tpu_torch yet (ROADMAP queue A)")


class Trainer:
    def __init__(self, cfg: TrainConfig, vocab: Vocab | None = None,
                 data: GraphData | None = None,
                 drug_data: GraphData | None = None):
        _reject_unported(cfg)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        if cfg.set_seed:
            np.random.seed(cfg.seed)
            random.seed(cfg.seed)
            os.environ["PYTHONHASHSEED"] = str(cfg.seed)
            torch.manual_seed(cfg.seed)

        # ---- data (reference train.py:76-115)
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
        # shape inference (reference train.py:117-119): the atom types, or
        # the one-hot + feature block's width
        self.m_dim = self.vocab.m_dim + self.data.feature_dim
        self.b_dim = self.vocab.b_dim
        self.vertexes = int(self.data.x.shape[1])
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
        self.G.to(self.device)
        self.D.to(self.device)
        self.g_opt, self.d_opt = make_optimizers(cfg, self.G, self.D)
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
        if cfg.split_step and cfg.steps_per_dispatch > 1:
            print("split_step: steps_per_dispatch ignored")
        self._build_step_fns(start_tier)

        # ---- dirs + logging (reference train.py:283-289)
        self.run_name = cfg.run_name
        self.model_dir = os.path.join(cfg.model_save_dir, self.run_name)
        self.sample_dir = os.path.join(cfg.sample_dir, self.run_name)
        os.makedirs(self.model_dir, exist_ok=True)
        os.makedirs(self.sample_dir, exist_ok=True)
        self.logger = RunLogger(cfg.log_dir, self.run_name,
                                use_wandb=cfg.use_wandb, online=cfg.online,
                                config=vars(cfg))
        self._write_module_summaries()

        # drug fingerprints for the SNN metric (reference train.py:292-294)
        self.drug_smiles = self.drug_data.smiles
        self.drug_fps = fingerprints_for_smiles(self.drug_smiles)
        self.step = 0                       # committed training steps
        self.step_seconds: list[float] = []

        # ---- resume (JAX trainer.py:257-270)
        if cfg.resume:
            if cfg.resume_epoch is not None and cfg.resume_iter is not None:
                directory = cfg.resume_directory or self.model_dir
                g_sd, d_sd = ckpt.restore_gd_params(
                    directory, cfg.resume_epoch, cfg.resume_iter)
                self._load_params(g_sd, d_sd)
                print(f"restored G/D params from {directory} "
                      f"{cfg.resume_epoch}-{cfg.resume_iter}")
            else:
                restored = ckpt.restore_state(
                    cfg.resume_directory or self.model_dir, self.state(),
                    guarded=cfg.nonfinite_guard, stacked=cfg.scan_layers)
                if restored is not None:
                    self.load_state(restored)
                    print(f"auto-resumed at step {self.step}")

    # ------------------------------------------------------------------
    def state(self) -> dict:
        """The training state as ``{g, d, g_opt, d_opt, step}`` (numpy
        copies; :func:`..interop.weights.gan_state_to_port`'s form)."""
        def numpy(t):
            return t.detach().cpu().numpy().copy()

        def tree(sd):
            return {k: numpy(v) for k, v in sd.items()}

        def opt(o):
            mu, nu = o.moments()
            st = o.state
            return {"count": numpy(st.count), "mu": tree(mu), "nu": tree(nu),
                    "notfinite_count": numpy(st.notfinite_count),
                    "total_notfinite": numpy(st.total_notfinite)}

        return {"g": tree(self.G.state_dict()), "d": tree(self.D.state_dict()),
                "g_opt": opt(self.g_opt), "d_opt": opt(self.d_opt),
                "step": self.step}

    def _load_params(self, g_sd: dict, d_sd: dict) -> None:
        # copies into the existing parameters, which stay views of the
        # optimizers' flat buffers
        self.G.load_state_dict(to_torch_tensors(g_sd))
        self.D.load_state_dict(to_torch_tensors(d_sd))

    def load_state(self, state: dict) -> None:
        """Set parameters, optimizer states and the step from ``state``
        (the form :meth:`state` returns)."""
        self._load_params(state["g"], state["d"])
        for o, st in ((self.g_opt, state["g_opt"]), (self.d_opt, state["d_opt"])):
            o.load_state(st["count"], to_torch_tensors(st["mu"]),
                         to_torch_tensors(st["nu"]), st["notfinite_count"],
                         st["total_notfinite"])
        self.step = int(state["step"])

    # ------------------------------------------------------------------
    def _write_module_summaries(self) -> None:
        """Param-shape dumps per model (reference print_network,
        train.py:228-248)."""
        for name, model in (("G", self.G), ("D", self.D)):
            path = os.path.join(self.model_dir, f"{name}_modules.txt")
            with open(path, "w") as f:
                f.write(f"{name} ({type(self).__name__})\n")
                for key, p in model.named_parameters():
                    f.write(f"  - {key}: {tuple(p.shape)}\n")
                f.write("Total number of parameters: "
                        f"{sum(p.numel() for p in model.parameters())}\n")

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
        self.step_fn = TrainStep(self.G, self.D, self.g_opt, self.d_opt,
                                 lambda_gp=cfg.lambda_gp, m_dim=self.m_dim,
                                 b_dim=self.b_dim, submodel=cfg.submodel,
                                 node_mode="dense" if cfg.features else "labels",
                                 gp_mode=cfg.gp_mode, split=cfg.split_step,
                                 generator=self.gp_noise, **kw)

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
        mol_iter = BatchIterator(self.data, cfg.batch_size, seed=cfg.seed)
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
              f"{len(self.drug_data)} drugs, device={self.device})", flush=True)
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
                                for *_, m in pending]).cpu().tolist()
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
                    torch.manual_seed(seed)
                t0 = time.perf_counter()
                out = self.step_fn(x, a, dx, da)
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
                node_logits = out["node_logits"].float().cpu().numpy()
                edge_logits = out["edge_logits"].float().cpu().numpy()
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
                ckpt.save_gd_params(self.model_dir, self.G, self.D,
                                    epoch + 1, it + 1, stacked=cfg.scan_layers)
                ckpt.save_state(self.model_dir, self.state(),
                                guarded=cfg.nonfinite_guard,
                                stacked=cfg.scan_layers)
                print(f"model saved at epoch {epoch} iteration {it}",
                      flush=True)
        flush()
        # final checkpoint + submodel export for inference
        ckpt.save_state(self.model_dir, self.state(), guarded=cfg.nonfinite_guard,
                        stacked=cfg.scan_layers)
        ckpt.save_generator(os.path.join(self.model_dir,
                                         f"{cfg.submodel}-G.ckpt"), self.G,
                            stacked=cfg.scan_layers)
        self.logger.finish()
        return self
