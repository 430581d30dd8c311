"""Training and inference configuration of the port.

Copied from ``druggen_tpu/config.py`` (``TrainConfig``, ``InferenceConfig``,
``parse_train_args``, ``parse_inference_args`` and their helpers) with one
flag added to each: ``--device`` (default ``cuda``).  ``platform`` is kept so
that the JAX CLI's command lines parse unchanged; the port ignores it and
runs on ``device``.  Knobs of the JAX package that the port does not run
(the parallel modes: ``mesh_*``, ``distributed``) parse and raise
``NotImplementedError`` in the trainer.
``InferenceConfig.use_pallas`` serves through the whole-generator kernel
(K9).  ``TrainConfig.use_pallas`` runs the Generator's attention through
the fused edge-attention kernels, ``TrainConfig.fused_block`` every encoder
block's edge stream through the megablock kernels (the Generator and the
critic's first-order passes).
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass


@dataclass
class TrainConfig:
    # Data (reference train.py:404-408)
    raw_file: str = ""
    drug_raw_file: str = ""
    drug_data_dir: str = "data"
    mol_data_dir: str = "data"
    features: bool = False
    vocab_ref12: bool = False            # widen the scanned vocab with the
    # published ChEMBL-v29 atom set (12 types incl. Ca/K/As — reference
    # README.md:141-145) so the output space matches the reference and
    # released m_dim-13 checkpoints import without index surgery

    # Model (reference train.py:411-421)
    submodel: str = "DrugGEN"            # DrugGEN | NoTarget
    act: str = "relu"
    max_atom: int = 45
    dim: int = 128
    depth: int = 1
    ddepth: int = 1
    heads: int = 8
    mlp_ratio: int = 3
    dropout: float = 0.0
    ddropout: float = 0.0
    d_head_mult: int = 1                 # widen the critic head 64/32/16 ->
    # 64m/32m/16m — ablation-only knob (r4 oscillation study); 1 is the
    # reference topology and the ckpt-interop contract
    lambda_gp: float = 10.0

    # Training (reference train.py:424-433)
    batch_size: int = 128
    epoch: int = 10
    g_lr: float = 1e-5
    d_lr: float = 1e-5
    beta1: float = 0.9
    beta2: float = 0.999
    log_dir: str = "experiments/logs"
    sample_dir: str = "experiments/samples"
    model_save_dir: str = "experiments/models"
    log_sample_step: int = 1000

    # Resume (reference train.py:436-439)
    resume: bool = False
    resume_epoch: int | None = None
    resume_iter: int | None = None
    resume_directory: str | None = None

    # Seed / logging (reference train.py:442-449)
    set_seed: bool = False
    seed: int = 1
    use_wandb: bool = False
    online: bool = False
    exp_name: str = "druggen"
    parallel: bool = False

    # --- TPU-native extensions ---
    platform: str | None = None          # None => let jax pick; "cpu" forces
    compute_dtype: str = "float32"       # "float32" | "bfloat16"
    use_pallas: bool = False             # fused edge-attention kernel
    fused_mlp: bool = False              # fused LN->MLP->LN edge-tail kernel
    # (Generator only; first-order AD — see druggen_tpu/ops/fused_mlp.py)
    fused_critic: bool = False           # fused edge-tail kernel on the
    # critic's first-order passes too (GP pass stays XLA; depth>1 payoff)
    fused_block: bool = False            # v5 megablock kernel: each
    # encoder block's WHOLE edge stream in one Pallas residency
    # (ops/fused_block.py) on the Generator + the critic's first-order
    # passes.  Measured SLOWER than fused_mlp+fused_critic on the v5e
    # relay chip (PERF.md) — available for other hardware / future tiles.
    scan_layers: bool = False            # lax.scan over stacked encoder
    # blocks: depth-independent compile time/program size (deep configs)
    gp_mode: str = "revrev"              # gradient-penalty AD structure:
    # "revrev" (reference-style double reverse) | "fwdrev" (reverse-over-
    # forward, same gradients — see losses.gradient_penalty_fwdrev)
    mesh_data: int = 0                   # 0 => all visible devices on 'data'
    mesh_model: int = 1                  # >1: tensor parallelism — shard
    # the attention/MLP weight matrices over a 'model' mesh axis (Megatron
    # column/row pattern, parallel/tensor_parallel.py).  dim must be
    # divisible by mesh_model.  For wide configs (dim >= 512); the default
    # dim-128 model does not need it.
    mesh_node: int = 1                   # >1: edge-partitioned giant-batch
    # training — shard the [B,N,N,dim] edge streams' first vertex axis over
    # a 'node' mesh axis of this size (full WGAN-GP step under shard_map;
    # see druggen_tpu/parallel/edge_partition.py).  The dataset is padded so
    # vertexes % mesh_node == 0.  Requires dropout=0 and no --features.
    adam_weight_decay: float = 0.01      # torch AdamW default (reference
    # train.py:213-214 uses torch.optim.AdamW default weight_decay)
    steps_per_dispatch: int = 1          # >1: lax.scan K train steps per
    # host dispatch (hides host/relay latency; metrics logged per chunk)
    split_step: bool = False             # split the iteration into two
    # compiled programs (D update incl. GP, then G update) — halves program
    # size so DEEP unrolled configs get through compilers that reject the
    # single-jit program (the relay's depth>=4 limit, PERF.md); costs one
    # extra dispatch + a repeated G forward (the reference's own structure)
    distributed: bool = False            # multi-host: jax.distributed.init
    coordinator_address: str = ""        # optional explicit coordinator
    num_processes: int = 0               # 0 => env-based discovery
    process_id: int = -1                 # -1 => env-based discovery
    log_flush_steps: int = 16            # hard-sync + write buffered loss
    # rows every N dispatches.  JAX dispatch is asynchronous; fetching a
    # loss value every step (the reference prints per-iteration,
    # train.py:318) serializes the host against the device and through a
    # remote-attached TPU costs a full round-trip per step.  Buffering the
    # device scalars and fetching every N bounds the in-flight queue
    # (remote relays cap ~20 queued executions) while keeping the JSONL
    # per-step rows identical.  1 restores the reference's per-step sync.
    gp_f32: str = "auto"                 # gradient-penalty precision under
    # bf16 compute: "off" = all-bf16 (fastest, NaN'd at ~50k steps of the
    # reference-scale run), "on" = f32 GP pass every step (stable, -20%
    # at batch 768), "auto" (default) = start bf16 and permanently escalate
    # to the f32 program the first time the loss window goes non-finite —
    # full speed for the healthy regime, self-healing at the frontier
    # (PERF.md round 4)
    f32_stats: str = "auto"              # LayerNorm/softmax precision under
    # bf16 compute — tier 2 of the numerics ladder: "off" = bf16
    # reductions, "on" = f32 reductions from step 0 (fused kernels drop
    # out), "auto" (default) = escalate to the f32-reduction program only
    # if losses stay non-finite AFTER the gp_f32 escalation (the bf16
    # forward itself at the numeric edge — the failure mode that ended the
    # round-4 reference-scale run's healthy span at ~64k steps)
    f32_full: str = "auto"               # final numerics-ladder tier:
    # "auto" (default) = if losses stay non-finite after gp_f32 AND
    # f32_stats escalation, recompile the whole step in f32 (the
    # reference's own numerics; slowest, last resort); "off" disables
    nonfinite_guard: bool = True         # skip optimizer updates whose
    # grads contain non-finite values (optax.apply_if_finite) — one bad
    # step cannot poison the params (PERF.md round 4); --no_nonfinite_guard
    # restores raw AdamW
    prefetch_depth: int = 2              # host-side batch prefetch queue
    # depth (background thread slices the next batches while the device
    # runs); 0 disables the thread
    # the port's own
    device: str = "cuda"

    @property
    def run_name(self) -> str:
        """Reference run-name scheme (train.py:159)."""
        import os
        dataset_name = (os.path.splitext(os.path.basename(self.raw_file))[0]
                        + str(self.max_atom)) if self.raw_file else "none"
        return (f"{self.exp_name}_{self.submodel}_glr{self.g_lr}_dlr{self.d_lr}"
                f"_dim{self.dim}_depth{self.depth}_heads{self.heads}"
                f"_batch{self.batch_size}_epoch{self.epoch}"
                f"_dataset{dataset_name}_dropout{self.dropout}")


@dataclass
class InferenceConfig:
    # reference inference.py:297-317
    submodel: str = "DrugGEN"
    inference_model: str = ""
    sample_num: int = 100
    disable_correction: bool = False
    inf_smiles: str = ""
    train_smiles: str = ""
    train_drug_smiles: str = ""
    inf_batch_size: int = 1
    inf_max_batches: int = 0             # optional hard batch cap for the
    # sampling loop; 0 (default) = loop until sample_num valid molecules
    # like the reference (inference.py:226-228), with a stagnation guard
    # for dead generators
    mol_data_dir: str = "data"
    features: bool = False
    vocab_ref12: bool = False            # widen the scanned vocab with the
    # published ChEMBL-v29 atom set (reference README.md:141-145)
    act: str = "relu"
    max_atom: int = 45
    dim: int = 128
    depth: int = 1
    heads: int = 8
    mlp_ratio: int = 3
    dropout: float = 0.0
    set_seed: bool = False
    seed: int = 1
    # extensions of the JAX package
    platform: str | None = None          # JAX backend name; unused here
    compute_dtype: str = "float32"
    use_pallas: bool = False             # whole-generator kernel (K9)
    fused_mlp: bool = False              # fused edge-tail kernel (K1)
    output_dir: str = "experiments/inference"
    # the port's own
    device: str = "cuda"


def _add_fields(parser: argparse.ArgumentParser, cfg_cls, skip=()) -> None:
    for f in dataclasses.fields(cfg_cls):
        if f.name in skip:
            continue
        name = f"--{f.name}"
        if f.type in ("bool", bool):
            if f.default is True:
                # default-on booleans are disabled with --no_<name>
                parser.add_argument(f"--no_{f.name}", dest=f.name,
                                    action="store_false", default=True)
            else:
                parser.add_argument(name, action="store_true",
                                    default=f.default)
        elif f.default is None or f.type in ("int | None", "str | None"):
            typ = int if "int" in str(f.type) else str
            parser.add_argument(name, type=typ, default=f.default)
        else:
            parser.add_argument(name, type=type(f.default), default=f.default)


_DTYPE_ALIASES = {"float32": "float32", "f32": "float32", "fp32": "float32",
                  "bfloat16": "bfloat16", "bf16": "bfloat16"}


def _normalize_dtype(parser: argparse.ArgumentParser, value: str) -> str:
    """Canonicalize --compute_dtype, rejecting unknown strings."""
    canon = _DTYPE_ALIASES.get(value.lower())
    if canon is None:
        parser.error(f"--compute_dtype must be one of "
                     f"{sorted(set(_DTYPE_ALIASES))}, got {value!r}")
    return canon


def parse_train_args(argv=None) -> TrainConfig:
    parser = argparse.ArgumentParser(description="druggen_tpu_torch training")
    _add_fields(parser, TrainConfig)
    ns = parser.parse_args(argv)
    ns.compute_dtype = _normalize_dtype(parser, ns.compute_dtype)
    cfg = TrainConfig(**vars(ns))
    # reference guard train.py:454-459
    if cfg.submodel == "DrugGEN" and not cfg.drug_raw_file:
        parser.error("--drug_raw_file is required when using DrugGEN model")
    if cfg.submodel == "NoTarget" and not cfg.drug_raw_file:
        cfg.drug_raw_file = cfg.raw_file
    if not cfg.raw_file:
        parser.error("--raw_file is required")
    return cfg


def parse_inference_args(argv=None) -> InferenceConfig:
    parser = argparse.ArgumentParser(description="druggen_tpu_torch inference")
    _add_fields(parser, InferenceConfig)
    ns = parser.parse_args(argv)
    ns.compute_dtype = _normalize_dtype(parser, ns.compute_dtype)
    cfg = InferenceConfig(**vars(ns))
    if not cfg.inf_smiles:
        parser.error("--inf_smiles is required")
    if not cfg.train_smiles or not cfg.train_drug_smiles:
        parser.error("--train_smiles and --train_drug_smiles are required")
    return cfg
