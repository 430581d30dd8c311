#!/usr/bin/env python3
"""Drive the PyTorch port (``druggen_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printed with its wall time; any failure raises and the script
exits non-zero without printing a result line:

1. device   — card name, count and ``nvidia-smi`` name/power limit.
2. build    — compile every kernel source with nvcc (``-Xptxas -v``), one
               nvcc a (source, widths), all started together; each
               kernel's registers and spills, and the Hopper routes' launch
               plans held against the libraries' shared memory and tiles
               (K1/K2, K5/K6, K7/K8, K9's route and K3/K4 at phase 3's
               shapes, with the blocks a SM the runtime keeps resident).
3. kernels  — each kernel against its plain PyTorch version on the card, at
               the main paths' shape (bf16 and f32) and on a ragged shape:
               K1 (``fused_ln_mlp_ln`` forward) and K2 (its backward), also
               built for dim 64, for dim 128 with mlp_ratio 4 (weights
               streamed from L2) and for dim 512 (the split path); K5
               (``edge_attention_fwd``) and K6 (its backward) at the
               training shape, at D 256 and on a ragged N,
               K6 twice for the same bits; K7 (``fused_block_fwd``, the
               megablock) and K8 (its backward) at the training shape and
               at N 13, D 256, K8 twice for the same bits; K9
               (``fused_generator_logits``, the whole Generator) with the
               trained r2_scale weights on corpus one-hots at the serving
               shape and with random weights at N 13 / depth 2 and at dims
               64 and 256, and on its Hopper route (bf16, dim 128) launch by
               launch against the plain stages at the serving shape and at
               N 13 / depth 2, twice for the same bits; K3 (``edge_attention_v2_fwd``) and K4 (its
               backward) at the training shape, on a ragged N and at the
               largest N the JAX rule admits (108 bf16, 89 f32), both twice
               for the same bits.
4. serving  — the port's ``InferenceEngine.run()`` on the trained r2_scale
               Generator (bf16, fused edge tail), 4 batches of 512 graphs;
               the kernel launch counts of that run are checked.
4u. serving with ``use_pallas`` — the same run through K9: one K9 launch a
               forward and no K1; the forward's peak memory on K9's Hopper
               route and through the generic kernels.
4a. the v2 op — ``edge_modulated_attention`` forward and backward at the
               training shape through autograd: one K3 and one K4 launch.
5. agree    — kernel path vs the plain bf16 path on one batch (labels);
               K9 vs its plain version (held), f32 K9 vs the f32 plain
               Generator (held), bf16 K9 vs slice 1's K1 path (printed).
6. timing   — each kernel, its plain version and an eager yardstick, CUDA
               events, beside the card's bound (K1, K2, also at 128/512 and
               on the split path at 512/1536;
               K5, K6, K7, K8; K9 beside slice 1's forward and the generic
               kernels; K3 and K4 with their achieved bytes a second and
               their device launches a call, one each, counted by the
               profiler); K2's three, K6's five and K8's seven
               launches one by one (torch.profiler); beside K1, K2, K5, K6, K7 and K8 the same
               products through torch.matmul, a labelled reference (2 for
               K1, 6 for K2; 2 for K5 and 5 for K6 in f32; 4 for K7 and 12
               for K8, bf16 where both operands are exact in bf16, else f32
               with TF32 off).
7. profile  — one serving forward under torch.profiler, without and with
               ``use_pallas``: device time by kernel, the card's idle share
               of the forward and its peak memory; K9's node, attention and
               tail launches from that profile.
8. training — the port's ``Trainer`` (what ``python -m
               druggen_tpu_torch.train`` runs) at the full r2_scale config
               (bf16, fused_mlp + fused_critic, batch 512) for one epoch of
               16 steps over the first 8,192 corpus molecules; the launch
               counts, finite losses, moved parameters and the written
               ``DrugGEN-G.ckpt`` (served by ``InferenceEngine``) are checked.
8p. training with ``--use_pallas`` — the same run with the Generator's
               attention through K5/K6: launch counts of K1, K2, K5 and K6,
               finite losses, moved parameters, the checkpoint served back.
8b. training with ``--fused_block`` — the same run with every encoder
               block's edge stream through the megablock (G and the critic's
               first-order passes): launch counts of K7 and K8 (and none of
               K1, K2, K5, K6), finite losses, moved parameters, the
               checkpoint served back.
8f. training with ``--gp_mode fwdrev`` — phase 8's run with the
               reverse-over-forward penalty (its inner pass first-order, its
               JVP pass the plain critic): launch counts, finite losses,
               moved parameters, the checkpoint served back.
8fb. training with ``--fused_block --gp_mode fwdrev`` — the same with the
               megablock, which the penalty's inner pass runs too: K7 and
               K8 G depth + 4 x critic depth a step (5).
8o. training options — 4 steps each from phase 8's start, no cadence:
               ``--split_step`` and ``--steps_per_dispatch 4`` (their logged
               losses held to phase 8's on the same steps, ``TOL_STEP``),
               ``--scan_layers`` (the stacked export and state, the export
               served back), ``--features`` (m_dim + 54 dense node blocks,
               the first 2,048 molecules and drugs on the Python
               featurizer); K1/K2 launches counted.
9. step agreement — one step from the same state through the kernels and
               through the plain versions, bf16 and f32: losses, every
               gradient of G and D, and the G edge tails' gradients, against
               K1/K2's plain versions and against the plain path (the bf16
               tails on the same rows and cotangent, after a diagnosis that
               records the tail's input and cotangent in both steps and an
               f32 one); then the same with ``use_pallas`` (and the G
               attention's gradients, against K5/K6's plain versions) and
               with ``--fused_block`` (against K7/K8's plain versions).
               The fwdrev step against the revrev step from phases 8f and
               8fb's states, bf16 and f32 (the critic's gradients held where
               both penalties round at the same points), through K7/K8 and,
               at critic depth 2 with ``--fused_critic``, through K1/K2
               against their plain versions; the f32 fwdrev gradients with
               the JVP pass's LayerNorm from primitives and through
               ``F.layer_norm`` against the double backward's (printed).
10. step profile — one training step under torch.profiler, without and
               with ``use_pallas``, with ``--fused_block`` and with
               ``--gp_mode fwdrev`` alone and with ``--fused_block``: device
               time by kernel, each kernel's share, the card's idle share
               and the step's peak memory.
11. native set-up — the native chem library built from the checkout's
               source with g++ (timed), then the vocabulary scan and the
               featurization of all 150,000 corpus molecules through it
               (seconds, molecules a second); the Python path on the first
               8,192, bit-equal to the native rows (vocab, kept indices, X,
               A) and timed.
12. checkpoint selection — ``select_checkpoint.main`` (bf16,
               ``--fused_mlp``, 1,024 samples, batches of 512, 2 finalists at
               2,048) on phase 8's two cadence exports and the trained
               r2_scale Generator under a cadence name: a row for each,
               every field finite and in range, one K1 launch a forward and
               no other kernel; seconds of each checkpoint by forward, decode
               and quality terms; the ranking.
13. offline evaluation — ChemNet (``default_config``, ``random_init(0)``)
               on 256 corpus SMILES on the card and on the CPU in f32, held at
               ``TOL_CHEMNET`` (TF32's distance printed); its CUDA-event ms for
               a batch of 128; ``evaluate.main`` on phase 4c's delivered set
               against phase 8's 8,192 molecules and the AKT1 drugs, with the
               surrogate FCD and with that ChemNet as ``.npz``: the JAX
               evaluator's keys in order, each finite and in range; host
               seconds by part.
14. neural correctors — 14a: the two correctors the JAX package trained
               (``experiments/corrector_r4``, native and reference topology,
               full width) loaded on the card and on the CPU: teacher-forced
               logits of 16 held-out pairs held at ``TOL_CHEMNET`` (f32, TF32
               off), the greedy strings of 8 sources equal; the 122 held-out
               sources decoded on the card (seconds, SMILES a second, peak
               memory) and ``evaluate_corrector``'s six metrics beside the
               recorded ``eval.json``.  A checkout without those weights (a
               ``git archive``: ``.gitattributes``) holds 14b's correctors
               instead, after 14b.  14b: ``train_corrector.main --arch both``
               at full width (hid 256, 3 layers, 8 heads, pf 512, max-len
               202), batch 32, 300 steps, mining 4,096 graphs of a
               JAX-trained Generator (phase 8's last export, which gives no
               pair, mined on one batch first): pairs mined, losses finite and falling, the JAX
               file layout read back with the same translations, ``eval.json``
               in range; step ms (CUDA events) and peak memory per topology.
               14c: ``SmilesCorrector.default()`` from
               ``$DRUGGEN_CORRECTOR_CKPT`` and from
               ``$DRUGGEN_REFERENCE_CORRECTOR``; ``correct()`` on 4c's
               delivered set and the held-out sources: one ``translate_batch``
               on the card, the rescued count, the rule path's output on the
               rescued set.  14d: the trained r2_scale Generator exported by
               ``import_torch_ckpt --reverse``, served from the reference
               ``.ckpt`` plain and with ``module.``: a batch of 512, labels
               bit-equal to the msgpack engine's; one forward under
               ``utils/profiling.trace`` writes a trace.
15. parallel training — two ranks on cuda:0 under a gloo group the phase
               starts (each child joined within ``PAR_JOIN_S``), the port's
               ``Trainer`` on the caller's group at the r2_scale config (batch
               512 global, bf16, seed 42), 4 steps on the first 2,048 corpus
               molecules: 15a ``--mesh_data 2 --fused_mlp --fused_critic``,
               15b ``--mesh_node 2 --fused_mlp`` (N padded 45 -> 46), 15c
               ``--mesh_model 2 --fused_mlp``; every rank's losses and rank
               0's parameters after each step (and step 1's gradients, but
               15c's) held to a single-rank run of the same steps from the
               same state on the same data (``TOL_STEP``); K1/K2 launches
               per rank (the wrappers; the profiler on one more step); K1/K2
               at 15b's block shape against their plain versions; rank 0's
               export served back; per rank the step's CUDA-event ms, peak
               memory, backend and collective payload a step; then 15d
               ``entry.dryrun_multichip(2)`` on the two ranks.  Two ranks
               sharing one card over host transport measure no scaling.

The line before the last is the ``{"kernels": [...]}`` record; the last line
is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT_DIR = os.path.join(
    REPO, "experiments", "r2_scale", "models",
    "r2_scale_DrugGEN_glr1e-05_dlr1e-05_dim128_depth1_heads8_batch512_epoch35"
    "_datasetchembl_like_150k45_dropout0.0")
VOCAB_JSON = os.path.join(REPO, "data", "cache", "vocab",
                          "vocab_akt1_drugs_chembl_like_150k_45.json")
SMILES_FILE = os.path.join(REPO, "data", "chembl_like_150k.smi")
DRUG_FILE = os.path.join(REPO, "data", "akt1_drugs_2607.smi")
TRAIN_VOCAB_JSON = os.path.join(REPO, "data", "cache", "vocab",
                                "vocab_akt1_drugs_2607_chembl_like_150k_45.json")

SEED = 0
SERVE_BATCH = 512           # graphs per request batch
SERVE_BATCHES = 4
SERVE_MOLECULES = 4096      # first molecules of the corpus used as inputs
N_ATOMS, DIM, HIDDEN = 45, 128, 384
ROWS = SERVE_BATCH * N_ATOMS * N_ATOMS      # 1,036,800 edge rows per batch
RAGGED_ROWS = 1000
TRAIN_BATCH = 512
TRAIN_MOLECULES = 8192      # one epoch = 16 steps of 512
TRAIN_CADENCE = 8           # metrics, samples and G/D export every 8 steps
# phase 8o: steps of each option's run, and the corpus and drug molecules of
# the --features run (featurised on the Python path, as in JAX)
OPTION_STEPS = 4
OPTION_FEATURE_MOLECULES = 2048
# phase 4c, the CLI with its defaults: molecules asked for, and the training
# reference of the report's novelty (phase 8's 8,192 corpus molecules, not the
# 150k file: its canonical set is not cached in a copy of the repository, and
# canonicalising 150k molecules in the run would cost minutes)
CLI_SAMPLE_NUM = 1024
# the JAX engine's report, in its order (druggen_tpu/infer/engine.py:257-293),
# each numeric key with its range
REPORT_RANGES = {"validity": (0, 1), "generator_validity": (0, 1), "uniqueness": (0, 1),
                 "novelty": (0, 1), "novelty_inference": (0, 1),
                 "novelty_real_inhibitor": (0, 1), "ave_len": (0, 1),
                 "mean_atom_type": (0, 64), "snn_chembl": (0, 1),
                 "snn_real_inhibitor": (0, 1), "IntDiv": (0, 1), "qed": (0, 1),
                 "sa": (1, 10)}
# phases 11-13, the post-training pipeline.  11: the native set-up over the
# whole corpus, held bit for bit against the Python path on its first
# PY_SETUP_MOLECULES.  12: the selector ranks phase 8's two cadence exports
# and the trained r2_scale Generator (under a cadence name) as
# experiments/r5_scale/post_run.sh runs it, at SELECT_ARGS.  13: ChemNet at
# default_config, random_init(seed 0), on CHEMNET_MOLECULES corpus SMILES on
# the card and on the CPU in f32 (TF32 off), held at TOL_CHEMNET (f32 sums in
# another order through two LSTMs of 350 steps); the evaluator on phase 4c's
# delivered set against phase 8's 8,192 molecules (a 2,048 sample for the
# kernel metrics, as post_run.sh samples its 1.59M reference; novelty reads
# the whole file) and the drugs, with the surrogate FCD and with that
# ChemNet saved as .npz: the JAX evaluator's keys in its order
# (evaluate.py:64-205), each finite and in range.
PY_SETUP_MOLECULES = 8192
TRAINED_CADENCE_NAME = "35-292-G.ckpt"     # r2_scale: epoch 35, 292 steps an epoch
SELECT_ARGS = ["--sample_num", "1024", "--inf_batch_size", "512", "--finalists", "2",
               "--finalist_samples", "2048", "--compute_dtype", "bfloat16", "--fused_mlp"]
CHEMNET_MOLECULES = 256
CHEMNET_BATCH = 128
TOL_CHEMNET = (2e-4, 2e-5)                  # rtol, atol
EVAL_REF1_SAMPLE = 2048
EVAL_RANGES = {"validity": (0, 1), "uniqueness": (0, 1), "novelty_ref1": (0, 1),
               "internal_diversity": (0, 1), "internal_diversity_std": (0, 1),
               "novelty_ref2": (0, 1), "qed_mean": (0, 1), "qed_std": (0, 1),
               "sa_mean": (1, 10), "sa_std": (0, 10), "fcd_ref1": (0, math.inf),
               "fcd_ref2": (0, math.inf), "frag_sim_ref1": (0, 1), "scaf_sim_ref1": (0, 1),
               "frag_sim_ref2": (0, 1), "scaf_sim_ref2": (0, 1),
               # rules passed of Lipinski's five and Veber's two
               "lipinski_mean": (0, 5), "lipinski_std": (0, 5), "veber_mean": (0, 2),
               "veber_std": (0, 2), "pains_pass_rate": (0, 1)}
EVAL_COUNTS = ("fcd_is_literal", "n_generated", "n_reference_1",
               "n_reference_1_kernel_sample", "ref1_sample_seed", "n_reference_2")
# phase 14, the neural SMILES correctors.  14a: the two correctors the JAX
# package trained at full width (experiments/corrector_r4: vocab 82, hid 256,
# 8 heads, pf 512, 3 layers, max_len 202), teacher-forced logits of the first
# CORRECTOR_TF_PAIRS held-out pairs card against CPU at TOL_CHEMNET (f32, TF32
# off), greedy strings of the first CORRECTOR_GREEDY equal, all 122 held-out
# sources decoded on the card and evaluate_corrector's six metrics printed
# beside eval.json's (JAX decoded on the TPU at its matmul precision: printed,
# not held).  14b: train_corrector.main --arch both at that width, batch
# CORRECTOR_BATCH, CORRECTOR_STEPS steps, over phase 8's 8,192 molecules and
# the drugs (its vocabulary), mining CORRECTOR_GEN_SAMPLES graphs of
# CORRECTOR_GEN_CKPT: the JAX-trained NoTarget Generator of the same
# vocabulary, whose failures are repairable (phase 8's 16-step Generator
# gives none; 14b shows its mining on one batch).
CORRECTOR_R4 = os.path.join(REPO, "experiments", "corrector_r4")
CORRECTOR_TF_PAIRS = 16
CORRECTOR_GREEDY = 8
CORRECTOR_STEPS = 300
CORRECTOR_BATCH = 32
CORRECTOR_GEN_SAMPLES = 4096
CORRECTOR_GEN_CKPT = os.path.join(
    REPO, "experiments", "r2_notarget", "models",
    "r2_notarget_NoTarget_glr1e-05_dlr1e-05_dim128_depth1_heads8_batch512_epoch15"
    "_datasetchembl_like_150k45_dropout0.0", "NoTarget-G.ckpt")
# the JAX tool's evaluate_corrector keys, in order (scripts/train_corrector.py:119-126)
CORRECTOR_EVAL_KEYS = ("n_holdout", "validity_before", "validity_after", "exact_repair_rate",
                       "mean_tanimoto_to_target", "n_similarity_pairs")
# kernel vs plain, compared in f32.  bf16: the sums run in another order and
# an output of |y| <= 4 is worth ~2 bf16 ulps (2 * 2^-6); f32: order only.
TOL_BF16_MAX, TOL_BF16_MEAN, TOL_F32_MAX = 3e-2, 2e-3, 1e-4
# K1 at 128/512 reaches outputs above 4, where one bf16 ulp is 2^-5 =
# 0.03125: held at 3e-2 + 2^-7 |ref|, the card tests' K1 limit at every
# width (one rounding flip, nothing more)
TOL_BF16_WIDE_RTOL = 2 ** -7
# K2: ds as K1's output (bf16 with rtol 2^-6: dm and dh are rounded on the
# way), compared row by row.  A hidden unit whose pre-activation lies within
# rounding of the ReLU kink may take either side of it, in the kernel and in
# the plain version alike, which moves its row's ds by O(1e-1): each row
# beyond the tolerance must be witnessed as such (witness_kink_flips: the
# plain row matches the kernel's once the units within rounding reach of
# the kink are set to one side or the other), and such rows may be at most
# 0.1 % of the rows.  Then ds and each of the 8 parameter gradients (sums
# over all rows, in another order; by relative norm error) are held against
# the plain version with the witnessed settings.
TOL_GRAD_REL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
MAX_FLIP_ROW_SHARE = 1e-3
# step agreement, kernels vs plain versions from one state, by relative
# error of each loss, of each model's whole gradient and of the gradient of
# the Generator's fused edge tails (ln4, mlp2, ln6) on their own, against
# the same step through the kernels' plain versions (same rounding points)
# and through the plain path, which rounds at other points (bf16
# F.linear/F.layer_norm outputs against the kernels' f32 hidden and
# residual); f32 only sums in another order.  bf16 is held at 1e-2: the whole
# gradients against the plain path read 3.1e-3 (D) and 2.5e-3 (G) on an
# H100.  The tails' own gradients are held at 2.5e-2; against the plain path
# on the same rows and cotangent (phase 9's tail diagnosis; 1.8e-3 on an
# H100), because the step's own reading follows the cotangent that reaches
# the tail: ~1e-10 a row, it differs by 9 % between the two bf16 steps and
# by 13-14 % from the f32 step's, so the step's tail gradients read 8.7e-2
# from the state the published run reaches (8.4e-3 from an earlier one).
TOL_STEP = {torch.bfloat16: 1e-2, torch.float32: 1e-3}
TOL_TAIL = {torch.bfloat16: 2.5e-2, torch.float32: 1e-3}
TAIL_PARAMS = (".ln4.", ".mlp2.", ".ln6.")
MIN_LABEL_AGREEMENT = 0.999
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and dense bf16 FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

# each kernel source, with the widths it is built for (K1/K2 take theirs
# from the build: the published config's and dim 64 with mlp_ratio 3)
NARROW_DIM, NARROW_HIDDEN, NARROW_ROWS = 64, 192, 200_003
# dim 128 with mlp_ratio 4: K1/K2's bf16 weights do not fit one SM beside
# the tile's buffers, so the kernels stream them from L2 through a TMA ring
WIDE_HIDDEN = 512
# dim 512 with mlp_ratio 3: C padded to 64 above 256, so the bf16 K1/K2 take
# their split path (row kernels and wgmma GEMMs through device memory)
SPLIT_DIM, SPLIT_HIDDEN = 512, 1536
# K7/K8 at the training widths and at D 256 (mlp_ratio 3)
BLOCK_WIDE_DIM, BLOCK_WIDE_HIDDEN = 256, 768
KERNEL_BUILDS = (
    ("fused_mlp", {"KERNEL_C": DIM, "KERNEL_H": HIDDEN}),
    ("fused_mlp_bwd", {"KERNEL_C": DIM, "KERNEL_H": HIDDEN}),
    ("fused_mlp", {"KERNEL_C": NARROW_DIM, "KERNEL_H": NARROW_HIDDEN}),
    ("fused_mlp_bwd", {"KERNEL_C": NARROW_DIM, "KERNEL_H": NARROW_HIDDEN}),
    ("fused_mlp", {"KERNEL_C": DIM, "KERNEL_H": WIDE_HIDDEN}),
    ("fused_mlp_bwd", {"KERNEL_C": DIM, "KERNEL_H": WIDE_HIDDEN}),
    ("fused_mlp", {"KERNEL_C": SPLIT_DIM, "KERNEL_H": SPLIT_HIDDEN}),
    ("fused_mlp_bwd", {"KERNEL_C": SPLIT_DIM, "KERNEL_H": SPLIT_HIDDEN}),
    ("fused_attention", {}),
    ("fused_attention_bwd", {}),
    ("fused_block", {"KERNEL_C": DIM, "KERNEL_H": HIDDEN}),
    ("fused_block_bwd", {"KERNEL_C": DIM, "KERNEL_H": HIDDEN}),
    ("fused_block", {"KERNEL_C": BLOCK_WIDE_DIM, "KERNEL_H": BLOCK_WIDE_HIDDEN}),
    ("fused_block_bwd", {"KERNEL_C": BLOCK_WIDE_DIM, "KERNEL_H": BLOCK_WIDE_HIDDEN}),
    ("fused_attention_v2", {}),
    ("fused_attention_v2_bwd", {}),
)
# K9 at the published widths, at dim 64 with mlp_ratio 2 and at dim 256
K9_WIDTHS = ((DIM, HIDDEN), (NARROW_DIM, 2 * NARROW_DIM), (BLOCK_WIDE_DIM, BLOCK_WIDE_HIDDEN))
KERNEL_BUILDS += tuple(("fused_generator", {"KERNEL_C": c, "KERNEL_H": h}) for c, h in K9_WIDTHS)
# K9's Hopper route (bf16, dim 128, N <= 64): its edge-attention and
# edge-tail launches, at the published widths
KERNEL_BUILDS += (("fused_generator_hopper", {"KERNEL_C": DIM, "KERNEL_H": HIDDEN}),)
GRAD_NAMES = ("dg1", "dbl1", "dw1", "db1", "dw2", "db2", "dg2", "dbl2")
# K5/K6: the fused edge attention.  8 heads; the training shape, D 256 and
# a ragged N.  Outputs against the plain version, compared in f32: bf16
# |err| <= 1e-2 + 2^-7 |ref| (f32 sums in another order can round a value
# to the neighbouring bf16 one), f32 1e-4 + 1e-5 |ref|; K6's eight
# gradients by relative norm error, bf16 1e-3, f32 1e-5 (on an H100 bf16
# reads at most 2.7e-5; the plain K6 with e, de or its upstream gradient
# rounded to bf16 reads over 2e-3, tests/test_torch_port_fused_attention.py).
HEADS = 8
ATTN_SHAPES = ((TRAIN_BATCH, N_ATOMS, DIM), (64, N_ATOMS, 256), (7, 13, DIM))
ATTN_GRADS = ("dq", "dk", "dv", "d_eraw", "dwe", "dbe", "dwoe", "dboe")
TOL_ATTN = {torch.bfloat16: (1e-2, 2 ** -7), torch.float32: (1e-4, 1e-5)}
TOL_ATTN_GRAD_REL = {torch.bfloat16: 1e-3, torch.float32: 1e-5}
# With use_pallas the step through the kernels is held against the same step
# through K5/K6's plain versions (same rounding points) under TOL_STEP and
# TOL_TAIL, and in f32 against the plain path too; the bf16 plain path rounds
# e, t and the softmax at bf16 where K5/K6 keep f32, so that comparison is
# printed, not held (see the step agreement).  ATTN_PARAMS: G's attention.
ATTN_PARAMS = (".attn.",)
# f32 products at full f32 accuracy (NVIDIA data sheet): FMA on the CUDA
# cores, or 3xTF32 on the tensor cores (three TF32 products each, 495
# TFLOP/s).  The bounds (attn_bounds, block_bounds) price each product at
# the faster route its operand types allow (PEAK_F32_BF16_S and
# PEAK_F32_F32_S below); the FFMA time of the CUDA-core route is printed
# beside them.
PEAK_FFMA_S = 67e12
PEAK_3XTF32_S = 495e12 / 3
# An f32 operand split into three bf16 pieces (exact for normal floats) times
# a bf16-exact one: three bf16 passes; f32 x f32: the six significant piece
# products.  Each product is priced at the faster route its operand types
# allow (NVIDIA data sheet rates).
PEAK_F32_BF16_S = max(PEAK_FLOPS_S[torch.bfloat16] / 3, PEAK_3XTF32_S)
PEAK_F32_F32_S = max(PEAK_FLOPS_S[torch.bfloat16] / 6, PEAK_3XTF32_S)
# K7/K8, the megablock, against their plain versions (compared in f32).  K7's
# y_out and node_agg as K1's output: bf16 |err| <= 3e-2 + 2^-7 |ref| and mean
# 2e-3, f32 1e-4 + 1e-5 |ref|.  K8's dq, dk, dv, dy as K6's outputs: bf16
# 1e-2 + 2^-7 |ref|, f32 1e-4 + 1e-4 |ref| (a longer f32 chain); K8's f32
# pre-activation is summed in another order than the plain version's, so a
# hidden unit within rounding of the ReLU kink may take either side: each
# dy row beyond tolerance must be witnessed so (fused_block.
# witness_kink_flips), at most MAX_FLIP_ROW_SHARE of the rows, and then
# every output is held against the plain version with the witnessed
# settings; the 12 f32 parameter gradients by relative norm error, bf16
# 1e-3, f32 1e-5, as K6's.  The --fused_block step against the same step
# through K7/K8's plain versions under TOL_STEP (and TOL_TAIL on G's tails);
# in f32 also against the plain path.
BLOCK_SHAPES = ((TRAIN_BATCH, N_ATOMS, DIM, HIDDEN),
                (64, 13, BLOCK_WIDE_DIM, BLOCK_WIDE_HIDDEN))
TOL_BLOCK = {torch.bfloat16: (3e-2, 2 ** -7), torch.float32: (1e-4, 1e-5)}
TOL_BLOCK_GRAD = {torch.bfloat16: (1e-2, 2 ** -7), torch.float32: (1e-4, 1e-4)}
TOL_BLOCK_PARAM_REL = {torch.bfloat16: 1e-3, torch.float32: 1e-5}
# K9, the whole generator, against its plain version (the same rounding
# points), compared in f32: bf16 logits |err| <= 3e-2 + 2^-7 |ref| and mean
# <= 2e-3 (f32 sums in another order can move an intermediate by one bf16
# rounding, which the later layers carry), f32 1e-4.  Labels >= 99.9 % equal
# with the trained r2_scale weights (decisive logits); with random weights
# a differing label must be a near tie (the plain logits' top two within
# twice the bound).  K9_SMALL: batch, N and depth of the random-weight case.
TOL_K9 = {torch.bfloat16: (3e-2, 2 ** -7), torch.float32: (1e-4, 0.0)}
K9_SMALL = (64, 13, 2)
# K3/K4, the v2 op, against their plain versions as K5's outputs (TOL_ATTN),
# at the training shape and on a ragged N (bf16 and f32), and at the largest
# N the JAX rule admits at D 128 (108 in bf16, 89 in f32; one graph).  Their
# f32 operations per (edge row, channel), from the plain versions: K3 the
# modulate chain (5) and the softmax and weighted sum (7); K4 base, mod and t
# (5), the softmax (5), dot (3), dt (3), dbase and de (5), and the dq, dk, dv
# sums (6).
BOTH = (torch.bfloat16, torch.float32)
V2_SHAPES = (((TRAIN_BATCH, N_ATOMS, DIM), BOTH), ((7, 13, DIM), BOTH),
             ((1, 108, DIM), (torch.bfloat16,)), ((1, 89, DIM), (torch.float32,)))
V2_OPS = (12, 27)
# K3 and K4's kernels by name, for the profiler's count of device launches
V2_KERNELS = {"K3": "attn_v2_fwd_tma", "K4": "attn_v2_bwd_tma"}


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"== {name}", flush=True)
    yield
    print(f"== {name} done in {time.perf_counter() - t0:.2f} s", flush=True)


@contextlib.contextmanager
def generic_kernels(fg):
    """K9 through the generic kernels (``fused_generator.cu``'s edge pass) at
    every shape, for comparison with the Hopper route in the same run."""
    route = fg.hopper_route
    fg.hopper_route = lambda *args: False
    try:
        yield
    finally:
        fg.hopper_route = route


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` back-to-back
    calls, between two CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def tail_params(gen: torch.Generator, device, c: int = DIM, h: int = HIDDEN) -> tuple:
    """Random LN/MLP tail parameters (f32), at the serving width by default."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)
    g1, bl1 = 1 + 0.1 * randn(c), 0.1 * randn(c)
    w1, b1 = randn(c, h) / math.sqrt(c), 0.1 * randn(h)
    w2, b2 = randn(h, c) / math.sqrt(h), 0.1 * randn(c)
    g2, bl2 = 1 + 0.1 * randn(c), 0.1 * randn(c)
    return g1, bl1, w1, b1, w2, b2, g2, bl2


def tail_bound(rows: int, dtype, c: int = DIM, h: int = HIDDEN) -> tuple[float, str]:
    """Least milliseconds the card needs for one fused tail call: each input
    read once and each output written once, against the two products."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * rows * c * item              # s in, out
              + 2 * c * h * item               # W1, W2
              + (5 * c + h) * 4)               # LN params and biases (f32)
    flops = 2 * 2 * rows * c * h
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS_S[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tail_bwd_bound(rows: int, dtype, c: int = DIM, h: int = HIDDEN) -> tuple[float, str]:
    """Least milliseconds for one K2 call: read s and dout, write ds (and
    the weights and the f32 gradients once), against its six products (two
    forward products recomputed, four backward)."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (3 * rows * c * item + 2 * c * h * item
              + (5 * c + h) * 4
              + (2 * c * h + 6 * c + h) * 4)
    flops = 6 * 2 * rows * c * h
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS_S[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rel_err(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


# K2's three and K8's seven launches by kernel name (names no PyTorch kernel
# has); K7 is one launch
K2_LAUNCHES = {"rows": "tail_bwd_rows", "wgrad": "tail_bwd_wgrad", "reduce": "tail_bwd_reduce"}
K7_LAUNCH = "block_fwd_"
K8_LAUNCHES = {"fwd attn": "block_bwd_fwd_attn", "fwd mlp": "block_bwd_fwd_mlp",
               "mlp": "block_bwd_mlp", "attn": "block_bwd_attn", "node": "block_bwd_node",
               "wgrad": "block_bwd_wgrad", "reduce": "block_bwd_reduce"}
# K6's five launches on the Hopper route (bf16, D 128, N <= 64); the
# CUDA-core route's are rows, deraw, wgrad and reduce (attn_bwd_*_kernel)
K6_LAUNCHES = {"stats": "attn_bwd_stats", "rows": "attn_bwd_rows", "node": "attn_bwd_node",
               "wgrad": "attn_bwd_wgrad", "reduce": "attn_bwd_reduce"}
# K9's launches on the Hopper route: a node pass a depth and one after the
# last, and each depth's edge attention and edge tail (the keys begin the
# labels of fused_generator.route_by_launch)
K9_LAUNCHES = {"node": "gen_node_kernel", "attention": "gen_attn_wgmma", "tail": "gen_tail_wgmma"}


def device_events(fn, tries: int = 3) -> list:
    """The device events (torch.profiler's key averages) of one call of
    ``fn``, after a call to warm up.  A profile that holds no device event
    at all lost its trace (seen once on an H100 for a call whose kernel ran:
    the profiler returned nothing), so it is taken again, up to ``tries``
    profiles; a call that launches nothing still reads empty."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return events
        print(f"   (profile {attempt + 1} of a call held no device event; profiling again)")
    return events


def launch_split(fn, patterns: dict, required=None) -> dict:
    """Device milliseconds of one call of ``fn`` by kernel, summed over the
    kernels whose name contains each pattern (torch.profiler); a pattern of
    ``required`` (default: all) that matches no kernel raises."""
    out = {label: 0.0 for label in patterns}
    seen = set()
    for e in device_events(fn):
        for label, pat in patterns.items():
            if pat in e.key:
                out[label] += e.self_device_time_total / 1e3
                seen.add(label)
    missing = set(patterns if required is None else required) - seen
    if missing:
        raise AssertionError(f"no kernel named like {sorted(missing)} ran in the profiled call")
    return out


def matmul_products(rows: int, c: int, h: int, gen):
    """K1's two and K2's six products through torch.matmul in bf16 on
    random operands of the main shape: a reference time for the products
    alone, not a computation of K1 or K2."""
    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()
    x, hh, dm, dh = r(rows, c), r(rows, h), r(rows, c), r(rows, h)
    w1, w2 = r(c, h), r(h, c)

    def fwd():
        torch.matmul(x, w1)
        torch.matmul(hh, w2)

    def bwd():
        fwd()
        torch.matmul(dm, w2.t())
        torch.matmul(dh, w1.t())
        torch.matmul(x.t(), dh)
        torch.matmul(hh.t(), dm)
    return fwd, bwd


def block_matmul_products(rows: int, c: int, h: int, gen):
    """K7's four and K8's twelve products through torch.matmul on random
    operands of the main shape, each in the type of its route: bf16 where
    both operands are exact in bf16 (e; K7's fc1 and fc2), f32 with TF32 off
    for every f32-accurate one.  A reference time for the products alone,
    not a computation of K7 or K8."""
    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    bf = torch.bfloat16
    yb, hb, xc, xh = r(rows, c, dtype=bf), r(rows, h, dtype=bf), r(rows, c), r(rows, h)
    wcb, w1b, w2b = r(c, c, dtype=bf), r(c, h, dtype=bf), r(h, c, dtype=bf)
    wc, w1, w2 = wcb.float(), w1b.float(), w2b.float()

    def fwd():
        torch.matmul(yb, wcb)      # e
        torch.matmul(xc, wc)       # t Woe
        torch.matmul(yb, w1b)      # round(u) W1
        torch.matmul(hb, w2b)      # round(h) W2

    def bwd():
        torch.matmul(yb, wcb)      # e
        for a, b_ in ((xc, wc), (xc, w1), (xh, w2), (xc, w2.t()), (xh, w1.t()),
                      (xc, wc.t()), (xc, wc.t()),          # y1, hpre, m, dh, du, dt, dy
                      (xc.t(), xc), (xc.t(), xc),          # dWe, dWoe
                      (xc.t(), xh), (xh.t(), xc)):         # dW1, dW2
            torch.matmul(a, b_)
    return fwd, bwd


def bwd_row_ok(dtype):
    """K2's ds against its plain version, a bool per row (see above)."""
    if dtype == torch.bfloat16:
        return lambda a, b: ((a.float() - b.float()).abs()
                             <= TOL_BF16_MAX + 2 ** -6 * b.float().abs()).all(-1)
    return lambda a, b: ((a.float() - b.float()).abs() <= TOL_F32_MAX).all(-1)


def check_bwd_kernel(bwd, reference, witness, params, rows: int, dtype, gen) -> dict:
    """K2 against its plain version on the same inputs, with the rows beyond
    tolerance witnessed at the ReLU kink (see MAX_FLIP_ROW_SHARE)."""
    c = params[0].shape[0]
    s = torch.randn(rows, c, generator=gen, device="cuda").to(dtype)
    dout = torch.randn(rows, c, generator=gen, device="cuda").to(dtype)
    got = bwd(s, *params, dout)
    torch.cuda.synchronize()
    ref = reference(s, *params, dout)
    torch.cuda.synchronize()
    if got[0].shape != s.shape or got[0].dtype != dtype:
        raise AssertionError(f"K2 ds {got[0].shape} {got[0].dtype}")
    if not all(torch.isfinite(t.float()).all() for t in got):
        raise AssertionError("K2 output is not finite")
    row_ok = bwd_row_ok(dtype)
    max_err = (got[0].float() - ref[0].float()).abs().max().item()
    bad = torch.nonzero(~row_ok(got[0], ref[0])).flatten()
    del ref
    relu_set, unexplained = witness(s, params, dout, got[0], bad, row_ok)
    ref = reference(s, *params, dout, relu_set=relu_set)
    err = (got[0].float() - ref[0].float()).abs()
    set_max, mean_err = err.max().item(), err.mean().item()
    still = int((~row_ok(got[0], ref[0])).sum().item())
    rels = {name: rel_err(g, r) for name, g, r in zip(GRAD_NAMES, got[1:], ref[1:])}
    ok = (len(unexplained) == 0 and still == 0
          and len(bad) <= max(1, int(MAX_FLIP_ROW_SHARE * rows))
          and max(rels.values()) <= TOL_GRAD_REL[dtype]
          and (dtype != torch.bfloat16 or mean_err <= TOL_BF16_MEAN))
    print(f"   K2 C {c} rows {rows:>9,} {str(dtype):>14}: ds max |kernel - plain| "
          f"{max_err:.3e}; rows beyond tolerance {len(bad)}, witnessed at "
          f"the kink {len(bad) - len(unexplained)}; with the witnessed "
          f"settings: ds max {set_max:.3e}, mean {mean_err:.3e}, rows beyond "
          f"tolerance {still}; gradient rel. errors "
          + ", ".join(f"{k} {v:.1e}" for k, v in rels.items()), flush=True)
    if not ok:
        raise AssertionError(f"K2 disagrees with its plain version ({dtype}, "
                             f"rows {rows}): {len(bad)} rows beyond tolerance, "
                             f"not witnessed at the kink: "
                             f"{unexplained[:10].tolist()}; with the witnessed "
                             f"settings {still} rows beyond, ds mean {mean_err}, "
                             f"gradients {rels}")
    return {"max_abs_err": max_err, "mean_abs_err": mean_err,
            "grad_rel_err": max(rels.values())}


def check_kernel(fused, reference, params, rows: int, dtype, gen, rtol: float = 0.0) -> dict:
    """K1 against its plain version: bf16 max <= TOL_BF16_MAX + rtol |ref|
    and mean <= TOL_BF16_MEAN, f32 max <= TOL_F32_MAX."""
    s = torch.randn(rows, params[0].shape[0], generator=gen, device="cuda").to(dtype)
    out_k = fused(s, *params)
    torch.cuda.synchronize()
    out_p = reference(s, *params)
    torch.cuda.synchronize()
    if out_k.shape != s.shape or out_k.dtype != dtype:
        raise AssertionError(f"kernel output {out_k.shape} {out_k.dtype}")
    if not torch.isfinite(out_k.float()).all():
        raise AssertionError("kernel output is not finite")
    err = (out_k.float() - out_p.float()).abs()
    max_err, mean_err = err.max().item(), err.mean().item()
    print(f"   K1 C {s.shape[-1]} rows {rows:>9,} {str(dtype):>14}: max |kernel - plain| "
          f"{max_err:.3e}, mean {mean_err:.3e}", flush=True)
    if dtype == torch.bfloat16:
        ok = (bool((err <= TOL_BF16_MAX + rtol * out_p.float().abs()).all())
              and mean_err <= TOL_BF16_MEAN)
    else:
        ok = max_err <= TOL_F32_MAX
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version "
                             f"({dtype}, rows {rows}): max {max_err}, "
                             f"mean {mean_err}")
    return {"max_abs_err": max_err, "mean_abs_err": mean_err}


def attn_inputs(b: int, n: int, d: int, dtype, gen) -> tuple:
    """Random K5/K6 inputs: activations in ``dtype``, f32 parameters
    ([in, out]), cotangents in ``dtype``."""
    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale
    acts = [r(b, n, d).to(dtype) for _ in range(3)] + [r(b, n, n, d).to(dtype)]
    params = [r(d, d, scale=d ** -0.5), r(d, scale=0.1), r(d, d, scale=d ** -0.5),
              r(d, scale=0.1)]
    return acts, params, (r(b, n, n, d).to(dtype), r(b, n, d).to(dtype))


def check_attn_kernels(fa, b: int, n: int, d: int, dtype, gen, twice: bool = False) -> dict:
    """K5 on edge_out, node_agg and t, and K6 on its eight gradients (from
    the kernel's own t), each against its plain version on the same inputs;
    ``twice``: K6 run again must give the same bits."""
    acts, params, (ge, gn) = attn_inputs(b, n, d, dtype, gen)
    got = fa.edge_attention_fwd(*acts, *params, HEADS)
    torch.cuda.synchronize()
    ref = fa.edge_attention_fwd_reference(*acts, *params, HEADS)
    atol, rtol = TOL_ATTN[dtype]
    fwd_err = {}
    for name, g_, r_ in zip(("edge_out", "node_agg", "t"), got, ref):
        if g_.shape != r_.shape or g_.dtype != dtype or not torch.isfinite(g_.float()).all():
            raise AssertionError(f"K5 {name}: {g_.shape} {g_.dtype}, or not finite")
        err = (g_.float() - r_.float()).abs()
        fwd_err[name] = err.max().item()
        if not bool((err <= atol + rtol * r_.float().abs()).all()):
            raise AssertionError(f"K5 {name} disagrees with its plain version "
                                 f"({dtype}, B {b} N {n} D {d}): max {fwd_err[name]}")
    del ref
    t_res = got[2]
    grads = fa.edge_attention_bwd(*acts, *params[:3], t_res, ge, gn, HEADS)
    torch.cuda.synchronize()
    ref = fa.edge_attention_bwd_reference(*acts, *params[:3], t_res, ge, gn, HEADS)
    rels = {name: rel_err(g_.float(), r_.float())
            for name, g_, r_ in zip(ATTN_GRADS, grads, ref)}
    bwd_max = max((g_.float() - r_.float()).abs().max().item()
                  for g_, r_ in zip(grads, ref))
    del ref
    same = None
    if twice:
        again = fa.edge_attention_bwd(*acts, *params[:3], t_res, ge, gn, HEADS)
        same = all(torch.equal(x, y) for x, y in zip(grads, again))
        del again
    print(f"   K5/K6 B {b} N {n} D {d} {str(dtype):>14}: K5 max |kernel - plain| "
          + ", ".join(f"{k} {v:.3e}" for k, v in fwd_err.items())
          + "; K6 rel. errors " + ", ".join(f"{k} {v:.1e}" for k, v in rels.items())
          + ("" if same is None else f"; K6 twice, same bits: {same}"), flush=True)
    tol = TOL_ATTN_GRAD_REL[dtype]
    if max(rels.values()) > tol or not all(torch.isfinite(g_.float()).all() for g_ in grads):
        raise AssertionError(f"K6 disagrees with its plain version ({dtype}, "
                             f"B {b} N {n} D {d}): {rels}")
    if same is False:
        raise AssertionError("K6 gave other bits on a second call")
    return {"max_abs_err": max(fwd_err.values()), "bwd_max_abs_err": bwd_max,
            "grad_rel_err": max(rels.values())}


def attn_bounds(b: int, n: int, d: int, dtype) -> tuple:
    """Least milliseconds for one K5 and one K6 call: each input read once
    and each output written once, against their products (K5: e and out_e;
    K6: five), each priced at the faster route its operand types allow, as
    block_bounds prices K7/K8's: both operands exact in bf16 (K6's t^T ge in
    bf16) at the bf16 rate; an f32 operand times a bf16-exact one (in bf16:
    K5's e = eraw We, K6's e, ge Woe^T and eraw^T de) at 989 / 3 TFLOP/s
    (three bf16 passes); f32 x f32 (K5's t Woe, K6's de We^T, and every
    product in f32) at 3xTF32's 165.  For each kernel ``(bound_ms, bound_by,
    ffma_ms, earlier_ms)``: the bound, its products' time on f32 FMA (the
    CUDA-core route's), and the bound as this script priced it before,
    every product at 3xTF32's rate."""
    item = torch.tensor([], dtype=dtype).element_size()
    rows, nodes = b * n * n, b * n
    w_bytes = (2 * d * d + 2 * d) * 4
    fwd_bytes = (3 * nodes * d + rows * d) * item + w_bytes \
        + (2 * rows * d + nodes * d) * item
    bwd_bytes = (4 * nodes * d + 3 * rows * d) * item + (2 * d * d + d) * 4 \
        + (3 * nodes * d + rows * d) * item + (2 * d * d + 2 * d) * 4
    p = 2 * rows * d * d   # one product
    # (exact in bf16, f32 x bf16-exact, f32 x f32) operations of each kernel
    if dtype == torch.bfloat16:
        k5, k6 = (0, p, p), (p, 3 * p, p)
    else:
        k5, k6 = (0, 0, 2 * p), (0, 0, 5 * p)
    out = []
    for nbytes, (exact, mixed, full) in ((fwd_bytes, k5), (bwd_bytes, k6)):
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = (exact / PEAK_FLOPS_S[torch.bfloat16] + mixed / PEAK_F32_BF16_S
                 + full / PEAK_F32_F32_S) * 1e3
        flops = exact + mixed + full
        earlier = max(t_bytes, flops / PEAK_3XTF32_S * 1e3)
        bound = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        out.append(bound + (flops / PEAK_FFMA_S * 1e3, earlier))
    return tuple(out)


def attn_matmul_products(rows: int, d: int, gen):
    """K5's two and K6's five products through torch.matmul in f32 (TF32
    off) on random operands of the main shape: a reference time for the
    products alone, not a computation of K5 or K6."""
    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    x, y, w1, w2 = r(rows, d), r(rows, d), r(d, d), r(d, d)

    def fwd():
        torch.matmul(x, w1)        # e = eraw We
        torch.matmul(y, w2)        # t Woe

    def bwd():
        torch.matmul(x, w1)        # e
        torch.matmul(y, w2.t())    # ge Woe^T
        torch.matmul(x, w1.t())    # de We^T
        torch.matmul(x.t(), y)     # eraw^T de
        torch.matmul(y.t(), x)     # t^T ge
    return fwd, bwd


def block_inputs(b: int, n: int, d: int, h: int, dtype, gen) -> tuple:
    """Random K7/K8 inputs: activations in ``dtype``, f32 parameters in
    ``fused_block.PARAM_NAMES`` order ([in, out]), cotangents in ``dtype``."""
    def r(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale + shift
    acts = [r(b, n, d).to(dtype) for _ in range(3)] + [r(b, n, n, d).to(dtype)]
    params = [r(d, d, scale=d ** -0.5), r(d, scale=0.1), r(d, d, scale=d ** -0.5),
              r(d, scale=0.1), r(d, scale=0.1, shift=1.0), r(d, scale=0.1),
              r(d, h, scale=d ** -0.5), r(h, scale=0.1), r(h, d, scale=h ** -0.5),
              r(d, scale=0.1), r(d, scale=0.1, shift=1.0), r(d, scale=0.1)]
    return acts, params, (r(b, n, n, d).to(dtype), r(b, n, d).to(dtype))


def check_block_kernels(fb, b: int, n: int, d: int, h: int, dtype, gen,
                        twice: bool = False) -> dict:
    """K7 on y_out and node_agg, and K8 on its 16 gradients (rows of dy
    beyond tolerance witnessed at the ReLU kink), each against its plain
    version on the same inputs; ``twice``: K8 run again must give the same
    bits."""
    acts, params, cots = block_inputs(b, n, d, h, dtype, gen)
    got = fb.fused_block_fwd(*acts, *params, HEADS)
    torch.cuda.synchronize()
    ref = fb.fused_block_fwd_reference(*acts, *params, HEADS)
    atol, rtol = TOL_BLOCK[dtype]
    fwd_err = {}
    for name, g_, r_ in zip(("y_out", "node_agg"), got, ref):
        if g_.shape != r_.shape or g_.dtype != dtype or not torch.isfinite(g_.float()).all():
            raise AssertionError(f"K7 {name}: {g_.shape} {g_.dtype}, or not finite")
        err = (g_.float() - r_.float()).abs()
        fwd_err[name] = err.max().item()
        if not bool((err <= atol + rtol * r_.float().abs()).all()) or (
                dtype == torch.bfloat16 and err.mean().item() > TOL_BF16_MEAN):
            raise AssertionError(f"K7 {name} disagrees with its plain version "
                                 f"({dtype}, B {b} N {n} D {d}): max {fwd_err[name]}, "
                                 f"mean {err.mean().item()}")
    del got, ref
    grads = fb.fused_block_bwd(*acts, *params, *cots, HEADS)
    torch.cuda.synchronize()
    ref = fb.fused_block_bwd_reference(*acts, *params, *cots, HEADS)
    gatol, grtol = TOL_BLOCK_GRAD[dtype]

    def row_ok(a, b_):
        return ((a.float() - b_.float()).abs() <= gatol + grtol * b_.float().abs()).all(-1)

    rows = b * n * n
    bad = torch.nonzero(~row_ok(grads[3].reshape(-1, d), ref[3].reshape(-1, d))).flatten()
    dy_max = (grads[3].float() - ref[3].float()).abs().max().item()
    n_bad, unexplained = len(bad), []
    if n_bad:
        del ref
        relu_set, unexplained = fb.witness_kink_flips(*acts, params, *cots, HEADS,
                                                      grads[3], bad, row_ok)
        ref = fb.fused_block_bwd_reference(*acts, *params, *cots, HEADS, relu_set=relu_set)
    out_err, rels = {}, {}
    still = 0
    for i, (name, g_, r_) in enumerate(zip(fb.GRAD_NAMES, grads, ref)):
        if not torch.isfinite(g_.float()).all():
            raise AssertionError(f"K8 {name} is not finite")
        if i < 4:
            err = (g_.float() - r_.float()).abs()
            out_err[name] = err.max().item()
            still += int((err > gatol + grtol * r_.float().abs()).sum().item())
        else:
            rels[name] = rel_err(g_.float(), r_.float())
    del ref
    same = None
    if twice:
        again = fb.fused_block_bwd(*acts, *params, *cots, HEADS)
        same = all(torch.equal(x, y) for x, y in zip(grads, again))
        del again
    print(f"   K7/K8 B {b} N {n} D {d} H {h} {str(dtype):>14}: K7 max |kernel - plain| "
          + ", ".join(f"{k} {v:.3e}" for k, v in fwd_err.items())
          + f"; K8 dy max {dy_max:.3e}, rows beyond tolerance {n_bad} of {rows:,}, "
          f"witnessed at the kink {n_bad - len(unexplained)}; with the witnessed "
          f"settings max " + ", ".join(f"{k} {v:.3e}" for k, v in out_err.items())
          + "; rel. errors " + ", ".join(f"{k} {v:.1e}" for k, v in rels.items())
          + ("" if same is None else f"; K8 twice, same bits: {same}"), flush=True)
    if (len(unexplained) or still or n_bad > max(1, int(MAX_FLIP_ROW_SHARE * rows))
            or max(rels.values()) > TOL_BLOCK_PARAM_REL[dtype]):
        raise AssertionError(f"K8 disagrees with its plain version ({dtype}, B {b} N {n} "
                             f"D {d}): {n_bad} dy rows beyond tolerance, unexplained "
                             f"{list(unexplained[:10])}; {still} elements beyond with the "
                             f"witnessed settings; parameter gradients {rels}")
    if same is False:
        raise AssertionError("K8 gave other bits on a second call")
    return {"max_abs_err": max(fwd_err.values()), "bwd_max_abs_err": max(out_err.values()),
            "grad_rel_err": max(rels.values()), "flip_rows": n_bad}


def block_bounds(b: int, n: int, d: int, h: int, dtype) -> tuple:
    """Least milliseconds for one K7 and one K8 call: each input read once
    and each output written once, against their products, each priced at
    the faster route its operand types allow: both operands exact in bf16
    (in bf16: K7's e, fc1 and fc2, K8's e recompute) at the bf16 rate; an
    f32 operand times a bf16-exact one (in bf16: K7's t Woe, K8's y1, hpre,
    m, dh, du, dt, dy and dWe) at 989 / 3 TFLOP/s (three bf16 passes); f32 x
    f32 (K8's dWoe, dW1, dW2, and every product in f32) at 3xTF32's 165.
    For each kernel ``(bound_ms, bound_by, ffma_ms, earlier_ms)``: the bound,
    the operations' time of its f32-accurate products on f32 FMA (the
    CUDA-core route's), and the bound as this script priced it before, every
    product not exact in bf16 at 3xTF32's rate."""
    item = torch.tensor([], dtype=dtype).element_size()
    rows, nodes = b * n * n, b * n
    w_bytes = (2 * d * d + 2 * d * h) * item + (7 * d + h) * 4
    grad_bytes = (2 * d * d + 2 * d * h + 7 * d + h) * 4
    fwd_bytes = (3 * nodes * d + rows * d) * item + w_bytes + (rows * d + nodes * d) * item
    bwd_bytes = ((4 * nodes * d + 2 * rows * d) * item + w_bytes
                 + (3 * nodes * d + rows * d) * item + grad_bytes)
    bf16 = dtype == torch.bfloat16
    # (exact in bf16, f32 x bf16-exact, f32 x f32) operations of each kernel
    if bf16:
        k7 = (2 * rows * (d * d + 2 * d * h), 2 * rows * d * d, 0)
        k8 = (2 * rows * d * d, 2 * rows * (4 * d * d + 4 * d * h),
              2 * rows * (d * d + 2 * d * h))
    else:
        k7 = (0, 0, 2 * rows * (2 * d * d + 2 * d * h))
        k8 = (0, 0, 2 * rows * (6 * d * d + 6 * d * h))
    out = []
    for nbytes, (exact, mixed, full), ffma_ops in (
            (fwd_bytes, k7, 2 * rows * 2 * d * d), (bwd_bytes, k8, sum(k8[1:]))):
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = (exact / PEAK_FLOPS_S[torch.bfloat16] + mixed / PEAK_F32_BF16_S
                 + full / PEAK_F32_F32_S) * 1e3
        earlier = max(t_bytes, (exact / PEAK_FLOPS_S[torch.bfloat16]
                                + (mixed + full) / PEAK_3XTF32_S) * 1e3)
        bound = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        out.append(bound + (ffma_ops / PEAK_FFMA_S * 1e3, earlier))
    return tuple(out)


def symmetric_onehots(b: int, n: int, m_dim: int, b_dim: int, gen) -> tuple:
    """Random vertex-symmetric one-hot adjacencies and one-hot atoms (f32)."""
    lab = torch.randint(0, b_dim, (b, n, n), generator=gen, device="cuda").triu(1)
    z_e = F.one_hot(lab + lab.transpose(1, 2), b_dim).float()
    z_n = F.one_hot(torch.randint(0, m_dim, (b, n), generator=gen, device="cuda"), m_dim).float()
    return z_e, z_n


def check_generator_kernel(fg, gw, z_e, z_n, dtype, label: str, labels_held: bool) -> dict:
    """K9 against its plain version on the same inputs (see TOL_K9)."""
    z_e, z_n = z_e.to(dtype), z_n.to(dtype)
    got = fg.fused_generator_logits(gw, z_e, z_n, heads=HEADS)
    torch.cuda.synchronize()
    ref = fg.fused_generator_logits_reference(gw.weights, gw.depth, z_e, z_n, heads=HEADS)
    atol, rtol = TOL_K9[dtype]
    max_err = mean_err = 0.0
    same = total = ties = 0
    ok = True
    for g_, r_ in zip(got, ref):
        if g_.shape != r_.shape or g_.dtype != dtype or not torch.isfinite(g_.float()).all():
            raise AssertionError(f"K9 logits {g_.shape} {g_.dtype}, or not finite ({label})")
        g_, r_ = g_.float(), r_.float()
        err = (g_ - r_).abs()
        bound = atol + rtol * r_.abs()
        ok &= bool((err <= bound).all())
        max_err = max(max_err, err.max().item())
        mean_err = max(mean_err, err.mean().item())
        lab_g, lab_r = g_.argmax(-1, keepdim=True), r_.argmax(-1, keepdim=True)
        margin = r_.gather(-1, lab_r) - r_.gather(-1, lab_g)
        differ = lab_g != lab_r
        same += int((~differ).sum().item())
        total += lab_g.numel()
        ties += int((differ & (margin <= 2 * bound.gather(-1, lab_r))).sum().item())
    agree = same / total
    b, n = z_e.shape[:2]
    print(f"   K9 {label} B {b} N {n} dim {gw.dim} H {gw.hidden} depth {gw.depth} "
          f"{str(dtype):>14}: logits max |kernel - plain| {max_err:.3e}, mean {mean_err:.3e}; "
          f"labels equal {agree:.6f} ({total - same} of {total} differ, {ties} of them "
          f"near ties)", flush=True)
    if dtype == torch.bfloat16:
        ok &= mean_err <= TOL_BF16_MEAN
    ok &= agree >= MIN_LABEL_AGREEMENT if labels_held else ties == total - same
    if not ok:
        raise AssertionError(f"K9 disagrees with its plain version ({label}, {dtype}): max "
                             f"{max_err}, mean {mean_err}, labels {agree}, near ties {ties}")
    return {"max_abs_err": max_err, "mean_abs_err": mean_err, "label_agreement": agree}


def generator_bound(b: int, n: int, gw, dtype) -> tuple[float, str]:
    """Least milliseconds for one K9 call: the one-hots read once, the
    logits written once and the weights read once, against its products
    (per edge row the input MLP, e, out_e and MLP2 of each depth, and the
    readout; per atom the input MLP, q, k, v, out_n and the MLP of each
    depth, and the readout), bf16 at the bf16 rate, f32 at full f32
    accuracy on the faster route (3xTF32)."""
    item = torch.tensor([], dtype=dtype).element_size()
    c, h, m_dim, b_dim, depth = gw.dim, gw.hidden, gw.m_dim, gw.b_dim, gw.depth
    edge = 2 * b * n * n * (b_dim * 64 + 64 * c + depth * (2 * c * c + 2 * c * h) + c * b_dim)
    node = 2 * b * n * (m_dim * 64 + 64 * c + depth * (4 * c * c + 2 * c * h) + c * m_dim)
    nbytes = 2 * (b * n * n * b_dim + b * n * m_dim) * item + sum(
        w.numel() for w in gw.weights) * item
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    rate = PEAK_FLOPS_S[torch.bfloat16] if dtype == torch.bfloat16 else PEAK_3XTF32_S
    t_ops = (edge + node) / rate * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def generator_launch_bounds(b: int, n: int, gw) -> dict:
    """Least milliseconds of each kind of K9's Hopper-route launches, summed
    over the depths, bf16 (the rule of generator_bound, launch by launch):
    the edge attention reads z_e (depth 0) or the rows, and q, k, v, and
    writes s and agg, against its input MLP (depth 0), e and out_e; the
    edge tail reads s and writes the rows or the logits, against MLP2 and
    the readout; the node passes read z_n and write the node logits (their
    [B, N, C] traffic is L2-sized and left out), against the node stream's
    products."""
    c, h, m_dim, b_dim, depth = gw.dim, gw.hidden, gw.m_dim, gw.b_dim, gw.depth
    rows, atoms = b * n * n, b * n
    rate = PEAK_FLOPS_S[torch.bfloat16]
    parts = {
        "node": (2 * atoms * (m_dim * 64 + 64 * c + depth * (4 * c * c + 2 * c * h) + c * m_dim),
                 2 * atoms * 2 * m_dim),
        "attention": (2 * rows * (b_dim * 64 + 64 * c + depth * 2 * c * c),
                      2 * (rows * b_dim + (2 * depth - 1) * rows * c + depth * 4 * atoms * c)),
        "tail": (2 * rows * (depth * 2 * c * h + c * b_dim),
                 2 * ((2 * depth - 1) * rows * c + rows * b_dim)),
    }
    out = {}
    for key, (ops, nbytes) in parts.items():
        t_ops, t_bytes = ops / rate * 1e3, nbytes / PEAK_BYTES_S * 1e3
        out[key] = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return out


def check_generator_launches(fg, gw, z_e, z_n, label: str) -> dict:
    """K9's Hopper route launch by launch, each against its plain stage on
    the kernel's own inputs (TOL_K9, bf16); then the whole forward twice for
    the same bits, equal to the launch-by-launch run.  Returns the largest
    error of each kind of launch."""
    dt = torch.bfloat16
    z_e, z_n = z_e.to(dt), z_n.to(dt)
    b, n = z_e.shape[:2]
    if not fg.hopper_route(n, gw.dim, gw.hidden, dt, gw.b_dim):
        raise AssertionError(f"K9 {label}: N {n}, dim {gw.dim}, hidden {gw.hidden} is not on "
                             f"the Hopper route")
    atol, rtol = TOL_K9[dt]
    errs = {key: 0.0 for key in K9_LAUNCHES}

    def held(what, got, ref):
        torch.cuda.synchronize()
        got, ref = got.float(), ref.float()
        err = (got - ref).abs()
        ok = bool(torch.isfinite(got).all()) and bool((err <= atol + rtol * ref.abs()).all())
        if not ok or err.mean().item() > TOL_BF16_MEAN:
            raise AssertionError(f"K9 {label}, {what}: max |kernel - stage| "
                                 f"{err.max().item()}, mean {err.mean().item()}")
        key = next(k for k in K9_LAUNCHES if what.startswith(k))
        errs[key] = max(errs[key], err.max().item())

    out_n, out_e = fg.route_by_launch(gw, z_e, z_n, held, heads=HEADS)
    got = fg.fused_generator_logits(gw, z_e, z_n, heads=HEADS)
    again = fg.fused_generator_logits(gw, z_e, z_n, heads=HEADS)
    torch.cuda.synchronize()
    if not all(torch.equal(g_, a_) and torch.equal(g_, l_)
               for g_, a_, l_ in zip(got, again, (out_n, out_e))):
        raise AssertionError(f"K9 {label}: the forward twice, or launch by launch, gave "
                             f"other bits")
    print(f"   K9 {label} B {b} N {n} depth {gw.depth}, Hopper route by launch against the "
          f"plain stages: max |kernel - stage| " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items()) + "; the forward twice and launch by "
          f"launch the same bits", flush=True)
    return errs


def check_v2_kernels(fa, b: int, n: int, d: int, dtype, gen, twice: bool = False) -> dict:
    """K3 on edge_pre and node_agg and K4 on dq, dk, dv, de, each against its
    plain version on the same inputs (TOL_ATTN); ``twice``: K3 and K4 run
    again must give the same bits."""
    acts, _, (ge, gn) = attn_inputs(b, n, d, dtype, gen)
    atol, rtol = TOL_ATTN[dtype]
    errs = {}
    for kernel, plain, names, args in (
            (fa.edge_attention_v2_fwd, fa.edge_attention_v2_fwd_reference,
             ("edge_pre", "node_agg"), (*acts, HEADS)),
            (fa.edge_attention_v2_bwd, fa.edge_attention_v2_bwd_reference,
             ("dq", "dk", "dv", "de"), (*acts, ge, gn, HEADS))):
        got = kernel(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        for name, g_, r_ in zip(names, got, ref):
            if g_.shape != r_.shape or g_.dtype != dtype or not torch.isfinite(g_.float()).all():
                raise AssertionError(f"{name}: {g_.shape} {g_.dtype}, or not finite")
            err = (g_.float() - r_.float()).abs()
            errs[name] = err.max().item()
            if not bool((err <= atol + rtol * r_.float().abs()).all()):
                raise AssertionError(f"K3/K4 {name} disagrees with its plain version "
                                     f"({dtype}, B {b} N {n} D {d}): max {errs[name]}")
        del ref
    same = None
    if twice:
        same = {}
        for label, call in (("K3", lambda: fa.edge_attention_v2_fwd(*acts, HEADS)),
                            ("K4", lambda: fa.edge_attention_v2_bwd(*acts, ge, gn, HEADS))):
            first, again = call(), call()
            same[label] = all(torch.equal(x, y) for x, y in zip(first, again))
    print(f"   K3/K4 B {b} N {n} D {d} {str(dtype):>14}: max |kernel - plain| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + ("" if same is None else f"; twice, same bits: {same}"), flush=True)
    if same is not None and not all(same.values()):
        raise AssertionError(f"K3/K4 gave other bits on a second call: {same}")
    return {"max_abs_err": max(errs["edge_pre"], errs["node_agg"]),
            "bwd_max_abs_err": max(errs[k] for k in ("dq", "dk", "dv", "de"))}


def v2_bytes(b: int, n: int, d: int, dtype) -> tuple:
    """Bytes one K3 and one K4 call must move: each input read once and each
    output written once (K3: q, k, v, e in, edge_pre, node out; K4: q, k, v,
    e, ge, gn in, dq, dk, dv, de out)."""
    item = torch.tensor([], dtype=dtype).element_size()
    rows, nodes = b * n * n, b * n
    return ((3 * nodes + rows) * d * item + (rows + nodes) * d * item,
            (4 * nodes + 2 * rows) * d * item + (3 * nodes + rows) * d * item)


def v2_bounds(b: int, n: int, d: int, dtype) -> tuple:
    """Least milliseconds for one K3 and one K4 call: their bytes (v2_bytes)
    at the card's memory rate against their f32 operations (V2_OPS an edge
    row and channel) at the f32 FMA rate."""
    rows = b * n * n
    out = []
    for nbytes, ops in zip(v2_bytes(b, n, d, dtype), (V2_OPS[0] * rows * d,
                                                      V2_OPS[1] * rows * d)):
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = ops / PEAK_FFMA_S * 1e3
        out.append((t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes"))
    return tuple(out)


def device_launches(fn, patterns: dict) -> dict:
    """Device launches of one call of ``fn`` (torch.profiler): those of the
    kernels named like each pattern, and ``"all"`` of them (copies and fills
    included)."""
    events = device_events(fn)
    out = {label: sum(e.count for e in events if pat in e.key)
           for label, pat in patterns.items()}
    out["all"] = sum(e.count for e in events)
    return out


def profile_forward(fn, label: str, name: str, smi_line: str, required=()) -> dict:
    """One call of ``fn`` (a serving forward) under torch.profiler: its
    CUDA-event time, device time by kernel, the card's idle share and the
    call's peak device memory.  A profile with no device time, or with no
    kernel named by one of the ``required`` patterns, lost (part of) its
    trace (seen on an H100: a K9 forward's profile held only its last two
    kernels), so it is taken again, up to three profiles."""
    fwd_ms = cuda_ms(fn, 5)
    for attempt in range(3):
        torch.cuda.reset_peak_memory_stats()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0]
        if kernels and all(any(pat in k[0] for k in kernels) for pat in required):
            break
        print(f"   (profile {attempt + 1} of the forward held no device time or missed a "
              f"kernel of {list(required)}; profiling again)")
    busy = sum(k[1] for k in kernels)
    print(f"   serving forward, batch {SERVE_BATCH}, {label}, on {name} ({smi_line}): "
          f"{fwd_ms:.3f} ms (CUDA events); kernels {busy:.3f} ms; idle share "
          f"{max(0.0, 1 - busy / fwd_ms):.3f}; peak memory {peak:.3f} GiB")
    for key, ms, count in sorted(kernels, key=lambda k: -k[1])[:10]:
        print(f"   {ms:8.3f} ms {100 * ms / busy:5.1f}% x{count:<3d} {key[:90]}")
    if not kernels:
        print("   the profiler recorded no device time")
    return {"forward_ms": fwd_ms, "busy_ms": busy, "peak_gib": peak, "kernels": kernels}


def snapshot(opts) -> list:
    """Parameters and optimizer state of each optimizer (copies)."""
    return [(o.flat.clone(), dataclasses.replace(
        o.state, **{f.name: getattr(o.state, f.name).clone()
                    for f in dataclasses.fields(o.state)})) for o in opts]


def restore(opts, snap) -> None:
    for o, (flat, st) in zip(opts, snap):
        o.flat.copy_(flat)
        o.state = dataclasses.replace(
            st, **{f.name: getattr(st, f.name).clone()
                   for f in dataclasses.fields(st)})


def training_phases(name: str, smi_line: str, counted: dict, keep_dir: str) -> dict:
    """Phases 8-10: the port's Trainer at the full r2_scale config, as
    published, with ``use_pallas`` and with ``fused_block``; one step through
    the kernels against one through the plain versions; one step of each
    under the profiler.  ``counted``: the kernel wrappers by record name
    (each with its ``launches`` count).  The published run's cadence G
    exports are copied into ``<keep_dir>/models`` (phase 12 ranks them)."""
    from druggen_tpu_torch.chem.vocab import Vocab
    from druggen_tpu_torch.config import InferenceConfig, TrainConfig
    from druggen_tpu_torch.data.dataset import BatchIterator
    from druggen_tpu_torch.infer.engine import InferenceEngine
    from druggen_tpu_torch.interop.msgpack_ckpt import msgpack_restore
    from druggen_tpu_torch.models import Discriminator, Generator, layers
    from druggen_tpu_torch.models.layers import numerics
    from druggen_tpu_torch.ops import fused_mlp as fm
    from druggen_tpu_torch.train.losses import gradient_penalty, gradient_penalty_fwdrev
    from druggen_tpu_torch.train.optim import AdamW, make_optimizers
    from druggen_tpu_torch.train.step import TrainStep
    from druggen_tpu_torch.train.trainer import Trainer

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    raw = os.path.join(tmp.name, f"chembl_like_{TRAIN_MOLECULES}.smi")
    with open(SMILES_FILE) as src, open(raw, "w") as dst:
        for _, line in zip(range(TRAIN_MOLECULES), src):
            dst.write(line)
    with open(TRAIN_VOCAB_JSON) as f:
        vocab = Vocab.from_json(f.read())

    def train_run(mode: str, gp_mode: str = "revrev"):
        """One epoch (16 steps) of the trainer as published (``mode``
        "published"), with ``use_pallas`` ("pallas") or with ``fused_block``
        ("block"), with the penalty ``gp_mode``; checks launches, losses,
        moved parameters and the exported checkpoint served back."""
        # experiments/r2_scale/README.md "Config": batch 512, bf16,
        # --fused_mlp --fused_critic, seed 42; dim 128, depth 1, heads 8
        use_pallas, block = mode == "pallas", mode == "block"
        fwdrev = gp_mode == "fwdrev"
        sub = os.path.join(tmp.name, mode + ("_fwdrev" if fwdrev else ""))
        cfg = TrainConfig(
            raw_file=raw, drug_raw_file=DRUG_FILE, submodel="DrugGEN",
            batch_size=TRAIN_BATCH, epoch=1, compute_dtype="bfloat16",
            fused_mlp=True, fused_critic=True, use_pallas=use_pallas,
            fused_block=block, gp_mode=gp_mode,
            log_sample_step=TRAIN_CADENCE,
            set_seed=True, seed=42, exp_name="chip_smoke",
            mol_data_dir=tmp.name, drug_data_dir=tmp.name,
            log_dir=os.path.join(sub, "logs"),
            sample_dir=os.path.join(sub, "samples"),
            model_save_dir=os.path.join(sub, "models"), device="cuda")
        t0 = time.perf_counter()
        trainer = Trainer(cfg, vocab=vocab)
        print(f"   trainer set-up (featurise {len(trainer.data)} + "
              f"{len(trainer.drug_data)} molecules, drug fingerprints, models): "
              f"{time.perf_counter() - t0:.2f} s; m_dim {trainer.m_dim}, "
              f"b_dim {trainer.b_dim}, N {trainer.vertexes}")
        opts = (trainer.g_opt, trainer.d_opt)
        before = [o.flat.clone() for o in opts]
        torch.cuda.reset_peak_memory_stats()
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        trainer.train(time_steps=True)
        wall = time.perf_counter() - t0
        launches = {key: fn.launches for key, fn in counted.items()}
        steps = trainer.step
        # the critic's first-order passes a step: real, fake and the G
        # step's; under fwdrev also the penalty's inner input-gradient pass
        passes = 4 if fwdrev else 3
        tail = 0 if block else cfg.depth + passes * (cfg.ddepth - 1)
        # one Generator forward a step (share_fake: its graph is kept for
        # the G update) and one backward; the cadence reads that step's
        # logits and runs no forward of its own
        attn = cfg.depth if use_pallas else 0
        # --fused_block: the megablock in each G block and in each critic
        # block of the first-order passes, the last block's included (its
        # node output is needed); each is differentiated once
        mega = cfg.depth + passes * cfg.ddepth if block else 0
        expected = {"fused_ln_mlp_ln_fwd": tail * steps, "fused_ln_mlp_ln_bwd": tail * steps,
                    "edge_attention_fwd": attn * steps, "edge_attention_bwd": attn * steps,
                    "fused_block_fwd": mega * steps, "fused_block_bwd": mega * steps}
        print(f"   launches: {launches} over {steps} steps (expected {expected}: "
              f"K1/K2 G depth + {passes} x (critic depth - 1), the critic's last-block "
              f"edge tail skipped; K5/K6 G depth with use_pallas; with --fused_block "
              f"K7/K8 G depth + {passes} x critic depth and no K1/K2)")
        if steps != TRAIN_MOLECULES // TRAIN_BATCH:
            raise AssertionError(f"{steps} steps, expected one epoch")
        if launches != expected:
            raise AssertionError("the training run did not go through the kernels "
                                 "the expected number of times")
        logs = [json.loads(line) for line in open(trainer.logger.jsonl_path)]
        losses = [(r["d_loss"], r["g_loss"]) for r in logs if "d_loss" in r]
        if len(losses) != steps or not all(math.isfinite(v) for pair in losses
                                           for v in pair):
            raise AssertionError(f"losses not finite or missing: {losses}")
        moved = [(o.flat - b).abs().max().item() for o, b in zip(opts, before)]
        if not all(m > 0 for m in moved):
            raise AssertionError(f"parameters did not move: {moved}")
        skipped = [int(o.state.total_notfinite) for o in opts]
        print(f"   d_loss {losses[0][0]:.4f} -> {losses[-1][0]:.4f}, g_loss "
              f"{losses[0][1]:.4f} -> {losses[-1][1]:.4f}; max |param change| "
              f"G {moved[0]:.3e}, D {moved[1]:.3e}; guard-skipped steps G/D "
              f"{skipped}; numerics tier {trainer._numerics_tier}")
        chem = [r for r in logs if "Validity" in r]
        print(f"   cadence metrics at steps {[r['step'] for r in chem]}: "
              f"validity {[round(r['Validity'], 3) for r in chem]}")
        windows = trainer.step_seconds
        steady = statistics.median(windows[2:])
        peak = torch.cuda.max_memory_allocated()
        print(f"   step windows (s): {[round(w, 4) for w in windows]}")
        label = ({"published": "", "pallas": " with use_pallas",
                  "block": " with --fused_block"}[mode]
                 + (" --gp_mode fwdrev" if fwdrev else ""))
        print(f"   training{label} on {name} "
              f"({smi_line}): steady step {steady * 1e3:.2f} "
              f"ms (median window of steps 3-{steps}); training rate "
              f"{TRAIN_BATCH / steady:.1f} graphs/s; peak memory "
              f"{peak / 2**30:.2f} GiB (max_memory_allocated); run wall "
              f"{wall:.2f} s with cadence work", flush=True)

        # the exported generator serves: train -> serve round trip
        inf = InferenceConfig(
            submodel="DrugGEN", inference_model=trainer.model_dir,
            sample_num=TRAIN_BATCH, disable_correction=True, inf_smiles=raw,
            train_smiles=raw, train_drug_smiles=DRUG_FILE,
            inf_batch_size=TRAIN_BATCH, inf_max_batches=1,
            mol_data_dir=tmp.name, output_dir=os.path.join(sub, "inf"),
            compute_dtype="bfloat16", fused_mlp=True, device="cuda")
        engine = InferenceEngine(inf, vocab=vocab)
        trained = trainer.G.state_dict()
        same = all(torch.equal(v.cpu(), trained[k].cpu())
                   for k, v in engine.G.state_dict().items())
        kept, decoded, _, _ = engine.sample(max_batches=1)
        print(f"   DrugGEN-G.ckpt -> InferenceEngine: weights bit-equal "
              f"{same}; one batch of {len(decoded)} graphs served, "
              f"{len(kept)} valid")
        if not same or len(decoded) != TRAIN_BATCH:
            raise AssertionError("the trained checkpoint did not serve")
        del engine
        return trainer, cfg, launches, {"step_ms": steady * 1e3,
                                        "graphs_per_s": TRAIN_BATCH / steady,
                                        "peak_gib": peak / 2 ** 30}

    def resume_run(full, cfg):
        """Phase 8r: a second Trainer with ``resume=True`` on a directory that
        holds the published run's ``state_8`` only runs steps 9-16 and must
        end where the uninterrupted run ended: the same checkpoint names, the
        same step, and the same parameters and Adam moments (bit-equality
        printed; the 8 resumed steps' updates and the moments held to
        TOL_STEP by relative norm error)."""
        names = sorted(os.listdir(full.model_dir))
        states = [n for n in names if n.startswith("state_")]
        print(f"   the published run wrote {names}")
        if set(states) != {f"state_{TRAIN_CADENCE}.msgpack", f"state_{2 * TRAIN_CADENCE}.msgpack"}:
            raise AssertionError(f"the published run wrote the state files {states}")
        sub = os.path.join(tmp.name, "resumed")
        rcfg = dataclasses.replace(
            cfg, resume=True, log_dir=os.path.join(sub, "logs"),
            sample_dir=os.path.join(sub, "samples"),
            model_save_dir=os.path.join(sub, "models"))
        model_dir = os.path.join(rcfg.model_save_dir, rcfg.run_name)
        os.makedirs(model_dir)
        shutil.copy(os.path.join(full.model_dir, f"state_{TRAIN_CADENCE}.msgpack"), model_dir)
        resumed = Trainer(rcfg, vocab=vocab)
        if resumed.step != TRAIN_CADENCE:
            raise AssertionError(f"resumed at step {resumed.step}, not {TRAIN_CADENCE}")
        start = {"g": resumed.g_opt.flat.clone(), "d": resumed.d_opt.flat.clone()}
        for fn in counted.values():
            fn.launches = 0
        ran = []
        step_fn = resumed.step_fn
        resumed.step_fn = lambda *args: ran.append(resumed.step) or step_fn(*args)
        t0 = time.perf_counter()
        resumed.train()
        wall = time.perf_counter() - t0
        launches = {key: fn.launches for key, fn in counted.items()}
        tail = cfg.depth + 3 * (cfg.ddepth - 1)
        expect = dict.fromkeys(launches, 0)
        expect.update(fused_ln_mlp_ln_fwd=tail * len(ran), fused_ln_mlp_ln_bwd=tail * len(ran))
        print(f"   resumed at step {TRAIN_CADENCE}: ran steps {[i + 1 for i in ran]} in "
              f"{wall:.2f} s; launches {launches} (expected {expect})")
        if ran != list(range(TRAIN_CADENCE, 2 * TRAIN_CADENCE)) or resumed.step != full.step:
            raise AssertionError("the resumed run did not run exactly the remaining steps")
        if launches != expect:
            raise AssertionError("the resumed run did not go through K1/K2 as the run does")
        written = sorted(os.listdir(model_dir))
        print(f"   the resumed run's directory: {written}")
        if not set(written) <= set(names) or f"state_{2 * TRAIN_CADENCE}.msgpack" not in written:
            raise AssertionError("the resumed run wrote other checkpoint names")
        errs, equal = {}, True
        for key, (r_opt, f_opt) in {"g": (resumed.g_opt, full.g_opt),
                                    "d": (resumed.d_opt, full.d_opt)}.items():
            pairs = {"update": (r_opt.flat - start[key], f_opt.flat - start[key]),
                     "mu": (r_opt.state.mu, f_opt.state.mu),
                     "nu": (r_opt.state.nu, f_opt.state.nu)}
            for what, (got, want) in pairs.items():
                equal &= torch.equal(got, want)
                errs[f"{key}_{what}"] = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
            equal &= torch.equal(r_opt.flat, f_opt.flat)
            equal &= int(r_opt.state.count) == int(f_opt.state.count)
            errs[f"{key}_param_max_abs"] = (r_opt.flat - f_opt.flat).abs().max().item()
        print(f"   resumed vs uninterrupted at step {resumed.step}: bit-equal {equal}; "
              f"relative norm errors and largest |param difference| {errs}; numerics "
              f"tiers {resumed._numerics_tier} / {full._numerics_tier}", flush=True)
        tol = TOL_STEP[torch.bfloat16]
        bad = {k: v for k, v in errs.items() if not k.endswith("max_abs") and not v <= tol}
        if bad:
            raise AssertionError(f"the resumed run ends away from the uninterrupted one: {bad}")
        return {"bit_equal": bool(equal), "errors": errs, "launches": launches}

    def first_steps(work, n: int):
        """The work items of the first ``n`` steps."""
        done = 0
        for item in work:
            if done >= n:
                return
            done += item[2]
            yield item

    def option_runs(full, cfg) -> dict:
        """Phase 8o: short runs (OPTION_STEPS steps, the cadence out of
        reach) of the trainer with the JAX trainer's other single-device
        options, from the published run's start: ``--split_step`` and
        ``--steps_per_dispatch 4`` (each logged loss held to phase 8's on
        the same step within TOL_STEP), ``--scan_layers`` (its stacked
        export served back) and ``--features`` (dense node blocks of m_dim +
        54, featurised on the Python path as in JAX, on the first
        OPTION_FEATURE_MOLECULES molecules and drugs).  K1/K2 launches: G
        depth a step."""
        want_losses = {r["step"]: (r["d_loss"], r["g_loss"])
                       for r in map(json.loads, open(full.logger.jsonl_path)) if "d_loss" in r}
        small = {}
        for key, path in (("raw", SMILES_FILE), ("drugs", DRUG_FILE)):
            small[key] = os.path.join(tmp.name, f"{key}_{OPTION_FEATURE_MOLECULES}.smi")
            with open(path) as src, open(small[key], "w") as dst:
                for _, line in zip(range(OPTION_FEATURE_MOLECULES), src):
                    dst.write(line)
        results = {}
        for label, extra in (("split_step", {"split_step": True}),
                             ("steps_per_dispatch 4", {"steps_per_dispatch": 4}),
                             ("scan_layers", {"scan_layers": True}),
                             ("features", {"features": True,
                                           "raw_file": small["raw"],
                                           "drug_raw_file": small["drugs"]})):
            sub = os.path.join(tmp.name, "option_" + label.replace(" ", "_"))
            ocfg = dataclasses.replace(
                cfg, log_sample_step=10 ** 6, log_dir=os.path.join(sub, "logs"),
                sample_dir=os.path.join(sub, "samples"),
                model_save_dir=os.path.join(sub, "models"), **extra)
            t0 = time.perf_counter()
            tr = Trainer(ocfg, vocab=vocab)
            setup = time.perf_counter() - t0
            items = tr._work_items
            tr._work_items = lambda *a, _items=items, **k: first_steps(_items(*a, **k),
                                                                       OPTION_STEPS)
            for fn in counted.values():
                fn.launches = 0
            t0 = time.perf_counter()
            tr.train(time_steps=True)
            wall = time.perf_counter() - t0
            launches = {key: fn.launches for key, fn in counted.items()}
            expect = dict.fromkeys(launches, 0)
            # the split step runs G forward twice a step (no shared fake)
            forwards = 2 if ocfg.split_step else 1
            expect.update(fused_ln_mlp_ln_fwd=forwards * ocfg.depth * tr.step,
                          fused_ln_mlp_ln_bwd=ocfg.depth * tr.step)
            got = {r["step"]: (r["d_loss"], r["g_loss"])
                   for r in map(json.loads, open(tr.logger.jsonl_path)) if "d_loss" in r}
            windows = tr.step_seconds
            print(f"   --{label}: {tr.step} steps in {wall:.2f} s after a {setup:.2f} s "
                  f"set-up; step windows (s) {[round(w, 4) for w in windows]}; m_dim "
                  f"{tr.m_dim}; launches {launches}; logged losses {got}", flush=True)
            if tr.step != OPTION_STEPS or launches != expect:
                raise AssertionError(f"--{label}: {tr.step} steps, launches {launches} "
                                     f"(expected {OPTION_STEPS} steps, {expect})")
            if not got or not all(math.isfinite(v) for pair in got.values() for v in pair):
                raise AssertionError(f"--{label}: losses not finite or missing: {got}")
            errs = None
            if label in ("split_step", "steps_per_dispatch 4"):
                # the same steps as phase 8's first OPTION_STEPS
                errs = {st: max(abs(g - w) / max(1.0, abs(w))
                                for g, w in zip(pair, want_losses[st]))
                        for st, pair in got.items()}
                logged = list(range(1, OPTION_STEPS + 1)) if label == "split_step" \
                    else [OPTION_STEPS]
                print(f"   --{label}: losses against phase 8's on the same steps, "
                      f"relative error by step {errs}", flush=True)
                if sorted(got) != logged or max(errs.values()) > TOL_STEP[torch.bfloat16]:
                    raise AssertionError(f"--{label}: losses away from phase 8's: {errs}")
            elif label == "scan_layers":
                files = sorted(os.listdir(tr.model_dir))
                export = os.path.join(tr.model_dir, "DrugGEN-G.ckpt")
                with open(export, "rb") as f:
                    encoder = msgpack_restore(f.read())["params"]["trunk"]["encoder"]
                with open(os.path.join(tr.model_dir, f"state_{OPTION_STEPS}.msgpack"),
                          "rb") as f:
                    st_encoder = msgpack_restore(f.read())["g_params"]["params"]["trunk"]["encoder"]
                inf = InferenceConfig(
                    submodel="DrugGEN", inference_model=tr.model_dir,
                    sample_num=TRAIN_BATCH, disable_correction=True, inf_smiles=raw,
                    train_smiles=raw, train_drug_smiles=DRUG_FILE,
                    inf_batch_size=TRAIN_BATCH, inf_max_batches=1, mol_data_dir=tmp.name,
                    output_dir=os.path.join(sub, "inf"), compute_dtype="bfloat16",
                    fused_mlp=True, device="cuda")
                engine = InferenceEngine(inf, vocab=vocab)
                trained = tr.G.state_dict()
                same = all(torch.equal(v.cpu(), trained[k].cpu())
                           for k, v in engine.G.state_dict().items())
                _, decoded, _, _ = engine.sample(max_batches=1)
                print(f"   --scan_layers wrote {files}; the export's encoder keys "
                      f"{sorted(encoder)}, the state's {sorted(st_encoder)}; served by "
                      f"InferenceEngine: weights bit-equal {same}, {len(decoded)} graphs",
                      flush=True)
                if set(encoder) != {"blocks"} or set(st_encoder) != {"blocks"} \
                        or not same or len(decoded) != TRAIN_BATCH:
                    raise AssertionError("the stacked --scan_layers export did not serve")
                del engine
            elif tr.m_dim != vocab.m_dim + 54 or tr.data.f is None:
                raise AssertionError(f"--features: m_dim {tr.m_dim}, feature block "
                                     f"{tr.data.feature_dim}")
            results[label] = {"wall_s": wall, "setup_s": setup, "launches": launches,
                              "loss_errors": errs}
            del tr
        return results

    with phase("8 training"):
        trainer, cfg, launches, _ = train_run("published")
        os.makedirs(os.path.join(keep_dir, "models"))
        for export in (f"1-{TRAIN_CADENCE}-G.ckpt", f"1-{2 * TRAIN_CADENCE}-G.ckpt"):
            shutil.copy(os.path.join(trainer.model_dir, export),
                        os.path.join(keep_dir, "models", export))
    with phase("8r training resumed from state_8"):
        resumed = resume_run(trainer, cfg)
    with phase("8p training --use_pallas"):
        trainer_p, _, launches_p, rate_p = train_run("pallas")
    with phase("8b training --fused_block"):
        trainer_b, _, launches_b, rate_b = train_run("block")
    with phase("8f training --gp_mode fwdrev"):
        trainer_f, _, launches_f, rate_f = train_run("published", "fwdrev")
    with phase("8fb training --fused_block --gp_mode fwdrev"):
        trainer_fb, _, launches_fb, rate_fb = train_run("block", "fwdrev")
    with phase("8o training options: --split_step, --steps_per_dispatch 4, --scan_layers, "
               "--features"):
        options = option_runs(trainer, cfg)

    from druggen_tpu_torch.ops import fused_attention as fa
    from druggen_tpu_torch.ops import fused_block as fb

    @contextlib.contextmanager
    def plain_attention():
        """K5/K6's plain versions in place of the kernels (same rounding
        points), for the step that holds the kernels in the training step."""
        saved = fa.edge_attention_fwd, fa.edge_attention_bwd
        fa.edge_attention_fwd = fa.edge_attention_fwd_reference
        fa.edge_attention_bwd = fa.edge_attention_bwd_reference
        try:
            yield
        finally:
            fa.edge_attention_fwd, fa.edge_attention_bwd = saved

    @contextlib.contextmanager
    def plain_block():
        """K7/K8's plain versions in place of the kernels (same rounding
        points), for the step that holds them in the --fused_block step."""
        saved = fb.fused_block_fwd, fb.fused_block_bwd
        fb.fused_block_fwd = fb.fused_block_fwd_reference
        fb.fused_block_bwd = fb.fused_block_bwd_reference
        try:
            yield
        finally:
            fb.fused_block_fwd, fb.fused_block_bwd = saved

    @contextlib.contextmanager
    def plain_tail():
        """K1/K2's plain versions in place of the kernels (same rounding
        points), for the step that holds them in the published step."""
        saved = fm.fused_ln_mlp_ln, fm.fused_ln_mlp_ln_bwd
        fm.fused_ln_mlp_ln = fm.fused_ln_mlp_ln_reference
        fm.fused_ln_mlp_ln_bwd = fm.fused_ln_mlp_ln_bwd_reference
        try:
            yield
        finally:
            fm.fused_ln_mlp_ln, fm.fused_ln_mlp_ln_bwd = saved

    def agreement(tr, pallas: bool, reference: str, x, a, dx, da, block: bool = False,
                  tail_same_rows=None, gp_mode: str = "revrev"):
        """One step from the same state through the kernels and through a
        reference: ``"plain path"`` (no kernel: the eager modules),
        ``"plain K1/K2"``, ``"plain K5/K6"`` or ``"plain K7/K8"`` (the same
        step with those kernels' plain versions).  ``block``: the kernels' step is
        --fused_block's (G and the critic's first-order passes in block
        mode).  ``tail_same_rows``: the bf16 G edge tails' agreement with
        the plain path on the same rows and cotangent (tail_diagnosis), held
        in place of the step's own reading, which follows the cotangent.
        ``gp_mode``: both steps' penalty (under fwdrev its inner pass takes
        the kernels too)."""
        opts = (tr.g_opt, tr.d_opt)
        g_opt = opts[0]

        def mask(parts):
            return torch.cat([torch.full((p.numel(),), any(t in n for t in parts))
                              for n, p in zip(g_opt.names, g_opt.params)]).cuda()

        tail, attn = mask(TAIL_PARAMS), mask(ATTN_PARAMS)
        plain = {"plain K1/K2": plain_tail, "plain K5/K6": plain_attention,
                 "plain K7/K8": plain_block}
        for dtype in (torch.bfloat16, torch.float32):
            eps = penalty_noise(dtype)
            results = {}
            for fused in (True, False):
                kernels = fused or reference in plain
                mode = ("block" if block else True) if kernels else False
                with contextlib.nullcontext() if fused else (
                        plain.get(reference, contextlib.nullcontext)()):
                    d_l, g_l, grads, launched = step_record(
                        tr, dtype, eps, (x, a, dx, da), g_fused=mode, fused_critic=mode,
                        g_pallas=kernels and pallas, gp_mode=gp_mode)
                results[fused] = (d_l, g_l, grads, tuple(launched.values()))
            (dk, gk, grads_k, lk), (dp, gp, grads_p, lp) = results[True], results[False]
            rel_d, rel_g = rel_err(grads_k[0], grads_p[0]), rel_err(grads_k[1], grads_p[1])
            rel_tail = rel_err(grads_k[1][tail], grads_p[1][tail])
            rel_attn = rel_err(grads_k[1][attn], grads_p[1][attn])
            dl = abs(dk - dp) / max(1.0, abs(dp))
            gl = abs(gk - gp) / max(1.0, abs(gp))
            label = (f"{'use_pallas, ' if pallas else ''}{'--fused_block, ' if block else ''}"
                     f"{'--gp_mode fwdrev, ' if gp_mode == 'fwdrev' else ''}"
                     f"{'critic depth 2, ' if len(tr.D.TransformerEncoder.Encoder_Blocks) == 2 else ''}"
                     f"kernels vs {reference}")
            print(f"   {label} {str(dtype):>14}: d_loss {dk:.6f} / {dp:.6f}; "
                  f"g_loss {gk:.6f} / {gp:.6f}; gradient rel. error "
                  f"D {rel_d:.3e}, G {rel_g:.3e}, G's edge tails {rel_tail:.3e}, "
                  f"G's attention {rel_attn:.3e}; launches (K1, K2, K5, K6, K7, K8) "
                  f"{lk} / {lp}", flush=True)
            tails = 0 if block else 1
            want_k = (tails, tails, int(pallas), int(pallas), int(block), int(block))
            want_p = {"plain K5/K6": (1, 1, 0, 0, 0, 0)}.get(reference, (0,) * 6)
            if [min(v, 1) for v in lk] != list(want_k) or [min(v, 1) for v in lp] != list(want_p):
                raise AssertionError(f"launches {lk} / {lp} in the step agreement ({label})")
            if (pallas or block) and reference == "plain path" and dtype == torch.bfloat16:
                # information: the plain bf16 path rounds e, t, the softmax and
                # the tail's input at bf16 where K5/K6 and K7/K8 keep f32 (the
                # JAX package's fused steps differ from its XLA step alike);
                # the kernels are held by the comparison with their plain
                # versions
                continue
            tol = TOL_STEP[dtype]
            if tail_same_rows is not None and dtype == torch.bfloat16:
                print(f"   G's edge tails held on the same rows and cotangent: "
                      f"{tail_same_rows:.3e} (the step's {rel_tail:.3e} follows the "
                      f"cotangent that reaches the tail)", flush=True)
                rel_tail = tail_same_rows
            if (max(dl, gl, rel_d, rel_g, rel_attn) > tol or rel_tail > TOL_TAIL[dtype]):
                raise AssertionError(f"step through the kernels disagrees with "
                                     f"the {reference} step ({label}, {dtype}): losses "
                                     f"{dl}, {gl}, gradients D {rel_d}, G {rel_g}, "
                                     f"G's edge tails {rel_tail}, G's attention {rel_attn}")

    def penalty_noise(dtype) -> tuple:
        """The gradient-penalty noise every compared step takes (seed SEED)."""
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        return (torch.rand((TRAIN_BATCH, 1, 1), generator=gen, device="cuda", dtype=dtype),
                torch.rand((TRAIN_BATCH, 1, 1, 1), generator=gen, device="cuda", dtype=dtype))

    def step_record(tr, dtype, eps, batch, **kw):
        """One step from ``tr``'s state (restored after): the losses, each
        update's gradients (flat) and the launches by kernel."""
        opts = (tr.g_opt, tr.d_opt)
        snap = snapshot(opts)
        grads = []
        for o in opts:      # record the gradients each update takes
            o.step = (lambda g, o=o: (grads.append(o.flat_grads(g)), AdamW.step(o, g)))
        for fn in counted.values():
            fn.launches = 0
        step = TrainStep(tr.G, tr.D, *opts, lambda_gp=cfg.lambda_gp, m_dim=tr.m_dim,
                         b_dim=tr.b_dim, submodel=cfg.submodel, compute_dtype=dtype, **kw)
        try:
            out = step(*batch, eps=eps)
        finally:
            for o in opts:
                del o.step
            restore(opts, snap)
        return (out["d_loss"].float().item(), out["g_loss"].float().item(), grads,
                {key: fn.launches for key, fn in counted.items()})

    def penalty_modes(tr, block: bool, x, a, dx, da) -> dict:
        """One step from the same state with the reverse-over-forward penalty
        and with the reference's double backward, through the same kernels
        (--fused_block's or the published), bf16 and f32: the D loss and the
        critic's gradients held to TOL_STEP (the same function, summed in
        another order); G's printed (G trains against critics that one
        Adam step apart already differ).  fwdrev's inner pass adds a launch
        of K7 and K8 a critic block (of K1/K2 a critic block but the last).
        Where it does, in bf16 the two penalties round at other points (the
        kernels keep f32 where revrev's plain bf16 critic rounds; the JAX
        package's fused steps differ from its XLA step alike): printed, and
        the kernels held against their plain versions in the same fwdrev
        step instead (``agreement``)."""
        mode = "block" if block else True
        out = {}
        for dtype in (torch.bfloat16, torch.float32):
            eps = penalty_noise(dtype)
            runs = {gp: step_record(tr, dtype, eps, (x, a, dx, da), g_fused=mode,
                                    fused_critic=mode, gp_mode=gp)
                    for gp in ("fwdrev", "revrev")}
            (df, gf, grads_f, lf), (dr, gr, grads_r, lr) = runs["fwdrev"], runs["revrev"]
            rel_d, rel_g = rel_err(grads_f[0], grads_r[0]), rel_err(grads_f[1], grads_r[1])
            dl = abs(df - dr) / max(1.0, abs(dr))
            depth_d = len(tr.D.TransformerEncoder.Encoder_Blocks)
            extra = depth_d if block else depth_d - 1
            names = ("fused_block_fwd", "fused_block_bwd") if block else \
                ("fused_ln_mlp_ln_fwd", "fused_ln_mlp_ln_bwd")
            held = dtype == torch.float32 or extra == 0
            print(f"   {'--fused_block, ' if block else ''}fwdrev vs revrev {str(dtype):>14}: "
                  f"d_loss {df:.6f} / {dr:.6f}; g_loss {gf:.6f} / {gr:.6f}; gradient rel. "
                  f"error D {rel_d:.3e} ({'held' if held else 'information'}), G "
                  f"{rel_g:.3e}; launches "
                  f"{ {k: (lf[k], lr[k]) for k in names} }", flush=True)
            if any(lf[k] != lr[k] + extra for k in names):
                raise AssertionError(f"fwdrev's inner pass did not take the kernels: "
                                     f"{lf} / {lr}")
            if held and max(dl, rel_d) > TOL_STEP[dtype]:
                raise AssertionError(f"the fwdrev step disagrees with the revrev step "
                                     f"({'block' if block else 'published'}, {dtype}): "
                                     f"d_loss {dl}, D gradient {rel_d}")
            out[str(dtype)] = {"d_rel": rel_d, "g_rel": rel_g, "d_loss_rel": dl}
        return out

    def deep_critic(tr):
        """Phase 8f's Generator (a copy) and a critic of depth 2 (random
        weights, seed 42), with their own optimizers: the shape at which
        the fused critic's tail (K1/K2) runs in the penalty's inner pass."""
        kw = dict(act=cfg.act, vertexes=tr.vertexes, edges=tr.b_dim, nodes=tr.m_dim,
                  dim=cfg.dim, heads=cfg.heads, mlp_ratio=cfg.mlp_ratio,
                  dtype=torch.bfloat16)
        init = torch.Generator().manual_seed(42)
        G = Generator(dropout=0.0, depth=cfg.depth, fused_mlp=True, generator=init, **kw)
        G.load_state_dict(tr.G.state_dict())
        D = Discriminator(dropout=0.0, depth=2, generator=init, **kw)
        G.to("cuda")
        D.to("cuda")
        g_opt, d_opt = make_optimizers(dataclasses.replace(cfg, ddepth=2), G, D)
        return SimpleNamespace(G=G, D=D, g_opt=g_opt, d_opt=d_opt, m_dim=tr.m_dim,
                               b_dim=tr.b_dim)

    def layer_norm_trap(tr, x, a, dx, da) -> dict:
        """Information (a known limit of torch): the f32 fwdrev penalty's
        critic gradients with the JVP pass's LayerNorms from primitives (as
        the step runs it) and with ``F.layer_norm``, each against the
        double backward's, on this card's torch."""
        step = TrainStep(tr.G, tr.D, tr.g_opt, tr.d_opt, lambda_gp=cfg.lambda_gp,
                         m_dim=tr.m_dim, b_dim=tr.b_dim, compute_dtype=torch.float32)
        xs, as_, dxs, das = step._inputs(x, a, dx, da)
        with torch.no_grad():
            fake = step._generate(as_, xs)
        eps = penalty_noise(torch.float32)
        params = list(tr.D.parameters())

        def critic(forward_mode=False):
            def run(e, n):
                with numerics(tr.D, dtype=None, fused_mlp=False, forward_mode=forward_mode):
                    return tr.D(e, n)
            return run

        def grads(gp):
            return torch.cat([g.flatten() for g in torch.autograd.grad(
                gp, params, allow_unused=True, materialize_grads=True)])
        ends = (dxs, das, fake[2], fake[3], *eps)
        want = grads(gradient_penalty(critic(), *ends))
        out = {}
        for fm_ in (True, False):
            got = grads(gradient_penalty_fwdrev(critic(), *ends, critic_jvp=critic(fm_)))
            out["primitives" if fm_ else "F.layer_norm"] = rel_err(got, want)
        print(f"   f32 fwdrev penalty's critic gradients against the double backward's "
              f"(torch {torch.__version__}): JVP pass LayerNorm from primitives "
              f"{out['primitives']:.3e}; with F.layer_norm {out['F.layer_norm']:.3e} "
              f"(information)", flush=True)
        return out

    def tail_diagnosis(tr, x, a, dx, da) -> float:
        """The published bf16 step's G edge tail against the plain path's,
        taken apart.  A bf16 step from the state through the kernels ("k"),
        one through the plain path ("p") and an f32 step through the kernels
        ("f") record G's tail input s (ln4's input) and output cotangent
        dout.  Printed: how far s and dout of each step lie from the others'
        and how the k-p gap of dout spreads over the rows; the tail's 8
        gradients on given rows by K2, by the plain path's eager bf16 tail
        (autograd) and by the f32 function (K2's plain version on f32
        copies), leaf by leaf; LN2's 1/std over the rows.  Returns the larger
        relative error of K2 against the plain-path tail on the same rows
        (the k and the p step's)."""
        blk = next(m for m in tr.G.modules() if isinstance(m, layers.EncoderBlock))
        names = ("ln4.weight", "ln4.bias", "fc1.weight", "fc1.bias", "fc2.weight",
                 "fc2.bias", "ln6.weight", "ln6.bias")
        leaves = [blk.get_parameter(n.replace("fc", "mlp2.fc")) for n in names]
        opts = (tr.g_opt, tr.d_opt)
        seen = {}
        kernel_bwd = fm.fused_ln_mlp_ln_bwd

        def rows(t):
            return t.detach().reshape(-1, t.shape[-1]).clone()

        def record(s, *rest):
            if rest[0].data_ptr() == leaves[0].data_ptr():
                seen[seen["now"]] = (rows(s), rows(rest[-1]))
            return kernel_bwd(s, *rest)
        record.launches = 0   # the wrapper counts its launches on its module name

        def pre_ln4(_, args):
            seen["s"] = rows(args[0])

        def post_ln6(_, __, out):
            now = seen["now"]
            out.register_hook(lambda g: seen.__setitem__(now, (seen["s"], rows(g))))
        modes = {"k": (torch.bfloat16, True), "p": (torch.bfloat16, False),
                 "f": (torch.float32, True)}
        for tag, (dtype, fused) in modes.items():
            snap = snapshot(opts)
            eps_gen = torch.Generator(device="cuda").manual_seed(SEED)
            eps = (torch.rand((TRAIN_BATCH, 1, 1), generator=eps_gen, device="cuda",
                              dtype=dtype),
                   torch.rand((TRAIN_BATCH, 1, 1, 1), generator=eps_gen, device="cuda",
                              dtype=dtype))
            step = TrainStep(tr.G, tr.D, *opts, lambda_gp=cfg.lambda_gp, m_dim=tr.m_dim,
                             b_dim=tr.b_dim, submodel=cfg.submodel, compute_dtype=dtype,
                             g_fused=fused, fused_critic=fused)
            hooks = [] if fused else [blk.ln4.register_forward_pre_hook(pre_ln4),
                                      blk.ln6.register_forward_hook(post_ln6)]
            seen["now"] = tag
            fm.fused_ln_mlp_ln_bwd = record
            try:
                step(x, a, dx, da, eps=eps)
            finally:
                fm.fused_ln_mlp_ln_bwd = kernel_bwd
                for hk in hooks:
                    hk.remove()
                restore(opts, snap)
        (s_k, d_k), (s_p, d_p) = seen["k"], seen["p"]
        w = [p.detach() for p in leaves]
        tp = (w[0], w[1], w[2].t(), w[3], w[4].t(), w[5], w[6], w[7])

        def leaf_layout(g):   # K2's dw1 [C, H] and dw2 [H, C] as the leaves
            return [g[0], g[1], g[2].t(), g[3], g[4].t(), g[5], g[6], g[7]]

        def kernel(s, d):
            return leaf_layout(fm.fused_ln_mlp_ln_bwd(s, *tp, d)[1:])

        def eager(s, d):
            with numerics(blk, dtype=torch.bfloat16):
                y2 = blk.ln4(s)
                out = blk.ln6(y2 + blk.mlp2(y2))
            return list(torch.autograd.grad(out, leaves, d))

        def exact(s, d):
            return leaf_layout(fm.fused_ln_mlp_ln_bwd_reference(s.float(), *tp, d.float())[1:])

        def cat(g):
            return torch.cat([v.float().flatten() for v in g])

        def gap(i, m1, m2):
            return rel_err(seen[m1][i].float(), seen[m2][i].float())
        share = (d_k.float() - d_p.float()).square().sum(-1).sort(descending=True).values
        print(f"   G's edge tail from the state of phase 9 ({s_k.shape[0]:,} rows; bf16 "
              f"steps through the kernels k and the plain path p, an f32 step through the "
              f"kernels f): s rel. gap k-p {gap(0, 'k', 'p'):.3e}, k-f {gap(0, 'k', 'f'):.3e}, "
              f"p-f {gap(0, 'p', 'f'):.3e}; dout rel. gap k-p {gap(1, 'k', 'p'):.3e}, k-f "
              f"{gap(1, 'k', 'f'):.3e}, p-f {gap(1, 'p', 'f'):.3e}; |dout| a row, median "
              f"{d_k.float().norm(dim=-1).median().item():.3e}; share of the k-p dout gap in "
              f"its largest rows: " + ", ".join(
                  f"{k:,} {share[:k].sum().item() / share.sum().item():.3f}"
                  for k in (10, 100, 1_000, 10_000)), flush=True)
        print(f"   tail gradients of the k step vs the p step, each on its own rows: K2 "
              f"vs plain-path tail {rel_err(cat(kernel(s_k, d_k)), cat(eager(s_p, d_p))):.3e}",
              flush=True)
        same_rows = []
        for tag, (s, d) in (("k step's", (s_k, d_k)), ("p step's", (s_p, d_p))):
            gk, ge, g32 = kernel(s, d), eager(s, d), exact(s, d)
            same_rows.append(rel_err(cat(gk), cat(ge)))
            print(f"   on the {tag} rows: K2 vs plain-path tail {same_rows[-1]:.3e}; vs the "
                  f"f32 function: K2 {rel_err(cat(gk), cat(g32)):.3e}, plain-path tail "
                  f"{rel_err(cat(ge), cat(g32)):.3e}; by leaf (|g|; K2 vs plain; K2, plain vs "
                  f"f32): " + "; ".join(
                      f"{n} {g32[i].norm().item():.2e}: {rel_err(gk[i], ge[i]):.1e}, "
                      f"{rel_err(gk[i], g32[i]):.1e}, {rel_err(ge[i].float(), g32[i]):.1e}"
                      for i, n in enumerate(names)), flush=True)
        sf = s_k.float()   # LN2's 1/std over the rows, from the f32 function
        x1 = F.layer_norm(sf, (sf.shape[-1],), tp[0], tp[1], 1e-5)
        z = x1 + torch.relu(x1 @ tp[2] + tp[3]) @ tp[4] + tp[5]
        rstd2 = torch.rsqrt(z.var(-1, unbiased=False) + 1e-5)
        print(f"   LN2's 1/std over the rows: max {rstd2.max().item():.2f}, median "
              f"{rstd2.median().item():.2f}; rows above 10 {int((rstd2 > 10).sum()):,}",
              flush=True)
        return max(same_rows)

    with phase("9 step agreement"):
        x, a = next(iter(BatchIterator(trainer.data, TRAIN_BATCH, seed=SEED)))
        dx, da = next(iter(BatchIterator(trainer.drug_data, TRAIN_BATCH, seed=SEED)))
        agreement(trainer, False, "plain K1/K2", x, a, dx, da)
        same_rows = tail_diagnosis(trainer, x, a, dx, da)
        agreement(trainer, False, "plain path", x, a, dx, da, tail_same_rows=same_rows)
        agreement(trainer_p, True, "plain K5/K6", x, a, dx, da)
        agreement(trainer_p, True, "plain path", x, a, dx, da)
        agreement(trainer_b, False, "plain K7/K8", x, a, dx, da, block=True)
        agreement(trainer_b, False, "plain path", x, a, dx, da, block=True)
        # the reverse-over-forward penalty (phases 8f and 8fb's states)
        modes_f = penalty_modes(trainer_f, False, x, a, dx, da)
        modes_fb = penalty_modes(trainer_fb, True, x, a, dx, da)
        agreement(trainer_fb, False, "plain K7/K8", x, a, dx, da, block=True,
                  gp_mode="fwdrev")
        deep = deep_critic(trainer_f)
        agreement(deep, False, "plain K1/K2", x, a, dx, da, gp_mode="fwdrev")
        modes_deep = penalty_modes(deep, False, x, a, dx, da)
        del deep
        trap = layer_norm_trap(trainer_f, x, a, dx, da)

    def profile_step(step, label: str) -> dict:
        step(x, a, dx, da)
        step_ms = cuda_ms(lambda: step(x, a, dx, da), 3, warmup=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            step(x, a, dx, da)
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0]
        busy = sum(k[1] for k in kernels)

        def share(names):
            # kernels of the port live in anonymous (and nested) namespaces
            return sum(k[1] for k in kernels if any(f"::{p}" in k[0] for p in names))

        ms = {"K1": share(("tail_fwd_",)),
              # K2's three launches, and each on its own
              "K2": share(tuple(K2_LAUNCHES.values())),
              **{f"K2 {k}": share((v,)) for k, v in K2_LAUNCHES.items()},
              "K5": share(("attn_fwd_",)),
              # K6's launches, and the Hopper route's each on its own
              "K6": share(("attn_bwd_",)),
              **{f"K6 {k}": share((v,)) for k, v in K6_LAUNCHES.items()},
              "K7": share((K7_LAUNCH,)),
              # K8's seven launches, and each on its own
              "K8": share(tuple(K8_LAUNCHES.values())),
              **{f"K8 {k}": share((v,)) for k, v in K8_LAUNCHES.items()}}
        print(f"   training step{label}, batch {TRAIN_BATCH}, bf16, on "
              f"{name} ({smi_line}): {step_ms:.3f} ms (CUDA events, mean of 3); "
              f"kernels {busy:.3f} ms; idle share "
              f"{max(0.0, 1 - busy / step_ms):.3f}; peak memory {peak:.2f} GiB "
              f"(max_memory_allocated over the step); "
              + ", ".join(f"{k} {v:.3f} ms ({100 * v / max(busy, 1e-9):.1f}%)"
                          for k, v in ms.items()))
        for key, t_ms, count in sorted(kernels, key=lambda k: -k[1])[:10]:
            print(f"   {t_ms:8.3f} ms {100 * t_ms / busy:5.1f}% x{count:<3d} {key[:90]}")
        if not kernels:
            print("   the profiler recorded no device time")
        return {"step_ms": step_ms, "busy_ms": busy, "peak_gib": peak,
                **{f"{k}_ms": v for k, v in ms.items()}}

    with phase("10 step profile"):
        prof = profile_step(trainer.step_fn, "")
        prof_p = profile_step(trainer_p.step_fn, " with use_pallas (K5/K6 in G)")
        prof_b = profile_step(trainer_b.step_fn, " with --fused_block (K7/K8)")
        prof_f = profile_step(trainer_f.step_fn, " with --gp_mode fwdrev")
        prof_fb = profile_step(trainer_fb.step_fn, " with --fused_block --gp_mode fwdrev")
        for label, rev, fwd in (("as published", prof, prof_f),
                                ("with --fused_block", prof_b, prof_fb)):
            print(f"   fwdrev against revrev {label}: step {fwd['step_ms']:.3f} / "
                  f"{rev['step_ms']:.3f} ms ({fwd['step_ms'] / rev['step_ms']:.3f}x); kernels "
                  f"busy {fwd['busy_ms']:.3f} / {rev['busy_ms']:.3f} ms; peak memory "
                  f"{fwd['peak_gib']:.2f} / {rev['peak_gib']:.2f} GiB", flush=True)
    del trainer, trainer_p, trainer_b, trainer_f, trainer_fb
    tmp.cleanup()
    return {"launches": launches, "launches_pallas": launches_p, "launches_block": launches_b,
            "launches_resumed": resumed["launches"], "pallas_rate": rate_p,
            "pallas_profile": prof_p, "block_rate": rate_b, "block_profile": prof_b,
            "launches_fwdrev": launches_f, "launches_block_fwdrev": launches_fb,
            "fwdrev_rate": rate_f, "block_fwdrev_rate": rate_fb, "profile": prof,
            "fwdrev_profile": prof_f, "block_fwdrev_profile": prof_fb,
            "fwdrev_vs_revrev": {"published": modes_f, "block": modes_fb,
                                 "critic_depth_2": modes_deep},
            "layer_norm_trap": trap, "options": options}


class _Tee:
    """Writes to stdout and keeps a copy (to read what a run printed)."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def cli_serving(tmp_dir: str, inf_smi: str, counted_all: dict, name: str,
                smi_line: str) -> dict:
    """Phase 4c: ``python -m druggen_tpu_torch.inference`` as a user runs it,
    with its defaults (rule-based correction with top-up, the 14-key
    report), through K9 in bf16 on the trained r2_scale Generator.  The
    training reference is phase 8's 8,192 molecules (``CLI_SAMPLE_NUM``'s
    note).  Checks the report's keys, order and ranges, the delivered rows,
    the top-up rounds and that K9 ran once a forward over every round and no
    other kernel ran; prints the host time of each stage."""
    from druggen_tpu_torch import inference as cli
    from druggen_tpu_torch.infer.engine import InferenceEngine

    train_smi = os.path.join(tmp_dir, f"chembl_like_{TRAIN_MOLECULES}.smi")
    with open(SMILES_FILE) as src, open(train_smi, "w") as dst:
        for _, line in zip(range(TRAIN_MOLECULES), src):
            dst.write(line)
    # the checkpoint's vocab, under the name the CLI looks for
    vocab_dir = os.path.join(tmp_dir, "vocab")
    os.makedirs(vocab_dir, exist_ok=True)
    names = sorted(os.path.splitext(os.path.basename(f))[0] for f in (train_smi, DRUG_FILE))
    with open(VOCAB_JSON) as src, open(
            os.path.join(vocab_dir, f"vocab_{names[0]}_{names[1]}_{N_ATOMS}.json"), "w") as dst:
        dst.write(src.read())
    out_dir = os.path.join(tmp_dir, "out_cli")
    argv = ["--submodel", "DrugGEN", "--inference_model", CKPT_DIR,
            "--inf_smiles", inf_smi, "--train_smiles", train_smi,
            "--train_drug_smiles", DRUG_FILE, "--mol_data_dir", tmp_dir,
            "--output_dir", out_dir, "--inf_batch_size", str(SERVE_BATCH),
            "--sample_num", str(CLI_SAMPLE_NUM), "--compute_dtype", "bfloat16",
            "--use_pallas"]
    print(f"   python -m druggen_tpu_torch.inference {' '.join(argv)}", flush=True)
    engines = []
    run = InferenceEngine.run

    def run_and_keep(engine):
        engines.append(engine)
        return run(engine)

    for fn in counted_all.values():
        fn.launches = 0
    tee = _Tee(sys.stdout)
    InferenceEngine.run = run_and_keep
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            results = cli.main(argv)
    finally:
        InferenceEngine.run = run
    wall = time.perf_counter() - t0
    launches = {key: fn.launches for key, fn in counted_all.items()}
    engine = engines[0]
    forwards = len(engine.timings)
    rounds = engine.topup_rounds
    print(f"   launches: {launches} over {forwards} forwards in {rounds} top-up round(s) "
          f"(expected one K9 a forward and no other kernel)")
    if launches["fused_generator_logits"] != forwards or not forwards:
        raise AssertionError("the CLI's serving run did not go through K9 once a forward")
    if any(n for k, n in launches.items() if k != "fused_generator_logits"):
        raise AssertionError("the CLI's serving run launched another kernel")
    if list(results) != ["submodel", *REPORT_RANGES]:
        raise AssertionError(f"the report's keys are not the JAX engine's: {list(results)}")
    for key, (lo, hi) in REPORT_RANGES.items():
        v = results[key]
        if not (isinstance(v, float) and math.isfinite(v) and lo <= v <= hi):
            raise AssertionError(f"report {key} = {v!r} is not a finite value in [{lo}, {hi}]")
    printed = tee.text()
    if rounds != printed.count("correction top-up round") or rounds >= 20:
        raise AssertionError(f"{rounds} top-up rounds (printed "
                             f"{printed.count('correction top-up round')}); expected < 20")
    with open(os.path.join(out_dir, "DrugGEN", "inference_drugs.csv")) as f:
        delivered = [row["SMILES"] for row in csv.DictReader(f)]
    with open(os.path.join(out_dir, "DrugGEN", "corrected.smi")) as f:
        corrected = f.read().splitlines()
    if len(delivered) != CLI_SAMPLE_NUM and "sampling stalled" not in printed:
        raise AssertionError(f"{len(delivered)} molecules delivered of {CLI_SAMPLE_NUM} "
                             "and the run did not say why")
    if len(set(delivered)) != len(delivered) or not corrected:
        raise AssertionError("the delivered set has duplicates, or corrected.smi is empty")
    secs = engine.run_seconds
    fwd = sum(t["forward_s"] for t in engine.timings)
    dec = sum(t["decode_s"] for t in engine.timings)
    print(f"   report: {results}")
    print(f"   {len(delivered)} molecules delivered ({forwards * SERVE_BATCH} graphs "
          f"sampled); host seconds by stage: " + ", ".join(
              f"{k} {v:.3f}" for k, v in secs.items())
          + f"; of sampling and top-up, device windows {fwd:.3f} and decode {dec:.3f}")
    rate = len(delivered) / wall
    print(f"   CLI serving on {name} ({smi_line}): {rate:.1f} molecules delivered a "
          f"second with correction and the report ({wall:.2f} s for main(), engine "
          f"set-up included)", flush=True)
    return {"launches": launches, "forwards": forwards, "rounds": rounds,
            "molecules_per_s": rate, "seconds": secs, "wall_s": wall}


def native_setup(name: str, smi_line: str) -> None:
    """Phase 11: the native library built from the checkout's source (into a
    fresh directory, timed), then the vocabulary scan and the featurization
    of the whole corpus through it; the Python path on the first
    ``PY_SETUP_MOLECULES``, held bit for bit against the native rows."""
    import numpy as np

    from druggen_tpu_torch import native
    from druggen_tpu_torch.chem.codec import smiles_to_matrices
    from druggen_tpu_torch.chem.vocab import build_vocab, read_smiles_file

    build_dir = native.BUILD_DIR
    with tempfile.TemporaryDirectory(prefix="chip_smoke_native_") as fresh:
        native.BUILD_DIR, native._lib = Path(fresh), None
        try:
            t0 = time.perf_counter()
            native.available()
            build_s = time.perf_counter() - t0
        finally:
            native.BUILD_DIR = build_dir
    smiles = read_smiles_file(SMILES_FILE)
    t0 = time.perf_counter()
    vocab = build_vocab(smiles, N_ATOMS)
    scan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, a, kept = native.featurize_batch_native(smiles, vocab, N_ATOMS)
    feat_s = time.perf_counter() - t0
    rate = len(smiles) / (scan_s + feat_s)
    print(f"   native build ({native.compiler()} {' '.join(native.CXX_FLAGS)}): "
          f"{build_s:.2f} s; {len(smiles):,} molecules: vocab scan {scan_s:.3f} s, "
          f"featurize {feat_s:.3f} s ({len(kept):,} kept): {rate:,.0f} molecules a second "
          f"of set-up; vocab {vocab}")
    head = smiles[:PY_SETUP_MOLECULES]
    t0 = time.perf_counter()
    py_vocab = build_vocab(head, N_ATOMS, use_native=False)
    py_scan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    py_rows = [(i, r) for i, r in enumerate(smiles_to_matrices(s, vocab, N_ATOMS)
                                            for s in head) if r is not None]
    py_feat_s = time.perf_counter() - t0
    py_rate = len(head) / (py_scan_s + py_feat_s)
    n = sum(1 for i in kept if i < len(head))
    equal = (py_vocab == build_vocab(head, N_ATOMS)
             and [i for i, _ in py_rows] == kept[:n]
             and np.array_equal(np.stack([r[0] for _, r in py_rows]), x[:n])
             and np.array_equal(np.stack([r[1] for _, r in py_rows]), a[:n]))
    print(f"   Python path on the first {len(head):,}: vocab scan {py_scan_s:.3f} s, "
          f"featurize {py_feat_s:.3f} s: {py_rate:,.0f} molecules a second "
          f"({rate / py_rate:.1f}x slower than native); vocab, kept indices, X and A "
          f"bit-equal to the native path's: {equal}")
    print(f"   native set-up on {name} host ({smi_line}): {rate:,.0f} molecules/s "
          f"against {py_rate:,.0f} for the Python path", flush=True)
    if not equal:
        raise AssertionError("the native set-up disagrees with the Python path")


def checkpoint_selection(post_dir: str, ref1: str, counted_all: dict, name: str,
                         smi_line: str) -> dict:
    """Phase 12 (returns its launch counts): ``python -m druggen_tpu_torch.select_checkpoint`` as
    ``experiments/r5_scale/post_run.sh`` runs it (bf16, ``--fused_mlp``), on
    a directory of phase 8's cadence exports and the trained r2_scale
    Generator under a cadence name, from a run directory that holds the
    checkpoint's vocab where the engine looks for it (``data/vocab``).
    Checks a row for each checkpoint, every field finite and in range, and
    one K1 launch a block a forward and no other kernel; prints the seconds
    of each checkpoint by stage and the ranking."""
    from druggen_tpu_torch import select_checkpoint

    models = os.path.join(post_dir, "models")
    shutil.copy(os.path.join(CKPT_DIR, "DrugGEN-G.ckpt"),
                os.path.join(models, TRAINED_CADENCE_NAME))
    names = sorted(os.path.splitext(os.path.basename(f))[0] for f in (ref1, DRUG_FILE))
    vocab_dir = os.path.join(post_dir, "data", "vocab")
    os.makedirs(vocab_dir, exist_ok=True)
    shutil.copy(TRAIN_VOCAB_JSON,
                os.path.join(vocab_dir, f"vocab_{names[0]}_{names[1]}_{N_ATOMS}.json"))
    argv = ["--model_dir", models, "--inf_smiles", ref1, "--train_smiles", ref1,
            "--train_drug_smiles", DRUG_FILE, "--output",
            os.path.join(post_dir, "selection.json"), *SELECT_ARGS]
    print(f"   python -m druggen_tpu_torch.select_checkpoint {' '.join(argv)}", flush=True)
    for fn in counted_all.values():
        fn.launches = 0
    cwd = os.getcwd()
    os.chdir(post_dir)
    t0 = time.perf_counter()
    try:
        out, seconds = select_checkpoint.main(argv)
    finally:
        os.chdir(cwd)
    wall = time.perf_counter() - t0
    launches = {key: fn.launches for key, fn in counted_all.items()}
    forwards = sum(s["forwards"] for s in seconds)
    print(f"   launches: {launches} over {forwards} forwards (expected one K1 a block a "
          f"forward, depth 1, and no other kernel)")
    if launches["fused_ln_mlp_ln_fwd"] != forwards or not forwards:
        raise AssertionError("the selector's forwards did not go through K1 once each")
    if any(n for k, n in launches.items() if k != "fused_ln_mlp_ln_fwd"):
        raise AssertionError("the selector launched another kernel")
    ckpts = sorted(os.listdir(models))
    if sorted(r["ckpt"] for r in out["rows"]) != ckpts or len(ckpts) != 3:
        raise AssertionError(f"rows {[r['ckpt'] for r in out['rows']]} for {ckpts}")
    fractions = ("validity", "uniqueness", "novelty", "intdiv", "qed")
    for row in out["rows"] + out["finalists"]:
        for key, v in row.items():
            if key == "ckpt":
                continue
            lo, hi = (1, 10) if key == "sa" else (0, 1) if key in fractions else (0, math.inf)
            if not (math.isfinite(v) and lo <= v <= hi):
                raise AssertionError(f"{row['ckpt']} {key} = {v!r} not finite in [{lo}, {hi}]")
    if len(out["finalists"]) != 2:
        raise AssertionError(f"{len(out['finalists'])} finalists, expected 2")
    for s in seconds:
        print(f"   {s['phase']} {s['ckpt']}: {s['forwards']} forwards, device windows "
              f"{s['forward_s']:.3f} s, decode {s['decode_s']:.3f} s, quality terms "
              f"{s['quality_s']:.3f} s")
    print(f"   screen: {[(r['ckpt'], r['score']) for r in out['ranked']]}; finalists: "
          f"{[(r['ckpt'], r['final_score']) for r in out['finalists']]} (the trained "
          f"checkpoint is {TRAINED_CADENCE_NAME})")
    screen = [s for s in seconds if s["phase"] == "screen"]
    per_ckpt = {k: sum(s[k] for s in screen) / len(screen)
                for k in ("forward_s", "decode_s", "quality_s")}
    print(f"   checkpoint selection on {name} ({smi_line}): {wall:.2f} s for main() "
          f"(engine set-up included); a screened checkpoint {sum(per_ckpt.values()):.2f} s: "
          + ", ".join(f"{k[:-2]} {v:.3f}" for k, v in per_ckpt.items()), flush=True)
    return launches


@contextlib.contextmanager
def tf32_on():
    """cuDNN's and the matmuls' TF32 switches on for one call, then restored."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def offline_evaluation(post_dir: str, gen_csv: str, ref1: str, name: str,
                       smi_line: str) -> None:
    """Phase 13: ChemNet on the card against the CPU (f32) and its time a
    batch; then ``python -m druggen_tpu_torch.evaluate`` on phase 4c's
    delivered set, with the surrogate FCD and with the random-init ChemNet
    as ``.npz``: keys, order, ranges; host seconds by part."""
    import numpy as np

    from druggen_tpu_torch import evaluate
    from druggen_tpu_torch.chem.vocab import read_smiles_file
    from druggen_tpu_torch.metrics import chemnet
    from druggen_tpu_torch.metrics.chemnet import ChemNet, one_hot_batch

    smiles = read_smiles_file(SMILES_FILE)[:CHEMNET_MOLECULES]
    card = ChemNet.random_init(0, device="cuda")
    t0 = time.perf_counter()
    on_card = card(smiles, batch_size=CHEMNET_BATCH)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = ChemNet.random_init(0, device="cpu")(smiles, batch_size=CHEMNET_BATCH)
    cpu_s = time.perf_counter() - t0
    # the same call with TF32 left on, for its distance from f32
    f32 = chemnet._f32
    chemnet._f32 = tf32_on
    try:
        tf32 = card(smiles, batch_size=CHEMNET_BATCH)
    finally:
        chemnet._f32 = f32
    rtol, atol = TOL_CHEMNET
    err = np.abs(on_card - on_cpu)
    excess = (err - rtol * np.abs(on_cpu)).max()
    tf32_err = np.abs(tf32 - on_cpu)
    print(f"   ChemNet default_config, random_init(0), {len(smiles)} corpus SMILES, f32 "
          f"(TF32 off for its calls): card vs CPU max |err| {err.max():.3e} (largest "
          f"|out| {np.abs(on_cpu).max():.3e}; held at {atol} + {rtol} |ref|); the same "
          f"call with TF32 on: max |err| {tf32_err.max():.3e}, mean "
          f"{tf32_err.mean():.3e} (information); host seconds card {card_s:.3f}, CPU "
          f"{cpu_s:.3f}")
    if not (on_card.shape == on_cpu.shape == (len(smiles), 512) and excess <= atol):
        raise AssertionError(f"ChemNet on the card is {excess:.3e} beyond {atol} from the CPU")
    x = torch.from_numpy(one_hot_batch(smiles[:CHEMNET_BATCH])).cuda()
    t0 = time.perf_counter()
    one_hot_batch(smiles[:CHEMNET_BATCH])
    encode_ms = (time.perf_counter() - t0) * 1e3
    chemnet_ms = cuda_ms(lambda: card.forward(x), iters=10)
    print(f"   ChemNet forward, a batch of {CHEMNET_BATCH} on {name} ({smi_line}): "
          f"{chemnet_ms:.3f} ms (CUDA events, mean of 10); its one-hot encoding on the "
          f"host {encode_ms:.3f} ms", flush=True)
    weights = os.path.join(post_dir, "chemnet_random_init_0.npz")
    card.save_npz(weights)
    del card
    for label, extra in (("surrogate", []), ("chemnet", ["--chemnet-weights", weights])):
        evaluators = []
        evaluate_all = evaluate.MoleculeEvaluator.evaluate_all

        def keep(ev):
            evaluators.append(ev)
            return evaluate_all(ev)

        argv = ["--gen", gen_csv, "--ref1", ref1, "--ref2", DRUG_FILE,
                "--ref1-sample", str(EVAL_REF1_SAMPLE), "--output",
                os.path.join(post_dir, f"eval_{label}"), *extra]
        print(f"   python -m druggen_tpu_torch.evaluate {' '.join(argv)}", flush=True)
        evaluate.MoleculeEvaluator.evaluate_all = keep
        t0 = time.perf_counter()
        try:
            results = evaluate.main(argv)
        finally:
            evaluate.MoleculeEvaluator.evaluate_all = evaluate_all
        wall = time.perf_counter() - t0
        if list(results) != [*EVAL_RANGES, *EVAL_COUNTS]:
            raise AssertionError(f"the report's keys are not the JAX evaluator's: "
                                 f"{list(results)}")
        for key, (lo, hi) in EVAL_RANGES.items():
            v = results[key]
            if not (isinstance(v, float) and math.isfinite(v) and lo <= v <= hi):
                raise AssertionError(f"{label}: {key} = {v!r} not finite in [{lo}, {hi}]")
        if results["fcd_is_literal"] is not (label == "chemnet"):
            raise AssertionError(f"{label}: fcd_is_literal {results['fcd_is_literal']}")
        with open(os.path.join(post_dir, f"eval_{label}.json")) as f:
            if list(json.load(f)) != list(results):
                raise AssertionError(f"{label}: the JSON's keys differ from the report's")
        secs = evaluators[0].seconds
        print(f"   {label}: " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                                         for k, v in results.items()))
        print(f"   evaluator ({label} FCD) on {name} ({smi_line}): {wall:.2f} s for main(); "
              f"host seconds by part: " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()),
              flush=True)


def corrector_ids(corr, smiles: list[str], target: bool = False):
    """Token ids of ``smiles`` as the corrector's training encoded them: the
    native tokenizer's rows (``max_len`` wide), or the reference topology's
    source rows and, for ``target``, its reversed target rows."""
    from druggen_tpu_torch.infer.seq2seq import tokenize
    from druggen_tpu_torch.infer.seq2seq_ref import EOS, PAD, SOS, UNK

    if hasattr(corr, "tokenizer"):
        import numpy as np

        return torch.as_tensor(np.stack([corr.tokenizer.encode(s, corr.model.max_len)
                                         for s in smiles])).long()
    if not target:
        return torch.as_tensor(corr._encode_src(smiles)).long()
    rows = torch.full((len(smiles), corr.max_len + 2), PAD, dtype=torch.long)
    for r, smi in enumerate(smiles):
        ids = [SOS] + [corr.src_stoi.get(t, UNK)
                       for t in tokenize(smi)[:corr.max_len][::-1]] + [EOS]
        rows[r, :len(ids)] = torch.tensor(ids)
    return rows


def hold_corrector(label: str, card, cpu, holdout: list, recorded: dict | None,
                   name: str, smi_line: str) -> dict:
    """14a for one corrector: teacher-forced logits of the first
    ``CORRECTOR_TF_PAIRS`` held-out pairs, card against CPU in f32 (TF32
    off) at ``TOL_CHEMNET``; greedy strings of the first
    ``CORRECTOR_GREEDY`` sources equal on both; every source decoded on the
    card (seconds, SMILES a second, peak memory) and ``evaluate_corrector``'s
    six metrics, printed beside ``recorded`` (the JAX run's eval.json)."""
    from druggen_tpu_torch.train_corrector import evaluate_corrector

    pairs = holdout[:CORRECTOR_TF_PAIRS]
    src = corrector_ids(card, [s for s, _ in pairs])
    tgt = corrector_ids(card, [t for _, t in pairs], target=True)
    with torch.no_grad():
        want = cpu.model(src, tgt)
        got = card.model(src.cuda(), tgt.cuda()).cpu()
    rtol, atol = TOL_CHEMNET
    err = (got - want).abs()
    excess = (err - rtol * want.abs()).max().item()
    print(f"   {label}: teacher-forced logits of {len(pairs)} held-out pairs "
          f"{tuple(want.shape)}, card vs CPU (f32, TF32 off): max |err| {err.max():.3e} "
          f"(largest |logit| {want.abs().max():.3e}); max |err| - {rtol} |ref| "
          f"{excess:.3e}, held at {atol}")
    if not (torch.isfinite(got).all() and excess <= atol):
        raise AssertionError(f"{label}: logits on the card {excess:.3e} beyond {atol}")
    sources = [s for s, _ in holdout]
    t0 = time.perf_counter()
    cpu_out = cpu.translate_batch(sources[:CORRECTOR_GREEDY])
    cpu_s = time.perf_counter() - t0
    card_first = card.translate_batch(sources[:CORRECTOR_GREEDY])
    print(f"   {label}: greedy strings of the first {CORRECTOR_GREEDY} sources equal on "
          f"card and CPU: {card_first == cpu_out} (CPU decode {cpu_s:.2f} s)")
    if card_first != cpu_out:
        raise AssertionError(f"{label}: greedy strings differ: {card_first} vs {cpu_out}")
    card.translate_batch(sources[:2])                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = card.translate_batch(sources)
    decode_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    metrics = evaluate_corrector(SimpleNamespace(translate_batch=lambda xs: outs[:len(xs)]),
                                 holdout)
    print(f"   {label}: decode of {len(sources)} sources on {name} ({smi_line}): "
          f"{decode_s:.3f} s, {len(sources) / decode_s:.1f} SMILES/s, peak memory "
          f"{peak:.1f} MiB (max_memory_allocated)")
    for key, value in metrics.items():
        was = "" if recorded is None else f" (JAX on the TPU: {recorded[key]})"
        print(f"      {key} {value}{was}")
    check_corrector_metrics(label, metrics, len(holdout))
    return {"decode_s": decode_s, "smiles_per_s": len(sources) / decode_s,
            "peak_mib": peak, "metrics": metrics, "max_abs_err": err.max().item()}


def check_corrector_metrics(label: str, metrics: dict, n: int) -> None:
    if list(metrics) != list(CORRECTOR_EVAL_KEYS) or metrics["n_holdout"] != n:
        raise AssertionError(f"{label}: evaluate_corrector gave {list(metrics)}")
    for key in CORRECTOR_EVAL_KEYS[1:5]:
        v = metrics[key]
        if not (math.isfinite(v) and 0.0 <= v <= 1.0):
            raise AssertionError(f"{label}: {key} = {v!r} not in [0, 1]")
    if not 0 <= metrics["n_similarity_pairs"] <= n:
        raise AssertionError(f"{label}: n_similarity_pairs {metrics['n_similarity_pairs']}")


@contextlib.contextmanager
def peak_per_call(module, attr: str, into: dict):
    """Wrap ``module.attr`` so that each call records its peak device memory
    (MiB, from a reset) and host seconds into ``into[attr]``."""
    fn = getattr(module, attr)

    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        into[attr] = {"peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
                      "seconds": time.perf_counter() - t0}
        return out

    setattr(module, attr, wrapped)
    try:
        yield
    finally:
        setattr(module, attr, fn)


def neural_correctors(post_dir: str, delivered_csv: str, ref1: str, name: str,
                      smi_line: str) -> dict:
    """Phase 14: the neural SMILES correctors on the card.  14a the JAX-trained
    correctors (card against CPU, the held-out metrics), 14b
    ``train_corrector.main --arch both`` at full width, 14c serving's hook,
    14d a reference checkpoint served and one forward traced."""
    from druggen_tpu_torch import import_torch_ckpt, train_corrector
    from druggen_tpu_torch.chem.smiles import mol_from_smiles
    from druggen_tpu_torch.chem.vocab import Vocab
    from druggen_tpu_torch.config import InferenceConfig
    from druggen_tpu_torch.data.dataset import BatchIterator
    from druggen_tpu_torch.infer import seq2seq
    from druggen_tpu_torch.infer.corrector import CKPT_VAR, REFERENCE_VAR, SmilesCorrector
    from druggen_tpu_torch.infer.engine import InferenceEngine
    from druggen_tpu_torch.infer.seq2seq import Seq2SeqCorrector
    from druggen_tpu_torch.interop.corrector_ckpt import ReferenceCorrector
    from druggen_tpu_torch.utils import profiling

    work = os.path.join(post_dir, "correctors")
    os.makedirs(work)
    out = {}

    def phase_14a(native_dir: str, ref_dir: str, holdout: list, recorded: bool):
        for label, load, where in (
                ("native", Seq2SeqCorrector.load, native_dir),
                ("reference topology", ReferenceCorrector.load_trained, ref_dir)):
            t0 = time.perf_counter()
            card, cpu = load(where, device="cuda"), load(where, device="cpu")
            print(f"   {label} corrector {os.path.relpath(where, REPO) if where.startswith(REPO) else where}: "
                  f"loaded on card and CPU in {time.perf_counter() - t0:.2f} s")
            with open(os.path.join(where, "eval.json")) as f:
                eval_json = json.load(f) if recorded else None
            out[f"14a {label}"] = hold_corrector(label, card, cpu, holdout, eval_json, name,
                                                 smi_line)
            del card, cpu

    r4_weights = [os.path.join(CORRECTOR_R4, "params.msgpack"),
                  os.path.join(CORRECTOR_R4, "ref_arch", "params.msgpack")]
    with open(os.path.join(CORRECTOR_R4, "holdout_pairs.json")) as f:
        r4_holdout = json.load(f)
    have_r4 = all(os.path.exists(p) for p in r4_weights)
    if have_r4:
        with phase("14a the JAX-trained correctors (experiments/corrector_r4) on the card"):
            phase_14a(CORRECTOR_R4, os.path.join(CORRECTOR_R4, "ref_arch"), r4_holdout, True)
    else:
        print("   14a: this checkout has no corrector_r4 weights (a git archive leaves them "
              "out, .gitattributes); 14a holds 14b's correctors instead", flush=True)

    with phase("14b train_corrector --arch both at full width on the card"):
        # the vocabulary of phase 8's run, where mine_failure_pairs looks for it
        vocab_dir = os.path.join(os.path.dirname(ref1), "vocab")
        os.makedirs(vocab_dir, exist_ok=True)
        shutil.copy(TRAIN_VOCAB_JSON, os.path.join(
            vocab_dir, f"vocab_akt1_drugs_2607_chembl_like_{TRAIN_MOLECULES}_45.json"))
        corpus = [line.strip() for line in open(ref1) if line.strip()]
        # phase 8's last cadence export, 16 steps from initialisation, gives
        # no repairable failure: shown on one batch, then the run mines a
        # JAX-trained Generator of the same vocabulary whose failures repair
        probe = SimpleNamespace(smiles=ref1, drug_smiles=DRUG_FILE, max_atom=45,
                                gen_samples=256, gen_ckpt=os.path.join(
                                    post_dir, "models", f"1-{2 * TRAIN_CADENCE}-G.ckpt"),
                                gen_dim=DIM, gen_depth=1, gen_heads=HEADS, gen_mlp_ratio=3,
                                device="cuda")
        t0 = time.perf_counter()
        probe_pairs = train_corrector.mine_failure_pairs(probe, corpus)
        print(f"   phase 8's 1-{2 * TRAIN_CADENCE}-G.ckpt, 256 samples: {len(probe_pairs)} "
              f"pairs in {time.perf_counter() - t0:.2f} s (host)", flush=True)
        out_dir = os.path.join(work, "corrector")
        argv = ["--smiles", ref1, "--drug-smiles", DRUG_FILE, "--gen-ckpt", CORRECTOR_GEN_CKPT,
                "--gen-samples", str(CORRECTOR_GEN_SAMPLES), "--steps", str(CORRECTOR_STEPS),
                "--batch", str(CORRECTOR_BATCH), "--max-len", "202", "--hid", "256",
                "--layers", "3", "--arch", "both", "--out", out_dir, "--device", "cuda"]
        print(f"   python -m druggen_tpu_torch.train_corrector {' '.join(argv)}", flush=True)
        peaks = {}
        t0 = time.perf_counter()
        with peak_per_call(seq2seq, "train_corrector", peaks), \
                peak_per_call(train_corrector, "train_reference_corrector", peaks):
            result = train_corrector.main(argv)
        wall = time.perf_counter() - t0
        print(f"   main(): {wall:.2f} s; {result['pairs']} mined pairs, "
              f"{len(result['holdout'])} held out")
        if result["pairs"] <= 0:
            raise AssertionError("no failure pair was mined")
        ref_dir = os.path.join(out_dir, "ref_arch")
        for (label, corr), key in zip((("native", result["native"]),
                                       ("reference topology", result["reference"])),
                                      ("train_corrector", "train_reference_corrector")):
            losses = corr.train_log["losses"]
            head, tail = statistics.mean(losses[:50]), statistics.mean(losses[-50:])
            print(f"   {label}: {len(losses)} steps of batch {CORRECTOR_BATCH} on {name} "
                  f"({smi_line}): step {corr.train_log['step_ms']:.3f} ms (CUDA events, "
                  f"mean of steps 2-{len(losses)}); loss first 50 {head:.4f}, last 50 "
                  f"{tail:.4f}; training call {peaks[key]['seconds']:.2f} s, peak memory "
                  f"{peaks[key]['peak_mib']:.1f} MiB")
            if len(losses) != CORRECTOR_STEPS or not all(map(math.isfinite, losses)) \
                    or not tail < head:
                raise AssertionError(f"{label}: losses not finite or not falling")
            out[f"14b {label}"] = {"step_ms": corr.train_log["step_ms"],
                                   "peak_mib": peaks[key]["peak_mib"],
                                   "loss_first50": head, "loss_last50": tail}
        layout = {out_dir: ("meta.json", "tokenizer.json", "params.msgpack", "eval.json",
                            "holdout_pairs.json"),
                  ref_dir: ("params.msgpack", "vocab.json", "eval.json")}
        missing = [os.path.join(d, f) for d, names in layout.items() for f in names
                   if not os.path.exists(os.path.join(d, f))]
        if missing:
            raise AssertionError(f"missing files of the JAX layout: {missing}")
        sources = [s for s, _ in result["holdout"][:CORRECTOR_GREEDY]]
        for label, corr, back in (
                ("native", result["native"], Seq2SeqCorrector.load(out_dir, device="cuda")),
                ("reference topology", result["reference"],
                 ReferenceCorrector.load_trained(ref_dir, device="cuda"))):
            same = back.translate_batch(sources) == corr.translate_batch(sources)
            print(f"   {label}: read back from its files, the same translations of "
                  f"{len(sources)} held-out sources: {same}")
            if not same:
                raise AssertionError(f"{label}: the files do not translate as the trained model")
        for d, label in ((out_dir, "native"), (ref_dir, "reference topology")):
            with open(os.path.join(d, "eval.json")) as f:
                metrics = json.load(f)
            check_corrector_metrics(label, metrics, len(result["holdout"]))
            print(f"   {label} eval.json: {metrics}", flush=True)
        del result

    if not have_r4:
        with open(os.path.join(out_dir, "holdout_pairs.json")) as f:
            r4_holdout = json.load(f)
        with phase("14a 14b's correctors on the card"):
            phase_14a(out_dir, ref_dir, r4_holdout, False)

    with phase("14c serving's hook"):
        with open(delivered_csv) as f:
            delivered = [row["SMILES"] for row in csv.DictReader(f)]
        batch = delivered + [s for s, _ in r4_holdout]
        valid = [s for s in batch if mol_from_smiles(s) is not None]
        invalid = [s for s in batch if mol_from_smiles(s) is None]
        rule = SmilesCorrector()
        saved = {v: os.environ.pop(v, None) for v in (CKPT_VAR, REFERENCE_VAR)}
        try:
            for var, value in ((CKPT_VAR, out_dir), (REFERENCE_VAR, ref_dir)):
                os.environ[var] = value
                corr = SmilesCorrector.default(device="cuda")
                calls = []
                translate = corr.neural.translate_batch

                def spy(xs, translate=translate, neural=corr.neural):
                    fixes = translate(xs)
                    calls.append((len(xs), neural.device.type, fixes))
                    return fixes

                corr.neural.translate_batch = spy
                t0 = time.perf_counter()
                got = corr.correct(batch)
                wall = time.perf_counter() - t0
                if [c[:2] for c in calls] != [(len(invalid), "cuda")]:
                    raise AssertionError(f"${var}: translate_batch calls {[c[:2] for c in calls]}")
                fixes = calls[0][2]
                rescued = [f for f in fixes if f and mol_from_smiles(f) is not None]
                want = rule.correct(valid + rescued)
                print(f"   ${var}={os.path.relpath(value, post_dir)}: "
                      f"{type(corr.neural).__name__} on {corr.neural.device}; correct() of "
                      f"{len(delivered)} delivered + {len(r4_holdout)} held-out sources "
                      f"({len(invalid)} invalid) in "
                      f"{wall:.2f} s: one translate_batch of {len(invalid)} on the card, "
                      f"{len(rescued)} rescued, {len(got)} delivered after standardising "
                      f"and deduplicating")
                if got != want:
                    raise AssertionError(f"${var}: correct() differs from the rule path on "
                                         "the rescued set")
                out[f"14c {var}"] = {"rescued": len(rescued), "seconds": wall}
                del os.environ[var]
        finally:
            for var, value in saved.items():
                os.environ.pop(var, None)
                if value is not None:
                    os.environ[var] = value

    with phase("14d a reference checkpoint served, one forward traced"):
        ref_ckpt_dir = os.path.join(work, "reference_ckpt")
        dp_dir = os.path.join(work, "reference_ckpt_dp")
        os.makedirs(ref_ckpt_dir)
        os.makedirs(dp_dir)
        argv = ["--reverse", "--model", "generator", "--input",
                os.path.join(CKPT_DIR, "DrugGEN-G.ckpt"), "--output",
                os.path.join(ref_ckpt_dir, "DrugGEN-G.ckpt")]
        print(f"   python -m druggen_tpu_torch.import_torch_ckpt {' '.join(argv)}")
        if import_torch_ckpt.main(argv) != 0:
            raise AssertionError("import_torch_ckpt --reverse failed")
        sd = torch.load(os.path.join(ref_ckpt_dir, "DrugGEN-G.ckpt"), weights_only=True)
        torch.save({"module." + k: v for k, v in sd.items()},
                   os.path.join(dp_dir, "DrugGEN-G.ckpt"))
        inf_smi = os.path.join(work, "inf.smi")
        with open(SMILES_FILE) as src, open(inf_smi, "w") as dst:
            for _, line in zip(range(2 * SERVE_BATCH), src):
                dst.write(line)
        with open(VOCAB_JSON) as f:
            vocab = Vocab.from_json(f.read())
        labels = {}
        for label, model_dir in (("msgpack", CKPT_DIR), ("reference .ckpt", ref_ckpt_dir),
                                 ("reference .ckpt with module.", dp_dir)):
            cfg = InferenceConfig(
                submodel="DrugGEN", inference_model=model_dir, inf_smiles=inf_smi,
                train_smiles=inf_smi, train_drug_smiles=DRUG_FILE,
                mol_data_dir=os.path.join(work, "data"), compute_dtype="bfloat16",
                fused_mlp=True, inf_batch_size=SERVE_BATCH, seed=SEED, device="cuda")
            engine = InferenceEngine(cfg, vocab=vocab)
            x, a = next(iter(BatchIterator(engine.data, SERVE_BATCH, seed=cfg.seed)))
            labels[label] = [t.cpu() for t in engine.forward(a, x)]
        want = labels["msgpack"]
        for label, got in labels.items():
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            print(f"   {label}: a batch of {SERVE_BATCH} served, labels bit-equal to the "
                  f"msgpack-loaded engine's: {same}")
            if not same:
                raise AssertionError(f"{label}: labels differ from the msgpack engine's")
        trace_dir = os.path.join(work, "trace")
        with profiling.trace(trace_dir) as prof:
            engine.forward(a, x)
            torch.cuda.synchronize()
        files = os.listdir(trace_dir)
        device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        print(f"   profiling.trace: {files} ({os.path.getsize(os.path.join(trace_dir, files[0])):,} "
              f"bytes); device time of the forward {device_ms:.3f} ms", flush=True)
        if len(files) != 1 or not files[0].endswith(".json"):
            raise AssertionError(f"profiling.trace wrote {files}")
        del engine
    return out


# ---------------------------------------------------------------------------
# phase 15: parallel training, two ranks on the one card
# ---------------------------------------------------------------------------

# the r2_scale config at full width (N 45, dim 128, depth 1, 8 heads,
# mlp_ratio 3, bf16, seed 42, batch 512) on the first PAR_MOLECULES corpus
# molecules: one epoch of PAR_STEPS steps; each child joined within PAR_JOIN_S
PAR_MOLECULES = 2048
PAR_STEPS = PAR_MOLECULES // TRAIN_BATCH
PAR_WORLD = 2
PAR_JOIN_S = 600
PAR_RUNS = (("15a", "--mesh_data 2 --fused_mlp --fused_critic",
             {"mesh_data": 2, "fused_mlp": True, "fused_critic": True}),
            ("15b", "--mesh_node 2 --fused_mlp", {"mesh_node": 2, "fused_mlp": True}),
            ("15c", "--mesh_model 2 --fused_mlp", {"mesh_model": 2, "fused_mlp": True}))
# K1's and K2's device kernels, for the profiler's count (K2: its rows launch)
PAR_KERNELS = {"K1": "tail_fwd_", "K2": "tail_bwd_rows"}
# Each parallel step's parameter change from the start, against the
# single-rank run's, by relative error: the sound runs read 1.3e-2 to
# 1.53e-1 on an H100 (AdamW's first updates are +-lr, and a bf16 sign flip
# of a near-zero gradient moves a weight by 2 lr); a run that leaves its
# state unchanged reads 1.0.
TOL_PAR_UPDATE = 0.4
# 15c's step-1 gradients: its row-parallel layers round each rank's partial
# product to bf16 before the sum, where one card rounds the sum once; the
# sound run reads 1.0e-2 (D) and 6.3e-3 (G) on an H100.  A gradient k-fold
# too large or too small reads >= 0.5.
TOL_PAR_TP_GRAD = 5e-2


def parallel_config(tmp: str, key: str, who: str, **extra):
    """Phase 15's TrainConfig: the published run's, no cadence, one epoch of
    PAR_MOLECULES molecules; ``who`` names the output directories."""
    from druggen_tpu_torch.config import TrainConfig

    sub = os.path.join(tmp, key, who)
    return TrainConfig(
        raw_file=os.path.join(tmp, f"chembl_like_{PAR_MOLECULES}.smi"),
        drug_raw_file=DRUG_FILE, submodel="DrugGEN", batch_size=TRAIN_BATCH, epoch=1,
        compute_dtype="bfloat16", log_sample_step=10 ** 6, set_seed=True, seed=42,
        exp_name="chip_smoke_parallel", mol_data_dir=tmp, drug_data_dir=tmp,
        log_dir=os.path.join(sub, "logs"), sample_dir=os.path.join(sub, "samples"),
        model_save_dir=os.path.join(sub, "models"), device="cuda", **extra)


def record_steps(trainer) -> dict:
    """Wrap ``trainer``'s step and optimizers: per step its CUDA-event ms and
    its global losses (summed over the mesh), and on the writing rank the
    whole gradients (after their sum over the ranks; D's then G's) and
    parameters (G's then D's), gathered where split (collective: every rank
    joins under ``mesh_model``).  The optimizers' hooks keep device copies of
    the gradients; all host copies and gathers come after the step's end
    event.  ``rec["harness"]`` counts the collectives of this recording,
    which are not the trainer's."""
    from druggen_tpu_torch.parallel import mesh as pmesh

    rec = {"ms": [], "losses": [], "grads": [], "params": [],
           "harness": {"calls": 0, "bytes": 0}}
    mesh = trainer.mesh
    keep = trainer.writer or trainer.tp_k > 1
    stash = []

    def whole(model, sd=None):
        return torch.cat([t.reshape(-1).float() for t in trainer._whole(model, sd).values()])

    for opt, model in ((trainer.d_opt, trainer.D), (trainer.g_opt, trainer.G)):
        def hook(flat, inner=opt.grad_hook, opt=opt, model=model):
            flat = inner(flat) if inner is not None else flat
            if keep:
                stash.append((opt, model, flat.clone()))
            return flat
        opt.grad_hook = hook
    step = trainer.step_fn

    def wrapped(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(*args)
        end.record()
        end.synchronize()
        rec["ms"].append(start.elapsed_time(end))
        moved = dict(pmesh.MOVED)
        losses = torch.stack([out["d_loss"].float(), out["g_loss"].float()])
        if trainer.parallel:
            losses = pmesh.all_reduce(losses, mesh.whole) / mesh.size
        rec["losses"].append(losses.tolist())
        grads = [whole(model, opt._unflat(flat)).cpu() for opt, model, flat in stash]
        stash.clear()
        params = (torch.cat([whole(trainer.G), whole(trainer.D)]).cpu()
                  if keep else None)
        if trainer.writer:
            rec["grads"] += grads
            rec["params"].append(params)
        for k in rec["harness"]:
            rec["harness"][k] += pmesh.MOVED[k] - moved[k]
        return out
    trainer.step_fn = wrapped
    rec["step"] = step
    rec["start"] = torch.cat([whole(trainer.G), whole(trainer.D)]).cpu()
    return rec


def parallel_rank(tmp: str) -> None:
    """One rank of phase 15 (spawned; both ranks on cuda:0 under a gloo
    group): the trainer at each of PAR_RUNS, then ``dryrun_multichip``."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    rank, world = dist.get_rank(), dist.get_world_size()
    from druggen_tpu_torch.chem.vocab import Vocab
    from druggen_tpu_torch.data.dataset import BatchIterator
    from druggen_tpu_torch.entry import dryrun_multichip
    from druggen_tpu_torch.ops.fused_mlp import fused_ln_mlp_ln, fused_ln_mlp_ln_bwd
    from druggen_tpu_torch.parallel import edge_partition as ep
    from druggen_tpu_torch.parallel import mesh as pmesh
    from druggen_tpu_torch.train.trainer import Trainer

    with open(TRAIN_VOCAB_JSON) as f:
        vocab = Vocab.from_json(f.read())
    out = {"backend": dist.get_backend()}
    for key, _, extra in PAR_RUNS:
        t0 = time.perf_counter()
        tr = Trainer(parallel_config(tmp, key, f"rank{rank}", **extra), vocab=vocab)
        setup = time.perf_counter() - t0
        rec = record_steps(tr)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in (fused_ln_mlp_ln, fused_ln_mlp_ln_bwd):
            fn.launches = 0
        moved = dict(pmesh.MOVED)
        t0 = time.perf_counter()
        tr.train()
        wall = time.perf_counter() - t0
        launches = {"fused_ln_mlp_ln_fwd": fused_ln_mlp_ln.launches,
                    "fused_ln_mlp_ln_bwd": fused_ln_mlp_ln_bwd.launches}
        # the trainer's own collectives (the recording's taken out)
        calls = pmesh.MOVED["calls"] - moved["calls"] - rec["harness"]["calls"]
        nbytes = pmesh.MOVED["bytes"] - moved["bytes"] - rec["harness"]["bytes"]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        # one more step, under the profiler on rank 0: K1/K2 device launches
        x, a = next(BatchIterator(tr.data, TRAIN_BATCH, seed=42).epoch_batches(0))
        batch = (ep.shard_train_inputs(tr.mesh, x, a, x, a) if tr.node_k > 1
                 else pmesh.shard_batch(tr.mesh, x, a, x, a))
        batch = [t.copy() for t in batch]
        # (one step on both ranks: a second profile on rank 0 alone would
        # leave rank 1 out of its collectives)
        counts = None
        if rank == 0:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                rec["step"](*batch)
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            counts = {k: sum(e.count for e in events if pat in e.key)
                      for k, pat in PAR_KERNELS.items()}
            counts["device_time"] = bool(events)
        else:
            rec["step"](*batch)
            torch.cuda.synchronize()
        out[key] = {"setup_s": setup, "wall_s": wall, "launches": launches,
                    "ms": rec["ms"], "losses": rec["losses"], "peak_gib": peak,
                    "collective_calls": calls, "collective_bytes": nbytes,
                    "profiled": counts, "vertexes": tr.vertexes, "mesh": tr.mesh.shape,
                    "model_dir": tr.model_dir,
                    "written": sorted(os.listdir(tr.model_dir))
                    if os.path.isdir(tr.model_dir) else None}
        if rank == 0:
            out[key]["grads"] = rec["grads"][:2 * PAR_STEPS]
            out[key]["params"] = rec["params"][:PAR_STEPS]
        # the recording's hooks hold the trainer in reference cycles: free it
        # before the next run's
        del tr, rec, batch
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dryrun_multichip(world, device="cuda")
    out["dryrun_s"] = time.perf_counter() - t0
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def parallel_training(name: str, smi_line: str) -> dict:
    """Phase 15: the parallel modes on the one card.  Two ranks share cuda:0
    under a gloo group this phase starts (gloo is the backend that takes two
    ranks on one device; it carries CUDA tensors through host memory, by
    broadcast and all_reduce).  Each of PAR_RUNS trains PAR_STEPS steps from
    the published config's start; every rank's losses, rank 0's gradients and
    parameters after each step are held to a single-rank run of the same
    steps from the same state on the same (padded) data (TOL_STEP); K1/K2
    launches counted per rank (wrappers; the profiler on one more step); K1/K2
    at 15b's block shape against their plain versions; rank 0's export served
    back.  Then ``dryrun_multichip(2)`` on the two ranks."""
    from druggen_tpu_torch.chem.vocab import Vocab
    from druggen_tpu_torch.config import InferenceConfig
    from druggen_tpu_torch.data.dataset import load_dataset, pad_vertices
    from druggen_tpu_torch.infer.engine import InferenceEngine
    from druggen_tpu_torch.parallel.mesh import spawn
    from druggen_tpu_torch.ops.fused_mlp import (
        fused_ln_mlp_ln,
        fused_ln_mlp_ln_bwd,
        fused_ln_mlp_ln_bwd_reference,
        fused_ln_mlp_ln_reference,
        witness_kink_flips,
    )
    from druggen_tpu_torch.train.trainer import Trainer

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_")
    raw = os.path.join(tmp.name, f"chembl_like_{PAR_MOLECULES}.smi")
    with open(SMILES_FILE) as src, open(raw, "w") as dst:
        for _, line in zip(range(PAR_MOLECULES), src):
            dst.write(line)
    with open(TRAIN_VOCAB_JSON) as f:
        vocab = Vocab.from_json(f.read())
    print(f"   {PAR_WORLD} ranks on cuda:0 under gloo; {PAR_STEPS} steps of batch "
          f"{TRAIN_BATCH} (bf16, dim {DIM}, N {N_ATOMS}, seed 42) on the first "
          f"{PAR_MOLECULES} corpus molecules a run.  Two ranks sharing one card over host "
          f"transport measure no scaling: the times below are not a scaling result.",
          flush=True)
    # the ranks share the card with this process: hand them what it caches
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"   this process holds {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
          f"({torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved); free for the "
          f"ranks {free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} GiB", flush=True)
    t0 = time.perf_counter()
    spawn(parallel_rank, PAR_WORLD, tmp.name, timeout=PAR_JOIN_S)
    ranks = [torch.load(os.path.join(tmp.name, f"rank{r}.pt"), weights_only=False)
             for r in range(PAR_WORLD)]
    print(f"   the ranks ran in {time.perf_counter() - t0:.2f} s (spawn included); "
          f"backend {ranks[0]['backend']}; dryrun_multichip({PAR_WORLD}) on the card "
          f"{ranks[0]['dryrun_s']:.2f} s", flush=True)

    tol = TOL_STEP[torch.bfloat16]
    results = {}
    for key, label, extra in PAR_RUNS:
        runs = [r[key] for r in ranks]
        # the single-rank run: the same config without the mesh, the same
        # (padded) data
        cfg = parallel_config(tmp.name, key, "single", **{
            k: v for k, v in extra.items() if not k.startswith("mesh_")})
        data = drug = None
        if runs[0]["vertexes"] != N_ATOMS:
            data, drug = (pad_vertices(load_dataset(path, vocab, N_ATOMS, tmp.name),
                                       runs[0]["vertexes"])
                          for path in (cfg.raw_file, cfg.drug_raw_file))
        ref_tr = Trainer(cfg, vocab=vocab, data=data, drug_data=drug)
        ref = record_steps(ref_tr)
        ref_tr.train()
        steps = len(ref["losses"])
        loss_err = max(abs(g - w) / max(1.0, abs(w))
                       for run in runs for got, want in zip(run["losses"], ref["losses"])
                       for g, w in zip(got, want))
        grad_err = [rel_err(g, w) for g, w in zip(runs[0]["grads"], ref["grads"])]
        par, single, start = runs[0]["params"], ref["params"], ref["start"]
        param_err = [rel_err(p, q) for p, q in zip(par, single)]
        update_err = [rel_err(p - start, q - start) for p, q in zip(par, single)]
        # 15c's row-parallel sums round twice in bf16 (TOL_PAR_TP_GRAD)
        grad_tol = TOL_PAR_TP_GRAD if key == "15c" else tol
        # K1 and K2: G's edge tail (depth 1) a step; the critic's one block
        # skips its edge tail, and 15b/15c run the critic plain
        expect = {"fused_ln_mlp_ln_fwd": steps, "fused_ln_mlp_ln_bwd": steps}
        print(f"   {key} {label}: mesh {runs[0]['mesh']}, N {runs[0]['vertexes']}; "
              f"set-up {runs[0]['setup_s']:.2f} s, {steps} steps in {runs[0]['wall_s']:.2f} s "
              f"(rank 0)", flush=True)
        for r, run in enumerate(runs):
            ms = statistics.median(run["ms"][1:])
            print(f"   {key} rank {r} on {name} ({smi_line}): step {ms:.2f} ms (CUDA "
                  f"events, median of steps 2-{steps}; by step "
                  f"{[round(m, 2) for m in run['ms']]}); peak memory {run['peak_gib']:.2f} "
                  f"GiB; backend {ranks[r]['backend']}; collectives a step "
                  f"{run['collective_calls'] / steps:.1f} calls, "
                  f"{run['collective_bytes'] / steps / 2 ** 20:.1f} MiB payload; K1/K2 "
                  f"launches {run['launches']} (expected {expect}); losses "
                  f"{[[round(v, 4) for v in pair] for pair in run['losses']]}", flush=True)
            if run["launches"] != expect:
                raise AssertionError(f"{key} rank {r}: K1/K2 launches {run['launches']}, "
                                     f"expected {expect}")
            if len(run["losses"]) != steps or not all(
                    math.isfinite(v) for pair in run["losses"] for v in pair):
                raise AssertionError(f"{key} rank {r}: losses {run['losses']}")
        prof = runs[0]["profiled"]
        print(f"   {key} one more step under the profiler on rank 0: device launches "
              f"{prof} (expected K1 1, K2 1)", flush=True)
        if not prof or not prof["device_time"]:
            raise AssertionError(f"{key}: the profiled step recorded no device events")
        if (prof["K1"], prof["K2"]) != (1, 1):
            raise AssertionError(f"{key}: the profiler counted {prof}")
        print(f"   {key} against the single-rank run ({ref_tr.mesh.shape}, losses "
              f"{[[round(v, 4) for v in pair] for pair in ref['losses']]}): losses "
              f"(every rank) max relative error {loss_err:.3e}; rank 0's gradients (D, G "
              f"by step) {[f'{e:.2e}' for e in grad_err]}; parameters "
              f"{[f'{e:.2e}' for e in param_err]}; their change from the start "
              f"{[f'{e:.2e}' for e in update_err]} [TOL_STEP {tol}: the losses and the "
              f"parameters; step 1's gradients at {grad_tol}; the change from the start "
              f"at TOL_PAR_UPDATE {TOL_PAR_UPDATE} (an unchanged state reads 1.0); from "
              f"step 2 the states differ: AdamW's first updates are ±lr, and a near-zero "
              f"gradient of the other sign in bf16 flips one]", flush=True)
        if (len(runs[0]["grads"]) != 2 * steps or len(par) != steps or loss_err > tol
                or max(grad_err[:2]) > grad_tol or max(param_err) > tol
                or max(update_err) > TOL_PAR_UPDATE):
            raise AssertionError(f"{key}: the parallel run is away from the single-rank "
                                 f"one: losses {loss_err}, gradients {grad_err}, "
                                 f"parameters {param_err}, updates {update_err}")
        written = runs[0]["written"]
        if runs[1]["written"] is not None or "DrugGEN-G.ckpt" not in (written or []):
            raise AssertionError(f"{key}: rank 0 wrote {written}, rank 1 "
                                 f"{runs[1]['written']}")
        inf = InferenceConfig(
            submodel="DrugGEN", inference_model=runs[0]["model_dir"],
            sample_num=TRAIN_BATCH, disable_correction=True, inf_smiles=raw,
            train_smiles=raw, train_drug_smiles=DRUG_FILE, inf_batch_size=TRAIN_BATCH,
            inf_max_batches=1, mol_data_dir=tmp.name,
            output_dir=os.path.join(tmp.name, key, "inf"), compute_dtype="bfloat16",
            fused_mlp=True, device="cuda")
        engine = InferenceEngine(inf, vocab=vocab)
        kept, decoded, _, _ = engine.sample(max_batches=1)
        print(f"   {key} rank 0 wrote {written}; its DrugGEN-G.ckpt served: "
              f"{len(decoded)} graphs, {len(kept)} valid", flush=True)
        if len(decoded) != TRAIN_BATCH:
            raise AssertionError(f"{key}: rank 0's export did not serve")
        del engine, ref_tr
        results[key] = {"launches": runs[0]["launches"],
                        "launches_by_rank": [run["launches"] for run in runs],
                        "step_ms": [statistics.median(run["ms"][1:]) for run in runs],
                        "loss_err": loss_err, "grad_err": grad_err,
                        "param_err": max(param_err), "update_err": max(update_err)}

    # K1/K2 at 15b's block shape: the rank's [B/dp, N/np, N, dim] edge rows
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = tail_params(gen, "cuda")
    n_pad = -(-N_ATOMS // 2) * 2
    rows = TRAIN_BATCH * (n_pad // 2) * n_pad
    print(f"   K1/K2 at 15b's block ({TRAIN_BATCH} x {n_pad // 2} x {n_pad} = {rows:,} rows):",
          flush=True)
    results["block_k1"] = check_kernel(fused_ln_mlp_ln, fused_ln_mlp_ln_reference, params,
                                       rows, torch.bfloat16, gen)
    results["block_k2"] = check_bwd_kernel(fused_ln_mlp_ln_bwd,
                                           fused_ln_mlp_ln_bwd_reference,
                                           witness_kink_flips, params, rows,
                                           torch.bfloat16, gen)
    tmp.cleanup()
    return results


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    sys.path.insert(0, REPO)
    from druggen_tpu_torch.chem.vocab import Vocab
    from druggen_tpu_torch.config import InferenceConfig
    from druggen_tpu_torch.data.dataset import BatchIterator, load_dataset
    from druggen_tpu_torch.infer.engine import InferenceEngine
    from druggen_tpu_torch.interop.msgpack_ckpt import read_flax_checkpoint
    from druggen_tpu_torch.interop.weights import flax_generator_to_torch, to_torch_tensors
    from druggen_tpu_torch.models import Generator
    from druggen_tpu_torch.ops import _build
    from druggen_tpu_torch.ops import fused_attention as fa
    from druggen_tpu_torch.ops import fused_block as fb
    from druggen_tpu_torch.ops import fused_generator as fg
    from druggen_tpu_torch.ops.fused_mlp import (
        _bwd_lib,
        _kernel_lib,
        fused_ln_mlp_ln,
        fused_ln_mlp_ln_bwd,
        fused_ln_mlp_ln_bwd_reference,
        fused_ln_mlp_ln_reference,
        launch_plan,
        num_sms,
        witness_kink_flips,
    )

    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 stays f32
    torch.backends.cudnn.allow_tf32 = False

    with phase("1 device"):
        name = torch.cuda.get_device_name(0)
        smi_line = nvidia_smi_line()
        print(f"   torch {torch.__version__} cuda {torch.version.cuda}; "
              f"{name}; device count {torch.cuda.device_count()}")
        print(smi_line, flush=True)

    with phase("2 build"):
        with ThreadPoolExecutor(len(KERNEL_BUILDS)) as pool:
            builds = list(pool.map(lambda sd: _build.build(*sd), KERNEL_BUILDS))
        for (src, defines), b in zip(KERNEL_BUILDS, builds):
            print(f"   {src}.cu {defines}: {b.seconds:.2f} s"
                  f"{' (cached)' if b.cached else ''}")
            for line in b.log.splitlines():
                if "registers" in line or "Compiling entry" in line or "spill" in line:
                    print(f"   {line.strip()}")
        for c, h in ((DIM, HIDDEN), (NARROW_DIM, NARROW_HIDDEN), (DIM, WIDE_HIDDEN),
                     (SPLIT_DIM, SPLIT_HIDDEN)):
            lib, blib = _kernel_lib(c, h), _bwd_lib(c, h)
            plan = launch_plan(c, h, ROWS, num_sms(0))
            sizes = (lib.fused_ln_mlp_ln_fwd_smem_bytes(1),
                     blib.fused_ln_mlp_ln_bwd_smem_bytes(1),
                     blib.fused_ln_mlp_ln_bwd_wgrad_smem_bytes(1))
            staged = (lib.fused_ln_mlp_ln_fwd_stages_weights(1),
                      blib.fused_ln_mlp_ln_bwd_stages_weights(1))
            if (sizes != (plan.fwd_smem, plan.rows_smem, plan.wgrad_smem)
                    or staged != (plan.fwd_staged, plan.rows_staged)):
                raise AssertionError(f"launch_plan({c}, {h}) disagrees with the library: "
                                     f"{sizes} {staged} vs {plan}")
            if plan.split != bool(lib.fused_ln_mlp_ln_split()):
                raise AssertionError(f"launch_plan({c}, {h}) and the library take "
                                     f"different paths")
            print(f"   fused_mlp C {c} H {h} bf16 (launch plan = library): dynamic shared "
                  f"memory K1 {sizes[0]} B, K2 rows pass {sizes[1]} B, wgrad "
                  f"{sizes[2]} B a block; "
                  + ("split path (row kernels and wgmma GEMMs; the largest GEMM block "
                     "above); " if plan.split else
                     f"weights {'staged' if all(staged) else 'streamed through a TMA ring'}; ")
                  + 
                  f"{plan.warpgroups} warpgroups of {plan.tile_rows}-row tiles, grid "
                  f"{plan.grid}; wgrad {plan.wgrad_warpgroups} warpgroups of 64 x "
                  f"{plan.wgrad_tile_n}, grid {plan.wgrad_grid}; K2 scratch "
                  f"{plan.scratch_bytes / 1e9:.3f} GB at {ROWS:,} rows")
            print(f"   fused_mlp C {c} H {h} f32: dynamic shared memory K1 "
                  f"{lib.fused_ln_mlp_ln_fwd_smem_bytes(0)} B, K2 rows pass "
                  f"{blib.fused_ln_mlp_ln_bwd_smem_bytes(0)} B a block; weights read "
                  f"through L2")
        alib, ablib = fa._fwd_lib(), fa._bwd_lib()
        aplan = fa.launch_plan(DIM, TRAIN_BATCH, N_ATOMS, num_sms(0))
        alibp = fa.library_plan()
        if (not aplan.hopper or (alibp["wgrad_tiles"], alibp["wgrad_rows"])
                != (aplan.wgrad_tiles, fa.WGRAD_ROWS)
                or max(alibp["fwd_smem"], alibp["rows_smem"], alibp["wgrad_smem"])
                > fa.SMEM_LIMIT):
            raise AssertionError(f"fused_attention launch_plan disagrees with the library: "
                                 f"{aplan} vs {alibp}")
        print(f"   fused_attention D {DIM} bf16, Hopper route: dynamic shared memory (the "
              f"library's) K5 {alibp['fwd_smem']} B, K6 rows pass {alibp['rows_smem']} B, "
              f"wgrad {alibp['wgrad_smem']} B; grid {aplan.grid}; "
              f"64-row slab tiles, {aplan.pad_share:.3f} of their rows padding at N "
              f"{N_ATOMS}; two warpgroups a block; K6 stats and node passes "
              f"{aplan.pair_blocks} blocks each; wgrad "
              f"{aplan.wgrad_tiles} tiles x {aplan.chunks} row chunks; K6 scratch "
              f"{aplan.scratch_bytes / 1e9:.3f} GB at B {TRAIN_BATCH}")
        print(f"   fused_attention CUDA-core route (f32; bf16 at other D or N > 64): "
              f"dynamic shared memory at N {N_ATOMS}, D {DIM}: K5 "
              f"{alib.edge_attention_fwd_smem_bytes(N_ATOMS, DIM)} B, K6 rows pass "
              f"{ablib.edge_attention_bwd_smem_bytes(N_ATOMS)} B a block")
        for kernel, (b, n, d), dtype in [(k, shape, dt) for k in ("fwd", "bwd")
                                         for shape, dts in V2_SHAPES for dt in dts]:
            vplan = fa.v2_launch_plan(kernel, b, n, d, dtype, num_sms(0))
            vlib = fa.v2_library_plan(kernel, n, dtype, vplan.stages)
            if ((vlib["smem_bytes"], vlib["kpt"]) != (vplan.smem_bytes, vplan.kpt)
                    or vlib["resident_blocks"] < vplan.blocks_per_sm
                    or fa.v2_library_item_range(vplan.items, vplan.grid, vplan.grid - 1)
                    != vplan.item_range(vplan.grid - 1)):
                raise AssertionError(f"v2_launch_plan disagrees with the library: {vplan} vs "
                                     f"{vlib}")
            print(f"   fused_attention_v2 {'K3' if kernel == 'fwd' else 'K4'} B {b} N {n} D {d} "
                  f"{str(dtype)[6:]} (plan = library): {vplan.width}-channel items, "
                  f"{vplan.width // 8} consumer warps and a producer, {vplan.smem_bytes} B a block, "
                  f"{vplan.stages} ring slots, {vplan.kpt} keys a thread, "
                  f"{vplan.blocks_per_sm} block(s) a SM (the runtime keeps "
                  f"{vlib['resident_blocks']}), grid {vplan.grid} over {vplan.items} items",
                  flush=True)
        for c, h in ((DIM, HIDDEN), (BLOCK_WIDE_DIM, BLOCK_WIDE_HIDDEN)):
            bplan = fb.launch_plan(c, h, TRAIN_BATCH, N_ATOMS, num_sms(0))
            blib = fb.library_plan(c, h)
            if bplan.hopper:
                if (blib["wgrad_tiles"] != bplan.wgrad_tiles
                        or max(blib["fwd_smem"], blib["rows_smem"], blib["wgrad_smem"])
                        > fb.SMEM_LIMIT):
                    raise AssertionError(f"fused_block launch_plan({c}, {h}) disagrees with "
                                         f"the library: {bplan} vs {blib}")
                print(f"   fused_block C {c} H {h} bf16, Hopper route: dynamic shared memory "
                      f"(the library's) K7 {blib['fwd_smem']} B, K8 rows launches "
                      f"{blib['rows_smem']} B, wgrad {blib['wgrad_smem']} B; one warpgroup a "
                      f"block, grid {bplan.grid}; 64-row slab tiles, {bplan.pad_share:.3f} of "
                      f"their rows padding at N {N_ATOMS}; wgrad {bplan.wgrad_tiles} tiles x "
                      f"{bplan.chunks} row chunks; K8 scratch {bplan.scratch_bytes / 1e9:.3f} "
                      f"GB at B {TRAIN_BATCH}", flush=True)
            print(f"   fused_block C {c} H {h} CUDA-core route (f32; bf16 where the Hopper "
                  f"route does not take the shape): dynamic shared memory at N {N_ATOMS}: K7 "
                  f"bf16 {fb._fwd_lib(c, h).fused_block_fwd_smem_bytes(N_ATOMS, 1)} B, "
                  f"f32 {fb._fwd_lib(c, h).fused_block_fwd_smem_bytes(N_ATOMS, 0)} B; K8 "
                  f"rows pass {fb._bwd_lib(c, h).fused_block_bwd_smem_bytes()} B a block",
                  flush=True)
        for c, h in K9_WIDTHS:
            lib = fg._kernel_lib(c, h)
            print(f"   fused_generator C {c} H {h} dynamic shared memory at N {N_ATOMS} "
                  f"(m_dim 8, b_dim 5), the larger of its node and edge blocks: bf16 "
                  f"{lib.fused_generator_smem_bytes(N_ATOMS, 8, 5, 1)} B, f32 "
                  f"{lib.fused_generator_smem_bytes(N_ATOMS, 8, 5, 0)} B", flush=True)
        gplan = fg.launch_plan(DIM, HIDDEN, SERVE_BATCH, N_ATOMS, 1, num_sms(0))
        glib = fg.library_plan(DIM, HIDDEN, N_ATOMS, 8)
        if (not glib["route"] or not fg.hopper_route(N_ATOMS, DIM, HIDDEN, torch.bfloat16, 5)
                or glib["tail_smem"] <= launch_plan(DIM, HIDDEN, ROWS, num_sms(0)).fwd_smem
                or max(glib["node_smem"], glib["attn_smem"], glib["tail_smem"])
                > fg.SMEM_LIMIT):
            raise AssertionError(f"fused_generator Hopper route: launch_plan / hopper_route "
                                 f"disagree with the library: {gplan} vs {glib}")
        print(f"   fused_generator C {DIM} H {HIDDEN} bf16, Hopper route (the libraries' "
              f"shared memory): node pass {glib['node_smem']} B ({gplan.node_blocks} blocks), "
              f"edge attention {glib['attn_smem']} B (grid {gplan.attn_grid}, two warpgroups, "
              f"64-row slab tiles, {1 - N_ATOMS / fg.TILE_ROWS:.3f} of their rows padding at N "
              f"{N_ATOMS}), edge tail {glib['tail_smem']} B (K1's layout and the edge "
              f"readout's weights: grid {gplan.tail_grid}, "
              f"{gplan.tiles} flat 64-row tiles); the plan's {gplan.device_launches} device "
              f"launches a forward at depth 1 (phase 7 counts them); scratch at B {SERVE_BATCH}: node "
              f"{gplan.node_scratch_bytes / 2 ** 20:.1f} MiB, edge "
              f"{gplan.edge_scratch_bytes / 2 ** 30:.3f} GiB", flush=True)

    counted = {"fused_ln_mlp_ln_fwd": fused_ln_mlp_ln,
               "fused_ln_mlp_ln_bwd": fused_ln_mlp_ln_bwd,
               "edge_attention_fwd": fa.edge_attention_fwd,
               "edge_attention_bwd": fa.edge_attention_bwd,
               "fused_block_fwd": fb.fused_block_fwd,
               "fused_block_bwd": fb.fused_block_bwd}
    # the serving paths' kernels beside the training paths' (which count
    # only the first six)
    counted_all = {**counted, "fused_generator_logits": fg.fused_generator_logits,
                   "edge_attention_v2_fwd": fa.edge_attention_v2_fwd,
                   "edge_attention_v2_bwd": fa.edge_attention_v2_bwd}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = tail_params(gen, "cuda")
    # the serving corpus: the first molecules of the corpus, featurised once
    # (the engines below read the cache)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    inf_smi = os.path.join(tmp.name, f"chembl_like_{SERVE_MOLECULES}.smi")
    with open(SMILES_FILE) as src, open(inf_smi, "w") as dst:
        for _, line in zip(range(SERVE_MOLECULES), src):
            dst.write(line)
    with open(VOCAB_JSON) as f:
        vocab = Vocab.from_json(f.read())
    with phase("3 kernels vs plain"):
        k1 = check_kernel(fused_ln_mlp_ln, fused_ln_mlp_ln_reference, params,
                          ROWS, torch.bfloat16, gen)
        check_kernel(fused_ln_mlp_ln, fused_ln_mlp_ln_reference, params,
                     ROWS, torch.float32, gen)
        for dtype in (torch.bfloat16, torch.float32):
            check_kernel(fused_ln_mlp_ln, fused_ln_mlp_ln_reference, params,
                         RAGGED_ROWS, dtype, gen)
        k2_check = (fused_ln_mlp_ln_bwd, fused_ln_mlp_ln_bwd_reference,
                    witness_kink_flips, params)
        k2 = check_bwd_kernel(*k2_check, ROWS, torch.bfloat16, gen)
        check_bwd_kernel(*k2_check, ROWS, torch.float32, gen)
        for dtype in (torch.bfloat16, torch.float32):
            check_bwd_kernel(*k2_check, RAGGED_ROWS, dtype, gen)
        # K1/K2 built for dim 64, mlp_ratio 3 (a ragged row count)
        narrow = tail_params(gen, "cuda", NARROW_DIM, NARROW_HIDDEN)
        for dtype in (torch.bfloat16, torch.float32):
            check_kernel(fused_ln_mlp_ln, fused_ln_mlp_ln_reference, narrow,
                         NARROW_ROWS, dtype, gen)
            check_bwd_kernel(fused_ln_mlp_ln_bwd, fused_ln_mlp_ln_bwd_reference,
                             witness_kink_flips, narrow, NARROW_ROWS, dtype, gen)
        # K1/K2 at dim 128 with mlp_ratio 4: the weights streamed from L2
        wide = tail_params(gen, "cuda", DIM, WIDE_HIDDEN)
        k1w = check_kernel(fused_ln_mlp_ln, fused_ln_mlp_ln_reference, wide, ROWS,
                           torch.bfloat16, gen, rtol=TOL_BF16_WIDE_RTOL)
        k2w = check_bwd_kernel(fused_ln_mlp_ln_bwd, fused_ln_mlp_ln_bwd_reference,
                               witness_kink_flips, wide, ROWS, torch.bfloat16, gen)
        for dtype in (torch.bfloat16, torch.float32):
            check_kernel(fused_ln_mlp_ln, fused_ln_mlp_ln_reference, wide, NARROW_ROWS,
                         dtype, gen, rtol=TOL_BF16_WIDE_RTOL)
            check_bwd_kernel(fused_ln_mlp_ln_bwd, fused_ln_mlp_ln_bwd_reference,
                             witness_kink_flips, wide, NARROW_ROWS, dtype, gen)
        # K1/K2 at dim 512: the split path
        split_p = tail_params(gen, "cuda", SPLIT_DIM, SPLIT_HIDDEN)
        k1x = check_kernel(fused_ln_mlp_ln, fused_ln_mlp_ln_reference, split_p, NARROW_ROWS,
                           torch.bfloat16, gen, rtol=TOL_BF16_WIDE_RTOL)
        k2x = check_bwd_kernel(fused_ln_mlp_ln_bwd, fused_ln_mlp_ln_bwd_reference,
                               witness_kink_flips, split_p, NARROW_ROWS, torch.bfloat16, gen)
        torch.cuda.empty_cache()
        attn_checks = {}
        for b, n, d in ATTN_SHAPES:
            for dtype in (torch.bfloat16, torch.float32):
                attn_checks[(b, n, d, dtype)] = check_attn_kernels(
                    fa, b, n, d, dtype, gen,
                    twice=(b, n, d, dtype) == (TRAIN_BATCH, N_ATOMS, DIM, torch.bfloat16))
                torch.cuda.empty_cache()
        k56 = attn_checks[(TRAIN_BATCH, N_ATOMS, DIM, torch.bfloat16)]
        block_checks = {}
        for b, n, d, h in BLOCK_SHAPES:
            for dtype in (torch.bfloat16, torch.float32):
                block_checks[(b, n, d, dtype)] = check_block_kernels(
                    fb, b, n, d, h, dtype, gen,
                    twice=(b, n, d, dtype) == (TRAIN_BATCH, N_ATOMS, DIM, torch.bfloat16))
                torch.cuda.empty_cache()
        k78 = block_checks[(TRAIN_BATCH, N_ATOMS, DIM, torch.bfloat16)]
        torch.cuda.empty_cache()
        # K9: the trained r2_scale weights on corpus one-hots at the serving
        # shape; random weights at N 13 / depth 2 at each width, and at N 45
        # / depth 1 at the other widths
        t0 = time.perf_counter()
        corpus = load_dataset(inf_smi, vocab, N_ATOMS, tmp.name)
        print(f"   featurise {len(corpus)} corpus molecules: {time.perf_counter() - t0:.2f} s")
        xs, as_ = next(iter(BatchIterator(corpus, SERVE_BATCH, seed=SEED)))
        z_e = F.one_hot(torch.as_tensor(as_).long().cuda(), vocab.b_dim).float()
        z_n = F.one_hot(torch.as_tensor(xs).long().cuda(), vocab.m_dim).float()
        trained = fg.GeneratorWeights(*fg.extract_generator_weights(to_torch_tensors(
            flax_generator_to_torch(read_flax_checkpoint(
                os.path.join(CKPT_DIR, "DrugGEN-G.ckpt"))))))
        k9_checks = {}
        for dtype in (torch.bfloat16, torch.float32):
            k9_checks[dtype] = check_generator_kernel(
                fg, trained, z_e, z_n, dtype, "trained r2_scale, corpus", labels_held=True)
        for (c, h), (b, n, depth) in [(w, K9_SMALL) for w in K9_WIDTHS] + [
                (w, (K9_SMALL[0], N_ATOMS, 1)) for w in K9_WIDTHS[1:]]:
            gw = fg.GeneratorWeights.of(Generator(
                act="relu", vertexes=n, edges=vocab.b_dim, nodes=vocab.m_dim, dropout=0.0,
                dim=c, depth=depth, heads=HEADS, mlp_ratio=h // c,
                generator=torch.Generator().manual_seed(SEED)))
            ze_r, zn_r = symmetric_onehots(b, n, vocab.m_dim, vocab.b_dim, gen)
            for dtype in (torch.bfloat16, torch.float32):
                check_generator_kernel(fg, gw, ze_r, zn_r, dtype, "random", labels_held=False)
        k9 = k9_checks[torch.bfloat16]
        # the generic bf16 kernels at the published width, which serve N > 64
        # and b_dim > 7: held at the serving shape as before the route
        with generic_kernels(fg):
            check_generator_kernel(fg, trained, z_e, z_n, torch.bfloat16,
                                   "trained r2_scale, corpus, generic kernels",
                                   labels_held=True)
        # the Hopper route's launches, each against its plain stage: the
        # serving shape (trained weights) and K9_SMALL (random, depth 2)
        k9_launch_errs = check_generator_launches(fg, trained, z_e, z_n,
                                                  "trained r2_scale, corpus")
        small = fg.GeneratorWeights.of(Generator(
            act="relu", vertexes=K9_SMALL[1], edges=vocab.b_dim, nodes=vocab.m_dim,
            dropout=0.0, dim=DIM, depth=K9_SMALL[2], heads=HEADS, mlp_ratio=HIDDEN // DIM,
            generator=torch.Generator().manual_seed(SEED + 1)))
        check_generator_launches(fg, small, *symmetric_onehots(
            K9_SMALL[0], K9_SMALL[1], vocab.m_dim, vocab.b_dim, gen), "random")
        torch.cuda.empty_cache()
        v2_checks = {}
        for (b, n, d), dtypes in V2_SHAPES:
            for dtype in dtypes:
                v2_checks[(b, n, d, dtype)] = check_v2_kernels(
                    fa, b, n, d, dtype, gen,
                    twice=(b, n, d, dtype) == (TRAIN_BATCH, N_ATOMS, DIM, torch.bfloat16))
                torch.cuda.empty_cache()
        k34 = v2_checks[(TRAIN_BATCH, N_ATOMS, DIM, torch.bfloat16)]

    with phase("4 serving"):
        cfg = InferenceConfig(
            submodel="DrugGEN", inference_model=CKPT_DIR,
            sample_num=SERVE_BATCH * SERVE_BATCHES, disable_correction=True,
            inf_smiles=inf_smi, train_smiles=inf_smi, train_drug_smiles=inf_smi,
            inf_batch_size=SERVE_BATCH, inf_max_batches=SERVE_BATCHES,
            mol_data_dir=tmp.name, output_dir=os.path.join(tmp.name, "out"),
            compute_dtype="bfloat16", fused_mlp=True, device="cuda")
        t0 = time.perf_counter()
        engine = InferenceEngine(cfg, vocab=vocab)
        print(f"   engine set-up (featurise {len(engine.data)} molecules, "
              f"read checkpoint): {time.perf_counter() - t0:.2f} s")

        for fn in counted_all.values():
            fn.launches = 0
        results = engine.run()
        launches = {key: fn.launches for key, fn in counted_all.items()}

        n_batches = len(engine.timings)
        expected = cfg.depth * n_batches
        print(f"   launches: {launches} over {n_batches} batches "
              f"(expected depth x batches = {expected} forwards, no backward)")
        if n_batches != SERVE_BATCHES or launches["fused_ln_mlp_ln_fwd"] != expected:
            raise AssertionError("the serving run did not go through the "
                                 "fused kernel once per block per batch")
        if any(n_ for k, n_ in launches.items() if k != "fused_ln_mlp_ln_fwd"):
            raise AssertionError("the serving run launched a kernel off its path")
        with open(os.path.join(cfg.output_dir, cfg.submodel,
                               "inference_drugs.csv")) as f:
            smiles = [row["SMILES"] for row in csv.DictReader(f)]
        if not smiles:
            raise AssertionError("the trained generator produced no valid molecule")
        print(f"   validity {results['validity']}, generator_validity "
              f"{results['generator_validity']}, uniqueness "
              f"{results['uniqueness']}, {len(smiles)} molecules")
        print(f"   e.g. {smiles[:3]}")
        fwd = [t["forward_s"] for t in engine.timings]
        dec = [t["decode_s"] for t in engine.timings]
        graphs = SERVE_BATCH * n_batches
        steady = SERVE_BATCH / statistics.median(fwd[1:])
        print(f"   forward windows (s): {[round(x, 4) for x in fwd]}; "
              f"decode (s): {[round(x, 3) for x in dec]}")
        print(f"   serving rate on {name} ({smi_line}): device path "
              f"{steady:.1f} graphs/s (median window of batches 2-{n_batches}); "
              f"end to end "
              f"with host decode {graphs / (sum(fwd) + sum(dec)):.1f} "
              f"molecules/s (all batches)", flush=True)

    with phase("4u serving with use_pallas"):
        cfg_p = dataclasses.replace(cfg, use_pallas=True,
                                    output_dir=os.path.join(tmp.name, "out_pallas"))
        t0 = time.perf_counter()
        engine_p = InferenceEngine(cfg_p, vocab=vocab)
        print(f"   engine set-up: {time.perf_counter() - t0:.2f} s")
        for fn in counted_all.values():
            fn.launches = 0
        results_p = engine_p.run()
        launches_p = {key: fn.launches for key, fn in counted_all.items()}
        n_batches = len(engine_p.timings)
        print(f"   launches: {launches_p} over {n_batches} batches (expected one K9 a "
              f"forward, {3 * cfg.depth + 1} device launches each on the Hopper route, and no "
              f"other kernel)")
        if n_batches != SERVE_BATCHES or launches_p["fused_generator_logits"] != n_batches:
            raise AssertionError("the use_pallas serving run did not go through K9 once "
                                 "per batch")
        if any(n_ for k, n_ in launches_p.items() if k != "fused_generator_logits"):
            raise AssertionError("the use_pallas serving run launched another kernel")
        with open(os.path.join(cfg_p.output_dir, cfg_p.submodel, "inference_drugs.csv")) as f:
            smiles_p = [row["SMILES"] for row in csv.DictReader(f)]
        if not smiles_p:
            raise AssertionError("the use_pallas generator produced no valid molecule")
        print(f"   validity {results_p['validity']}, generator_validity "
              f"{results_p['generator_validity']}, uniqueness {results_p['uniqueness']}, "
              f"{len(smiles_p)} molecules; e.g. {smiles_p[:3]}")
        fwd_p = [t["forward_s"] for t in engine_p.timings]
        dec_p = [t["decode_s"] for t in engine_p.timings]
        steady_p = SERVE_BATCH / statistics.median(fwd_p[1:])
        print(f"   forward windows (s): {[round(x, 4) for x in fwd_p]}; "
              f"decode (s): {[round(x, 3) for x in dec_p]}")
        print(f"   use_pallas serving rate on {name} ({smi_line}): device path "
              f"{steady_p:.1f} graphs/s (median window of batches 2-{n_batches}); end to "
              f"end with host decode "
              f"{SERVE_BATCH * n_batches / (sum(fwd_p) + sum(dec_p)):.1f} molecules/s "
              f"(all batches)", flush=True)
        # peak device memory of one use_pallas forward, on the Hopper route and
        # through the generic kernels (the route adds the [B N N, C] edge buffer)
        x_p, a_p = next(iter(BatchIterator(engine_p.data, SERVE_BATCH, seed=cfg.seed)))
        peaks = {}
        for label, ctx in (("route", contextlib.nullcontext()),
                           ("generic", generic_kernels(fg))):
            with ctx:
                engine_p.forward(a_p, x_p)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                engine_p.forward(a_p, x_p)
                torch.cuda.synchronize()
                peaks[label] = torch.cuda.max_memory_allocated() / 2 ** 30
        serve_peak_rise = peaks["route"] - peaks["generic"]
        print(f"   use_pallas forward peak memory (max_memory_allocated, batch {SERVE_BATCH}): "
              f"Hopper route {peaks['route']:.3f} GiB, the generic kernels "
              f"{peaks['generic']:.3f} GiB; rise {serve_peak_rise:.3f} GiB", flush=True)
        if serve_peak_rise > 0.3:
            raise AssertionError(f"the Hopper route raises the use_pallas forward's peak memory "
                                 f"by {serve_peak_rise:.3f} GiB > 0.3")

    with phase("4c serving as the CLI runs it (correction, top-up, report)"):
        cli_run = cli_serving(tmp.name, inf_smi, counted_all, name, smi_line)
    # what the post-training phases 11-13 read: the delivered set, phase 8's
    # exports and its 8,192 molecules
    post = tempfile.TemporaryDirectory(prefix="chip_smoke_post_")
    delivered_csv = os.path.join(post.name, "inference_drugs.csv")
    shutil.copy(os.path.join(tmp.name, "out_cli", "DrugGEN", "inference_drugs.csv"),
                delivered_csv)

    with phase("4a the v2 attention op"):
        acts, _, (ge, gn) = attn_inputs(TRAIN_BATCH, N_ATOMS, DIM, torch.bfloat16, gen)
        hd = DIM // HEADS
        leaves = [t.reshape(TRAIN_BATCH, N_ATOMS, HEADS, hd).requires_grad_() for t in acts[:3]]
        leaves.append(acts[3].reshape(TRAIN_BATCH, N_ATOMS, N_ATOMS, HEADS, hd).requires_grad_())
        for fn in counted_all.values():
            fn.launches = 0
        edge_pre, node_agg = fa.edge_modulated_attention(*leaves)
        torch.autograd.backward((edge_pre, node_agg), (ge, gn))
        torch.cuda.synchronize()
        launches_v2 = {key: fn.launches for key, fn in counted_all.items()}
        print(f"   edge_modulated_attention forward and backward, B {TRAIN_BATCH} N {N_ATOMS} "
              f"D {DIM} bf16: launches {launches_v2}")
        if (launches_v2["edge_attention_v2_fwd"], launches_v2["edge_attention_v2_bwd"]) != (1, 1) \
                or sum(launches_v2.values()) != 2:
            raise AssertionError("the v2 op did not go through K3 and K4 once each")
        if not all(t.grad is not None and t.grad.shape == t.shape
                   and torch.isfinite(t.grad.float()).all() for t in leaves):
            raise AssertionError("the v2 op's gradients are missing or not finite")
        del acts, ge, gn, leaves, edge_pre, node_agg
        torch.cuda.empty_cache()

    with phase("5 agreement"):
        x, a = next(iter(BatchIterator(engine.data, SERVE_BATCH, seed=cfg.seed)))
        nk, ek = engine.forward(a, x)
        blocks = engine.G.TransformerEncoder.Encoder_Blocks
        for blk in blocks:
            blk.fused_mlp = False
        n_plain, e_plain = engine.forward(a, x)
        for blk in blocks:
            blk.fused_mlp = True
        total = nk.numel() + ek.numel()
        same = (nk == n_plain).sum().item() + (ek == e_plain).sum().item()
        agree = same / total
        print(f"   kernel vs plain bf16 labels: {agree:.6f} "
              f"({total - same} of {total} differ)")
        if agree < MIN_LABEL_AGREEMENT:
            raise AssertionError(f"label agreement {agree} < {MIN_LABEL_AGREEMENT}")
        engine32 = InferenceEngine(
            dataclasses.replace(cfg, compute_dtype="float32", fused_mlp=False),
            vocab=vocab, g_state_dict=engine.G.state_dict())
        n32, e32 = engine32.forward(a, x)
        same32 = (n32 == n_plain).sum().item() + (e32 == e_plain).sum().item()
        print(f"   plain f32 vs plain bf16 labels (information): "
              f"{same32 / total:.6f}", flush=True)

        def agreement(lhs, rhs) -> float:
            return sum((p_ == q_).sum().item() for p_, q_ in zip(lhs, rhs)) / total

        k9_labels = engine_p.forward(a, x)
        z_e5 = F.one_hot(torch.as_tensor(a).long().cuda(), vocab.b_dim).bfloat16()
        z_n5 = F.one_hot(torch.as_tensor(x).long().cuda(), vocab.m_dim).bfloat16()
        k9_plain = [t.argmax(-1) for t in fg.fused_generator_logits_reference(
            engine_p.k9_weights.weights, engine_p.k9_weights.depth, z_e5, z_n5,
            heads=cfg.heads)]
        engine32p = InferenceEngine(
            dataclasses.replace(cfg, compute_dtype="float32", fused_mlp=False, use_pallas=True),
            vocab=vocab, g_state_dict=engine.G.state_dict())
        k9_32 = engine32p.forward(a, x)
        agree_plain = agreement(k9_labels, k9_plain)
        agree_32 = agreement(k9_32, (n32, e32))
        agree_k1 = agreement(k9_labels, (nk, ek))
        print(f"   use_pallas: K9 vs K9's plain version, bf16 labels {agree_plain:.6f}; f32 K9 "
              f"vs the f32 plain Generator {agree_32:.6f}; bf16 K9 vs slice 1's K1 path "
              f"(information: they round at other points) {agree_k1:.6f}", flush=True)
        if min(agree_plain, agree_32) < MIN_LABEL_AGREEMENT:
            raise AssertionError(f"K9 label agreement {agree_plain} / {agree_32} < "
                                 f"{MIN_LABEL_AGREEMENT}")
        del engine32, engine32p
    tmp.cleanup()

    with phase("6 timing"):
        s = torch.randn(ROWS, DIM, generator=gen, device="cuda").to(torch.bfloat16)
        g1, bl1, w1, b1, w2, b2, g2, bl2 = params
        w1t_b, w2t_b = w1.t().contiguous().bfloat16(), w2.t().contiguous().bfloat16()
        b1_b, b2_b = b1.bfloat16(), b2.bfloat16()

        def kernel():
            fused_ln_mlp_ln(s, *params)

        def plain():
            fused_ln_mlp_ln_reference(s, *params)

        def composite():   # eager PyTorch of the same math, a yardstick only
            x_ = F.layer_norm(s, (DIM,), g1.bfloat16(), bl1.bfloat16(), 1e-5)
            h_ = torch.relu(F.linear(x_, w1t_b, b1_b))
            F.layer_norm(x_ + F.linear(h_, w2t_b, b2_b), (DIM,),
                         g2.bfloat16(), bl2.bfloat16(), 1e-5)

        k_a = cuda_ms(kernel, 20)
        p_ms = cuda_ms(plain, 5)
        c_ms = cuda_ms(composite, 20)
        k_b = cuda_ms(kernel, 20)
        k_ms = (k_a + k_b) / 2
        bound_ms, bound_by = tail_bound(ROWS, torch.bfloat16)
        print(f"   fused_ln_mlp_ln bf16 rows {ROWS:,} on {name} ({smi_line}):")
        print(f"   kernel {k_ms:.4f} ms (runs {k_a:.4f}, {k_b:.4f}); plain "
              f"{p_ms:.4f} ms; eager composite {c_ms:.4f} ms; bound "
              f"{bound_ms:.4f} ms ({bound_by}); kernel at "
              f"{100 * bound_ms / k_ms:.1f}% of the bound", flush=True)

        dout = torch.randn(ROWS, DIM, generator=gen, device="cuda").to(torch.bfloat16)

        def kernel_bwd():
            fused_ln_mlp_ln_bwd(s, *params, dout)

        def plain_bwd():
            fused_ln_mlp_ln_bwd_reference(s, *params, dout)

        # yardstick: eager autograd backward of the bf16 composite above
        leaves = [t.detach().requires_grad_() for t in
                  (s, g1.bfloat16(), bl1.bfloat16(), w1t_b, b1_b, w2t_b, b2_b,
                   g2.bfloat16(), bl2.bfloat16())]
        s_, g1_, bl1_, w1_, b1_, w2_, b2_, g2_, bl2_ = leaves
        x_ = F.layer_norm(s_, (DIM,), g1_, bl1_, 1e-5)
        out_ = F.layer_norm(x_ + F.linear(torch.relu(F.linear(x_, w1_, b1_)), w2_, b2_),
                            (DIM,), g2_, bl2_, 1e-5)

        def composite_bwd():
            torch.autograd.grad(out_, leaves, dout, retain_graph=True)

        kb_a = cuda_ms(kernel_bwd, 10)
        pb_ms = cuda_ms(plain_bwd, 3, warmup=1)
        cb_ms = cuda_ms(composite_bwd, 10)
        kb_b = cuda_ms(kernel_bwd, 10)
        kb_ms = (kb_a + kb_b) / 2
        del out_, x_, leaves
        bound_b_ms, bound_b_by = tail_bwd_bound(ROWS, torch.bfloat16)
        k2_split = launch_split(kernel_bwd, K2_LAUNCHES)
        print(f"   fused_ln_mlp_ln_bwd bf16 rows {ROWS:,} on {name} ({smi_line}):")
        print(f"   kernel {kb_ms:.4f} ms (runs {kb_a:.4f}, {kb_b:.4f}); plain "
              f"{pb_ms:.4f} ms; eager autograd backward of the composite "
              f"{cb_ms:.4f} ms; bound {bound_b_ms:.4f} ms ({bound_b_by}); "
              f"kernel at {100 * bound_b_ms / kb_ms:.1f}% of the bound", flush=True)
        print("   K2 by launch (torch.profiler, one call): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in k2_split.items()), flush=True)
        # a reference, not library_ms: the products alone through torch.matmul
        mm_fwd, mm_bwd = matmul_products(ROWS, DIM, HIDDEN, gen)
        mm1_ms, mm2_ms = cuda_ms(mm_fwd, 20), cuda_ms(mm_bwd, 10)
        del mm_fwd, mm_bwd
        print(f"   reference: K1's 2 products through torch.matmul {mm1_ms:.4f} ms; "
              f"K2's 6 products {mm2_ms:.4f} ms (bf16, the same shapes)", flush=True)
        del s, dout
        torch.cuda.empty_cache()

        # K5 / K6 at the training shape, bf16
        acts, aparams, (ge, gn) = attn_inputs(TRAIN_BATCH, N_ATOMS, DIM, torch.bfloat16, gen)
        t_res = fa.edge_attention_fwd(*acts, *aparams, HEADS)[2]

        def k5():
            fa.edge_attention_fwd(*acts, *aparams, HEADS)

        def k5_plain():
            fa.edge_attention_fwd_reference(*acts, *aparams, HEADS)

        def k6():
            fa.edge_attention_bwd(*acts, *aparams[:3], t_res, ge, gn, HEADS)

        def k6_plain():
            fa.edge_attention_bwd_reference(*acts, *aparams[:3], t_res, ge, gn, HEADS)

        # yardstick: the eager chain that GraphMHA runs without use_pallas
        # (bf16 Dense, modulate, softmax, aggregate, out_e) and its autograd
        # backward; no one PyTorch call computes this attention
        hd = DIM // HEADS
        cleaves = [t.detach().requires_grad_() for t in
                   acts + [aparams[0].t().bfloat16(), aparams[1].bfloat16(),
                           aparams[2].t().bfloat16(), aparams[3].bfloat16()]]

        def composite_fwd():
            q_, k_, v_, er_, we_, be_, woe_, boe_ = cleaves
            sh = (TRAIN_BATCH, N_ATOMS, HEADS, hd)
            e_ = F.linear(er_, we_, be_).reshape(*sh[:2], N_ATOMS, HEADS, hd)
            at = q_.reshape(sh)[:, :, None] * k_.reshape(sh)[:, None]
            at = at / math.sqrt(hd) * (e_ + 1.0) * e_
            eo_ = F.linear(at.reshape(TRAIN_BATCH, N_ATOMS, N_ATOMS, DIM), woe_, boe_)
            na_ = (torch.softmax(at, dim=2) * v_.reshape(sh)[:, None]).sum(2)
            return eo_, na_.reshape(TRAIN_BATCH, N_ATOMS, DIM)

        c_out = composite_fwd()

        def composite_bwd():
            torch.autograd.grad(c_out, cleaves, (ge, gn), retain_graph=True)

        with torch.no_grad():
            k5_a = cuda_ms(k5, 10)
            k5_p = cuda_ms(k5_plain, 3, warmup=1)
            k5_c = cuda_ms(composite_fwd, 10)
            k5_b = cuda_ms(k5, 10)
            k6_a = cuda_ms(k6, 10)
            k6_p = cuda_ms(k6_plain, 2, warmup=1)
        k6_c = cuda_ms(composite_bwd, 10)
        k6_b = cuda_ms(k6, 10)
        k5_ms, k6_ms = (k5_a + k5_b) / 2, (k6_a + k6_b) / 2
        k6_split = launch_split(k6, K6_LAUNCHES)
        (bound5, by5, ffma5, earlier5), (bound6, by6, ffma6, earlier6) = attn_bounds(
            TRAIN_BATCH, N_ATOMS, DIM, torch.bfloat16)
        print(f"   edge_attention_fwd (K5) bf16 B {TRAIN_BATCH} N {N_ATOMS} D {DIM} on "
              f"{name} ({smi_line}):")
        print(f"   kernel {k5_ms:.4f} ms (runs {k5_a:.4f}, {k5_b:.4f}); plain "
              f"{k5_p:.4f} ms; eager composite {k5_c:.4f} ms; bound {bound5:.4f} ms "
              f"({by5}; e = eraw We as three bf16 passes, t Woe f32 x f32 at 3xTF32's "
              f"rate; priced as before, both at 3xTF32's: {earlier5:.4f} ms; on f32 FMA "
              f"{ffma5:.4f} ms); kernel at {100 * bound5 / k5_ms:.1f}% of the bound")
        print(f"   edge_attention_bwd (K6) bf16, same shape:")
        print(f"   kernel {k6_ms:.4f} ms (runs {k6_a:.4f}, {k6_b:.4f}); plain "
              f"{k6_p:.4f} ms; eager autograd backward of the composite {k6_c:.4f} ms; "
              f"bound {bound6:.4f} ms ({by6}; t^T ge exact in bf16, e, ge Woe^T and eraw^T "
              f"de as three bf16 passes, de We^T at 3xTF32's rate; priced as before, all "
              f"five at 3xTF32's: {earlier6:.4f} ms; on f32 FMA {ffma6:.4f} ms); kernel at "
              f"{100 * bound6 / k6_ms:.1f}% of the bound", flush=True)
        print("   K6 by launch (torch.profiler, one call): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in k6_split.items()), flush=True)
        del acts, aparams, ge, gn, t_res, cleaves, c_out
        torch.cuda.empty_cache()
        # a reference, not library_ms: the products alone through torch.matmul
        mm5, mm6 = attn_matmul_products(ROWS, DIM, gen)
        mm5_ms, mm6_ms = cuda_ms(mm5, 10), cuda_ms(mm6, 10)
        del mm5, mm6
        torch.cuda.empty_cache()
        print(f"   reference: K5's 2 products through torch.matmul {mm5_ms:.4f} ms; K6's 5 "
              f"{mm6_ms:.4f} ms (f32 with TF32 off; the same shapes)", flush=True)

        # K1 / K2 at dim 128 with mlp_ratio 4 (weights streamed from L2), bf16
        s = torch.randn(ROWS, DIM, generator=gen, device="cuda").to(torch.bfloat16)
        dout = torch.randn(ROWS, DIM, generator=gen, device="cuda").to(torch.bfloat16)
        kw_a = cuda_ms(lambda: fused_ln_mlp_ln(s, *wide), 20)
        pw_ms = cuda_ms(lambda: fused_ln_mlp_ln_reference(s, *wide), 5)
        kw_b = cuda_ms(lambda: fused_ln_mlp_ln(s, *wide), 20)
        kbw_a = cuda_ms(lambda: fused_ln_mlp_ln_bwd(s, *wide, dout), 10)
        pbw_ms = cuda_ms(lambda: fused_ln_mlp_ln_bwd_reference(s, *wide, dout), 3, warmup=1)
        kbw_b = cuda_ms(lambda: fused_ln_mlp_ln_bwd(s, *wide, dout), 10)
        kw_ms, kbw_ms = (kw_a + kw_b) / 2, (kbw_a + kbw_b) / 2
        boundw, byw = tail_bound(ROWS, torch.bfloat16, DIM, WIDE_HIDDEN)
        boundbw, bybw = tail_bwd_bound(ROWS, torch.bfloat16, DIM, WIDE_HIDDEN)
        print(f"   fused_ln_mlp_ln (K1) and its backward (K2) bf16, C {DIM} H {WIDE_HIDDEN} "
              f"(weights streamed from L2), rows {ROWS:,} on {name} ({smi_line}):")
        print(f"   K1 {kw_ms:.4f} ms (runs {kw_a:.4f}, {kw_b:.4f}); plain {pw_ms:.4f} ms; "
              f"bound {boundw:.4f} ms ({byw}); K2 {kbw_ms:.4f} ms (runs {kbw_a:.4f}, "
              f"{kbw_b:.4f}); plain {pbw_ms:.4f} ms; bound {boundbw:.4f} ms ({bybw})",
              flush=True)
        del s, dout
        torch.cuda.empty_cache()

        # K1 / K2 at dim 512 (the split path), bf16
        s = torch.randn(NARROW_ROWS, SPLIT_DIM, generator=gen, device="cuda").to(torch.bfloat16)
        dout = torch.randn(NARROW_ROWS, SPLIT_DIM, generator=gen,
                           device="cuda").to(torch.bfloat16)
        kx_a = cuda_ms(lambda: fused_ln_mlp_ln(s, *split_p), 10)
        px_ms = cuda_ms(lambda: fused_ln_mlp_ln_reference(s, *split_p), 3, warmup=1)
        kx_b = cuda_ms(lambda: fused_ln_mlp_ln(s, *split_p), 10)
        kbx_a = cuda_ms(lambda: fused_ln_mlp_ln_bwd(s, *split_p, dout), 5)
        pbx_ms = cuda_ms(lambda: fused_ln_mlp_ln_bwd_reference(s, *split_p, dout), 3, warmup=1)
        kbx_b = cuda_ms(lambda: fused_ln_mlp_ln_bwd(s, *split_p, dout), 5)
        kx_ms, kbx_ms = (kx_a + kx_b) / 2, (kbx_a + kbx_b) / 2
        boundx, byx = tail_bound(NARROW_ROWS, torch.bfloat16, SPLIT_DIM, SPLIT_HIDDEN)
        boundbx, bybx = tail_bwd_bound(NARROW_ROWS, torch.bfloat16, SPLIT_DIM, SPLIT_HIDDEN)
        print(f"   fused_ln_mlp_ln (K1) and its backward (K2) bf16, C {SPLIT_DIM} H "
              f"{SPLIT_HIDDEN} (the split path), rows {NARROW_ROWS:,} on {name} ({smi_line}):")
        print(f"   K1 {kx_ms:.4f} ms (runs {kx_a:.4f}, {kx_b:.4f}); plain {px_ms:.4f} ms; "
              f"bound {boundx:.4f} ms ({byx}); K2 {kbx_ms:.4f} ms (runs {kbx_a:.4f}, "
              f"{kbx_b:.4f}); plain {pbx_ms:.4f} ms; bound {boundbx:.4f} ms ({bybx})",
              flush=True)
        del s, dout
        torch.cuda.empty_cache()

        # K7 / K8 at the training shape, bf16
        bacts, bparams, (gy, gnb) = block_inputs(TRAIN_BATCH, N_ATOMS, DIM, HIDDEN,
                                                 torch.bfloat16, gen)

        def k7():
            fb.fused_block_fwd(*bacts, *bparams, HEADS)

        def k7_plain():
            fb.fused_block_fwd_reference(*bacts, *bparams, HEADS)

        def k8():
            fb.fused_block_bwd(*bacts, *bparams, gy, gnb, HEADS)

        def k8_plain():
            fb.fused_block_bwd_reference(*bacts, *bparams, gy, gnb, HEADS)

        # yardstick: the eager bf16 chain that an EncoderBlock runs without
        # the megablock (GraphMHA's edge chain, then LN4 -> MLP2 -> LN6) and
        # its autograd backward; no one PyTorch call computes this function
        lin = (0, 2, 6, 8)   # the weights, [in, out] -> nn.Linear's [out, in]
        bleaves = [t.detach().requires_grad_() for t in bacts + [
            (p_.t() if i in lin else p_).bfloat16() for i, p_ in enumerate(bparams)]]

        def block_composite():
            q_, k_, v_, y_, we_, be_, woe_, boe_, g4_, b4_, w1_, b1_, w2_, b2_, g6_, b6_ = bleaves
            sh = (TRAIN_BATCH, N_ATOMS, HEADS, hd)
            e_ = F.linear(y_, we_, be_).reshape(*sh[:2], N_ATOMS, HEADS, hd)
            at = q_.reshape(sh)[:, :, None] * k_.reshape(sh)[:, None]
            at = at / math.sqrt(hd) * (e_ + 1.0) * e_
            y1_ = F.linear(at.reshape(TRAIN_BATCH, N_ATOMS, N_ATOMS, DIM), woe_, boe_)
            na_ = (torch.softmax(at, dim=2) * v_.reshape(sh)[:, None]).sum(2)
            u_ = F.layer_norm(y_ + y1_, (DIM,), g4_, b4_, 1e-5)
            yo_ = F.layer_norm(u_ + F.linear(torch.relu(F.linear(u_, w1_, b1_)), w2_, b2_),
                               (DIM,), g6_, b6_, 1e-5)
            return yo_, na_.reshape(TRAIN_BATCH, N_ATOMS, DIM)

        with torch.no_grad():
            k7_a = cuda_ms(k7, 10)
            k7_p = cuda_ms(k7_plain, 3, warmup=1)
            k7_c = cuda_ms(block_composite, 10)
            k7_b = cuda_ms(k7, 10)
            k8_a = cuda_ms(k8, 5, warmup=2)
            k8_p = cuda_ms(k8_plain, 2, warmup=1)
        b_out = block_composite()

        def block_composite_bwd():
            torch.autograd.grad(b_out, bleaves, (gy, gnb), retain_graph=True)

        k8_c = cuda_ms(block_composite_bwd, 5, warmup=2)
        k8_b = cuda_ms(k8, 5, warmup=1)
        k7_ms, k8_ms = (k7_a + k7_b) / 2, (k8_a + k8_b) / 2
        k8_split = launch_split(k8, K8_LAUNCHES)
        del bleaves, b_out
        torch.cuda.empty_cache()
        (bound7, by7, ffma7, earlier7), (bound8, by8, ffma8, earlier8) = block_bounds(
            TRAIN_BATCH, N_ATOMS, DIM, HIDDEN, torch.bfloat16)
        print(f"   fused_block_fwd (K7) bf16 B {TRAIN_BATCH} N {N_ATOMS} D {DIM} H {HIDDEN} "
              f"on {name} ({smi_line}):")
        print(f"   kernel {k7_ms:.4f} ms (runs {k7_a:.4f}, {k7_b:.4f}); plain "
              f"{k7_p:.4f} ms; eager composite {k7_c:.4f} ms; bound {bound7:.4f} ms "
              f"({by7}; each product at the faster route its operand types allow: "
              f"bf16-exact at the bf16 rate, t @ Woe as three bf16 passes; priced as "
              f"before, t @ Woe at 3xTF32's: {earlier7:.4f} ms; its two f32-accurate "
              f"products on f32 FMA {ffma7:.4f} ms); kernel at "
              f"{100 * bound7 / k7_ms:.1f}% of the bound")
        print(f"   fused_block_bwd (K8) bf16, same shape:")
        print(f"   kernel {k8_ms:.4f} ms (runs {k8_a:.4f}, {k8_b:.4f}); plain "
              f"{k8_p:.4f} ms; eager autograd backward of the composite {k8_c:.4f} ms; "
              f"bound {bound8:.4f} ms ({by8}; f32 x bf16-exact as three bf16 passes, f32 x "
              f"f32 at 3xTF32; priced as before, all f32-accurate products at 3xTF32: "
              f"{earlier8:.4f} ms; on f32 FMA {ffma8:.4f} ms); kernel at "
              f"{100 * bound8 / k8_ms:.1f}% of the bound", flush=True)
        print("   K8 by launch (torch.profiler, one call): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in k8_split.items()), flush=True)
        del bacts, bparams, gy, gnb
        torch.cuda.empty_cache()
        # a reference, not library_ms: the products alone through torch.matmul
        mm7, mm8 = block_matmul_products(ROWS, DIM, HIDDEN, gen)
        mm7_ms, mm8_ms = cuda_ms(mm7, 10), cuda_ms(mm8, 5, warmup=2)
        del mm7, mm8
        torch.cuda.empty_cache()
        print(f"   reference: K7's 4 products through torch.matmul {mm7_ms:.4f} ms; K8's 12 "
              f"{mm8_ms:.4f} ms (bf16 where both operands are exact in bf16, else f32 with "
              f"TF32 off; the same shapes)", flush=True)

        # K9 at the serving shape, bf16: the trained weights on the corpus
        # one-hots of phase 3, on the Hopper route; beside it the generic
        # kernels in this tree.  Yardstick: slice 1's forward on the same
        # one-hots, the eager bf16 Generator with K1 (the engine's G); no one
        # PyTorch call computes the Generator
        z_e_b, z_n_b = z_e.bfloat16(), z_n.bfloat16()

        def k9_call():
            fg.fused_generator_logits(trained, z_e_b, z_n_b, heads=HEADS)
        with torch.inference_mode():
            k9_a = cuda_ms(k9_call, 20)
            with generic_kernels(fg):
                k9_generic = cuda_ms(k9_call, 20)
            k9_p = cuda_ms(lambda: fg.fused_generator_logits_reference(
                trained.weights, trained.depth, z_e_b, z_n_b, heads=HEADS), 3, warmup=1)
            s1_ms = cuda_ms(lambda: engine.G(z_e_b, z_n_b), 20)
            k9_b = cuda_ms(k9_call, 20)
            k9_f32 = cuda_ms(lambda: fg.fused_generator_logits(trained, z_e, z_n, heads=HEADS),
                             3, warmup=1)
        k9_ms = (k9_a + k9_b) / 2
        bound9, by9 = generator_bound(SERVE_BATCH, N_ATOMS, trained, torch.bfloat16)
        bound9_32, by9_32 = generator_bound(SERVE_BATCH, N_ATOMS, trained, torch.float32)
        bounds9 = generator_launch_bounds(SERVE_BATCH, N_ATOMS, trained)
        print(f"   fused_generator_logits (K9) bf16 B {SERVE_BATCH} N {N_ATOMS} dim {DIM} "
              f"H {HIDDEN} depth {trained.depth} on {name} ({smi_line}):")
        print(f"   kernel {k9_ms:.4f} ms (runs {k9_a:.4f}, {k9_b:.4f}; Hopper route, "
              f"the plan's {gplan.device_launches} device launches a call); the generic kernels in this "
              f"tree {k9_generic:.4f} ms; plain {k9_p:.4f} ms; slice 1's forward (eager bf16 "
              f"Generator with K1) {s1_ms:.4f} ms; bound {bound9:.4f} ms ({by9}); kernel at "
              f"{100 * bound9 / k9_ms:.1f}% of the bound; f32 twin (the generic kernels) "
              f"{k9_f32:.4f} ms (bound {bound9_32:.4f} ms, {by9_32}, 3xTF32)", flush=True)
        torch.cuda.empty_cache()

        # K3 / K4 at the training shape, bf16.  Yardstick: the eager
        # reference_attention (the op's plain composite) and its autograd
        # backward
        acts, _, (ge, gn) = attn_inputs(TRAIN_BATCH, N_ATOMS, DIM, torch.bfloat16, gen)
        v_leaves = [t.detach().reshape(TRAIN_BATCH, N_ATOMS, HEADS, hd).requires_grad_()
                    for t in acts[:3]]
        v_leaves.append(acts[3].detach().reshape(TRAIN_BATCH, N_ATOMS, N_ATOMS, HEADS, hd)
                        .requires_grad_())
        with torch.no_grad():
            k3_a = cuda_ms(lambda: fa.edge_attention_v2_fwd(*acts, HEADS), 20)
            k3_p = cuda_ms(lambda: fa.edge_attention_v2_fwd_reference(*acts, HEADS), 3,
                           warmup=1)
            k3_c = cuda_ms(lambda: fa.reference_attention(*v_leaves), 10)
            k3_b = cuda_ms(lambda: fa.edge_attention_v2_fwd(*acts, HEADS), 20)
            k4_a = cuda_ms(lambda: fa.edge_attention_v2_bwd(*acts, ge, gn, HEADS), 20)
            k4_p = cuda_ms(lambda: fa.edge_attention_v2_bwd_reference(*acts, ge, gn, HEADS),
                           3, warmup=1)
        r_out = fa.reference_attention(*v_leaves)
        k4_c = cuda_ms(lambda: torch.autograd.grad(r_out, v_leaves, (ge, gn),
                                                   retain_graph=True), 10)
        k4_b = cuda_ms(lambda: fa.edge_attention_v2_bwd(*acts, ge, gn, HEADS), 20)
        k3_ms, k4_ms = (k3_a + k3_b) / 2, (k4_a + k4_b) / 2
        (bound3, by3), (bound4, by4) = v2_bounds(TRAIN_BATCH, N_ATOMS, DIM, torch.bfloat16)
        bytes3, bytes4 = v2_bytes(TRAIN_BATCH, N_ATOMS, DIM, torch.bfloat16)
        # device launches a call, counted by the profiler (one each)
        v2_device = {
            "K3": device_launches(lambda: fa.edge_attention_v2_fwd(*acts, HEADS), V2_KERNELS),
            "K4": device_launches(lambda: fa.edge_attention_v2_bwd(*acts, ge, gn, HEADS),
                                  V2_KERNELS)}
        if v2_device != {"K3": {"K3": 1, "K4": 0, "all": 1}, "K4": {"K3": 0, "K4": 1, "all": 1}}:
            raise AssertionError(f"K3 / K4 are not one device launch a call: {v2_device}")
        print(f"   edge_attention_v2_fwd (K3) bf16 B {TRAIN_BATCH} N {N_ATOMS} D {DIM} on "
              f"{name} ({smi_line}):")
        print(f"   kernel {k3_ms:.4f} ms (runs {k3_a:.4f}, {k3_b:.4f}); plain {k3_p:.4f} ms; "
              f"eager reference_attention {k3_c:.4f} ms; bound {bound3:.4f} ms ({by3}); "
              f"kernel at {100 * bound3 / k3_ms:.1f}% of the bound; {bytes3 / k3_ms / 1e9:.3f} "
              f"TB/s of the card's {PEAK_BYTES_S / 1e12:.2f}; device launches a call "
              f"{v2_device['K3']['all']}")
        print(f"   edge_attention_v2_bwd (K4) bf16, same shape:")
        print(f"   kernel {k4_ms:.4f} ms (runs {k4_a:.4f}, {k4_b:.4f}); plain {k4_p:.4f} ms; "
              f"eager autograd backward of reference_attention {k4_c:.4f} ms; bound "
              f"{bound4:.4f} ms ({by4}); kernel at {100 * bound4 / k4_ms:.1f}% of the bound; "
              f"{bytes4 / k4_ms / 1e9:.3f} TB/s; device launches a call {v2_device['K4']['all']}",
              flush=True)
        del acts, ge, gn, v_leaves, r_out
        torch.cuda.empty_cache()

    with phase("7 profile"):
        x, a = next(iter(BatchIterator(engine.data, SERVE_BATCH, seed=cfg.seed)))
        prof_k1 = profile_forward(lambda: engine.forward(a, x), "bf16 + fused tail",
                                  name, smi_line)
        prof_k9 = profile_forward(lambda: engine_p.forward(a, x), "bf16, use_pallas (K9)",
                                  name, smi_line, required=K9_LAUNCHES.values())
        # K9 by launch, from the profile of its forward (a profiler session
        # of its own in phase 6 would slow the host for phase 7's timings)
        k9_split = {label: sum(ms for key, ms, _ in prof_k9["kernels"] if pat in key)
                    for label, pat in K9_LAUNCHES.items()}
        if not all(k9_split.values()):
            raise AssertionError(f"a K9 launch is missing from the use_pallas forward's "
                                 f"profile: {k9_split}")
        # the forward's device launches, counted by the profiler: a node
        # pass a depth and one after the last, an attention and a tail
        # launch a depth, and none of the generic edge kernel
        k9_counts = {label: sum(n for key, _, n in prof_k9["kernels"] if pat in key)
                     for label, pat in {**K9_LAUNCHES, "generic edge": "gen_edge_kernel"}.items()}
        depth9 = engine_p.k9_weights.depth
        want = {"node": depth9 + 1, "attention": depth9, "tail": depth9, "generic edge": 0}
        if k9_counts != want:
            raise AssertionError(f"the use_pallas forward's K9 device launches {k9_counts}, "
                                 f"expected {want}")
        k9_device_launches = sum(k9_counts.values())
        print(f"   K9's device launches in that forward (profiler counts): {k9_counts}, "
              f"{k9_device_launches} in all", flush=True)
        print("   K9 by launch in that forward (bound of the launches, summed over the "
              "depths): " + ", ".join(
                  f"{k} {v:.4f} ms (bound {bounds9[k][0]:.4f}, {bounds9[k][1]})"
                  for k, v in k9_split.items()), flush=True)

    train = training_phases(name, smi_line, counted, post.name)

    ref1 = os.path.join(post.name, f"chembl_like_{TRAIN_MOLECULES}.smi")
    with open(SMILES_FILE) as src, open(ref1, "w") as dst:
        for _, line in zip(range(TRAIN_MOLECULES), src):
            dst.write(line)
    with phase("11 native set-up"):
        native_setup(name, smi_line)
    with phase("12 checkpoint selection"):
        launches_select = checkpoint_selection(post.name, ref1, counted_all, name, smi_line)
    with phase("13 offline evaluation"):
        offline_evaluation(post.name, delivered_csv, ref1, name, smi_line)
    with phase("14 neural correctors"):
        neural_correctors(post.name, delivered_csv, ref1, name, smi_line)
    post.cleanup()
    with phase("15 parallel training, two ranks on the card"):
        parallel = parallel_training(name, smi_line)

    record = {"kernels": [{
        "name": "fused_ln_mlp_ln_fwd",
        "route": "cuda",
        "source": "druggen_tpu_torch/ops/csrc/fused_mlp.cu",
        "replaces": "druggen_tpu/ops/fused_mlp.py:72",
        "launches": launches["fused_ln_mlp_ln_fwd"],
        "launches_by_path": {"serving": launches["fused_ln_mlp_ln_fwd"],
                             "serving_use_pallas": launches_p["fused_ln_mlp_ln_fwd"],
                             "training": train["launches"]["fused_ln_mlp_ln_fwd"],
                             "training_resumed": train["launches_resumed"]["fused_ln_mlp_ln_fwd"],
                             "training_fused_block":
                                 train["launches_block"]["fused_ln_mlp_ln_fwd"],
                             "training_fwdrev": train["launches_fwdrev"]["fused_ln_mlp_ln_fwd"],
                             "training_fused_block_fwdrev":
                                 train["launches_block_fwdrev"]["fused_ln_mlp_ln_fwd"],
                             "training_options": {
                                 k: v["launches"]["fused_ln_mlp_ln_fwd"]
                                 for k, v in train["options"].items()},
                             "checkpoint_selection": launches_select["fused_ln_mlp_ln_fwd"],
                             "training_parallel_rank0": {
                                 k: parallel[k]["launches"]["fused_ln_mlp_ln_fwd"]
                                 for k in ("15a", "15b", "15c")}},
        "max_abs_err": k1["max_abs_err"],
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "matmul_reference_ms": mm1_ms,
        "at_128_512": {"max_abs_err": k1w["max_abs_err"], "ms": kw_ms, "plain_ms": pw_ms,
                       "bound_ms": boundw, "bound_by": byw},
        "at_512_1536_split": {"max_abs_err": k1x["max_abs_err"], "ms": kx_ms,
                              "plain_ms": px_ms, "bound_ms": boundx, "bound_by": byx},
    }, {
        "name": "fused_ln_mlp_ln_bwd",
        "route": "cuda",
        "source": "druggen_tpu_torch/ops/csrc/fused_mlp_bwd.cu",
        "replaces": "druggen_tpu/ops/fused_mlp.py:91",
        "launches": train["launches"]["fused_ln_mlp_ln_bwd"],
        "launches_by_path": {"serving": launches["fused_ln_mlp_ln_bwd"],
                             "training": train["launches"]["fused_ln_mlp_ln_bwd"],
                             "training_resumed": train["launches_resumed"]["fused_ln_mlp_ln_bwd"],
                             "training_fused_block":
                                 train["launches_block"]["fused_ln_mlp_ln_bwd"],
                             "training_fwdrev": train["launches_fwdrev"]["fused_ln_mlp_ln_bwd"],
                             "training_fused_block_fwdrev":
                                 train["launches_block_fwdrev"]["fused_ln_mlp_ln_bwd"],
                             "training_options": {
                                 k: v["launches"]["fused_ln_mlp_ln_bwd"]
                                 for k, v in train["options"].items()},
                             "training_parallel_rank0": {
                                 k: parallel[k]["launches"]["fused_ln_mlp_ln_bwd"]
                                 for k in ("15a", "15b", "15c")}},
        "max_abs_err": k2["max_abs_err"],
        "ms": kb_ms,
        "plain_ms": pb_ms,
        "bound_ms": bound_b_ms,
        "bound_by": bound_b_by,
        "library_ms": None,
        "eager_autograd_ms": cb_ms,
        "by_launch_ms": k2_split,
        "matmul_reference_ms": mm2_ms,
        "at_128_512": {"max_abs_err": k2w["max_abs_err"], "ms": kbw_ms, "plain_ms": pbw_ms,
                       "bound_ms": boundbw, "bound_by": bybw},
        "at_512_1536_split": {"max_abs_err": k2x["max_abs_err"], "ms": kbx_ms,
                              "plain_ms": pbx_ms, "bound_ms": boundbx, "bound_by": bybx},
    }, {
        "name": "edge_attention_fwd",
        "route": "cuda",
        "source": "druggen_tpu_torch/ops/csrc/fused_attention.cu",
        "replaces": "druggen_tpu/ops/fused_attention.py:224",
        "launches": train["launches_pallas"]["edge_attention_fwd"],
        "launches_by_path": {"serving": launches["edge_attention_fwd"],
                             "training": train["launches"]["edge_attention_fwd"],
                             "training_use_pallas":
                                 train["launches_pallas"]["edge_attention_fwd"],
                             "training_fused_block":
                                 train["launches_block"]["edge_attention_fwd"],
                             "training_fwdrev": train["launches_fwdrev"]["edge_attention_fwd"],
                             "training_fused_block_fwdrev":
                                 train["launches_block_fwdrev"]["edge_attention_fwd"]},
        "max_abs_err": k56["max_abs_err"],
        "ms": k5_ms,
        "plain_ms": k5_p,
        "bound_ms": bound5,
        "bound_by": by5,
        "bound_earlier_pricing_ms": earlier5,
        "bound_ffma_ms": ffma5,
        "library_ms": None,
        "matmul_reference_ms": mm5_ms,
        "eager_composite_ms": k5_c,
    }, {
        "name": "edge_attention_bwd",
        "route": "cuda",
        "source": "druggen_tpu_torch/ops/csrc/fused_attention_bwd.cu",
        "replaces": "druggen_tpu/ops/fused_attention.py:256",
        "launches": train["launches_pallas"]["edge_attention_bwd"],
        "launches_by_path": {"serving": launches["edge_attention_bwd"],
                             "training": train["launches"]["edge_attention_bwd"],
                             "training_use_pallas":
                                 train["launches_pallas"]["edge_attention_bwd"],
                             "training_fused_block":
                                 train["launches_block"]["edge_attention_bwd"],
                             "training_fwdrev": train["launches_fwdrev"]["edge_attention_bwd"],
                             "training_fused_block_fwdrev":
                                 train["launches_block_fwdrev"]["edge_attention_bwd"]},
        "max_abs_err": k56["bwd_max_abs_err"],
        "grad_rel_err": k56["grad_rel_err"],
        "ms": k6_ms,
        "ms_by_launch": k6_split,
        "plain_ms": k6_p,
        "bound_ms": bound6,
        "bound_by": by6,
        "bound_earlier_pricing_ms": earlier6,
        "bound_ffma_ms": ffma6,
        "library_ms": None,
        "matmul_reference_ms": mm6_ms,
        "eager_autograd_ms": k6_c,
    }, {
        "name": "fused_block_fwd",
        "route": "cuda",
        "source": "druggen_tpu_torch/ops/csrc/fused_block.cu",
        "replaces": "druggen_tpu/ops/fused_block.py:82",
        "launches": train["launches_block"]["fused_block_fwd"],
        "launches_by_path": {"serving": launches["fused_block_fwd"],
                             "training": train["launches"]["fused_block_fwd"],
                             "training_use_pallas": train["launches_pallas"]["fused_block_fwd"],
                             "training_fused_block":
                                 train["launches_block"]["fused_block_fwd"],
                             "training_fwdrev": train["launches_fwdrev"]["fused_block_fwd"],
                             "training_fused_block_fwdrev":
                                 train["launches_block_fwdrev"]["fused_block_fwd"]},
        "max_abs_err": k78["max_abs_err"],
        "ms": k7_ms,
        "plain_ms": k7_p,
        "bound_ms": bound7,
        "bound_by": by7,
        "bound_earlier_pricing_ms": earlier7,
        "bound_ffma_ms": ffma7,
        "library_ms": None,
        "matmul_reference_ms": mm7_ms,
        "eager_composite_ms": k7_c,
    }, {
        "name": "fused_block_bwd",
        "route": "cuda",
        "source": "druggen_tpu_torch/ops/csrc/fused_block_bwd.cu",
        "replaces": "druggen_tpu/ops/fused_block.py:144",
        "launches": train["launches_block"]["fused_block_bwd"],
        "launches_by_path": {"serving": launches["fused_block_bwd"],
                             "training": train["launches"]["fused_block_bwd"],
                             "training_use_pallas": train["launches_pallas"]["fused_block_bwd"],
                             "training_fused_block":
                                 train["launches_block"]["fused_block_bwd"],
                             "training_fwdrev": train["launches_fwdrev"]["fused_block_bwd"],
                             "training_fused_block_fwdrev":
                                 train["launches_block_fwdrev"]["fused_block_bwd"]},
        "max_abs_err": k78["bwd_max_abs_err"],
        "grad_rel_err": k78["grad_rel_err"],
        "ms": k8_ms,
        "ms_by_launch": k8_split,
        "plain_ms": k8_p,
        "bound_ms": bound8,
        "bound_by": by8,
        "bound_earlier_pricing_ms": earlier8,
        "bound_ffma_ms": ffma8,
        "library_ms": None,
        "matmul_reference_ms": mm8_ms,
        "eager_autograd_ms": k8_c,
    }, {
        "name": "edge_attention_v2_fwd",
        "route": "cuda",
        "source": "druggen_tpu_torch/ops/csrc/fused_attention_v2.cu",
        "replaces": "druggen_tpu/ops/fused_attention.py:56",
        "launches": launches_v2["edge_attention_v2_fwd"],
        "device_launches_per_call": v2_device["K3"]["all"],
        "max_abs_err": k34["max_abs_err"],
        "ms": k3_ms,
        "plain_ms": k3_p,
        "bound_ms": bound3,
        "bound_by": by3,
        "achieved_tb_s": bytes3 / k3_ms / 1e9,
        "library_ms": None,
        "eager_composite_ms": k3_c,
    }, {
        "name": "edge_attention_v2_bwd",
        "route": "cuda",
        "source": "druggen_tpu_torch/ops/csrc/fused_attention_v2_bwd.cu",
        "replaces": "druggen_tpu/ops/fused_attention.py:101",
        "launches": launches_v2["edge_attention_v2_bwd"],
        "device_launches_per_call": v2_device["K4"]["all"],
        "max_abs_err": k34["bwd_max_abs_err"],
        "ms": k4_ms,
        "plain_ms": k4_p,
        "bound_ms": bound4,
        "bound_by": by4,
        "achieved_tb_s": bytes4 / k4_ms / 1e9,
        "library_ms": None,
        "eager_autograd_ms": k4_c,
    }, {
        "name": "fused_generator_logits",
        "route": "cuda",
        "source": "druggen_tpu_torch/ops/csrc/fused_generator_hopper.cu",
        "sources": ["druggen_tpu_torch/ops/csrc/fused_generator_hopper.cu",
                    "druggen_tpu_torch/ops/csrc/fused_generator.cu"],
        "replaces": "druggen_tpu/ops/fused_generator.py:121",
        "launches": launches_p["fused_generator_logits"],
        "launches_by_path": {"serving": launches["fused_generator_logits"],
                             "serving_use_pallas": launches_p["fused_generator_logits"],
                             "serving_cli": cli_run["launches"]["fused_generator_logits"]},
        "device_launches_per_call": k9_device_launches,
        "max_abs_err": k9["max_abs_err"],
        "max_abs_err_by_launch": k9_launch_errs,
        "label_agreement": k9["label_agreement"],
        "ms": k9_ms,
        "ms_by_launch": k9_split,
        "plain_ms": k9_p,
        "bound_ms": bound9,
        "bound_by": by9,
        "bound_by_launch_ms": {k: v[0] for k, v in bounds9.items()},
        "library_ms": None,
        "generic_kernels_ms": k9_generic,
        "slice1_forward_ms": s1_ms,
        "f32_ms": k9_f32,
        "serving_forward_ms": {"slice1": prof_k1["forward_ms"],
                               "use_pallas": prof_k9["forward_ms"]},
        "use_pallas_peak_rise_gib": serve_peak_rise,
    }]}
    print(json.dumps(record))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
