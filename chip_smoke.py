#!/usr/bin/env python3
"""Drive the PyTorch port (``druggen_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printed with its wall time; any failure raises and the script
exits non-zero without printing a result line:

1. device   — card name, count and ``nvidia-smi`` name/power limit.
2. build    — compile every kernel source with nvcc (``-Xptxas -v``), one
               nvcc a source, all started together.
3. kernels  — each kernel against its plain PyTorch version on the card, at
               the main paths' shape (bf16 and f32) and on a ragged row
               count: K1 (``fused_ln_mlp_ln`` forward) and K2 (its backward).
4. serving  — the port's ``InferenceEngine.run()`` on the trained r2_scale
               Generator (bf16, fused edge tail), 4 batches of 512 graphs;
               the kernel launch counts of that run are checked.
5. agree    — kernel path vs the plain bf16 path on one batch (labels).
6. timing   — each kernel, its plain version and an eager yardstick, CUDA
               events, beside the card's bound.
7. profile  — one serving forward under torch.profiler: device time by
               kernel and the card's idle share of the forward.
8. training — the port's ``Trainer`` (what ``python -m
               druggen_tpu_torch.train`` runs) at the full r2_scale config
               (bf16, fused_mlp + fused_critic, batch 512) for one epoch of
               16 steps over the first 8,192 corpus molecules; the launch
               counts, finite losses, moved parameters and the written
               ``DrugGEN-G.ckpt`` (served by ``InferenceEngine``) are checked.
9. step agreement — one step from the same state through the kernels and
               through the plain versions, bf16 and f32: losses, every
               gradient of G and D, and the G edge tails' gradients.
10. step profile — one training step under torch.profiler: device time by
               kernel, K1's and K2's share, the card's idle share.

The line before the last is the ``{"kernels": [...]}`` record; the last line
is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

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
# kernel vs plain, compared in f32.  bf16: the sums run in another order and
# an output of |y| <= 4 is worth ~2 bf16 ulps (2 * 2^-6); f32: order only.
TOL_BF16_MAX, TOL_BF16_MEAN, TOL_F32_MAX = 3e-2, 2e-3, 1e-4
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
# the Generator's fused edge tails (ln4, mlp2, ln6) on their own.  The plain
# bf16 path rounds at other points (bf16 F.linear/F.layer_norm outputs
# against the kernels' f32 hidden and residual).  On an H100 the whole
# gradients read 3.1e-3 (D) and 2.5e-3 (G), so bf16 is held at 1e-2; the
# tails' own gradients, which take the whole rounding difference, read
# 8.4e-3 and are held at 2.5e-2.  f32 only sums in another order.
TOL_STEP = {torch.bfloat16: 1e-2, torch.float32: 1e-3}
TOL_TAIL = {torch.bfloat16: 2.5e-2, torch.float32: 1e-3}
TAIL_PARAMS = (".ln4.", ".mlp2.", ".ln6.")
MIN_LABEL_AGREEMENT = 0.999
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and dense bf16 FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

KERNEL_SOURCES = ("fused_mlp", "fused_mlp_bwd")
GRAD_NAMES = ("dg1", "dbl1", "dw1", "db1", "dw2", "db2", "dg2", "dbl2")


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"== {name}", flush=True)
    yield
    print(f"== {name} done in {time.perf_counter() - t0:.2f} s", flush=True)


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


def tail_params(gen: torch.Generator, device) -> tuple:
    """Random LN/MLP tail parameters at the serving width (f32)."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)
    g1, bl1 = 1 + 0.1 * randn(DIM), 0.1 * randn(DIM)
    w1, b1 = randn(DIM, HIDDEN) / math.sqrt(DIM), 0.1 * randn(HIDDEN)
    w2, b2 = randn(HIDDEN, DIM) / math.sqrt(HIDDEN), 0.1 * randn(DIM)
    g2, bl2 = 1 + 0.1 * randn(DIM), 0.1 * randn(DIM)
    return g1, bl1, w1, b1, w2, b2, g2, bl2


def tail_bound(rows: int, dtype) -> tuple[float, str]:
    """Least milliseconds the card needs for one fused tail call: each input
    read once and each output written once, against the two products."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * rows * DIM * item            # s in, out
              + 2 * DIM * HIDDEN * item        # W1, W2
              + (5 * DIM + HIDDEN) * 4)        # LN params and biases (f32)
    flops = 2 * 2 * rows * DIM * HIDDEN
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS_S[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tail_bwd_bound(rows: int, dtype) -> tuple[float, str]:
    """Least milliseconds for one K2 call: read s and dout, write ds (and
    the weights and the f32 gradients once), against its six products (two
    forward products recomputed, four backward)."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (3 * rows * DIM * item + 2 * DIM * HIDDEN * item
              + (5 * DIM + HIDDEN) * 4
              + (2 * DIM * HIDDEN + 6 * DIM + HIDDEN) * 4)
    flops = 6 * 2 * rows * DIM * HIDDEN
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS_S[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rel_err(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def bwd_row_ok(dtype):
    """K2's ds against its plain version, a bool per row (see above)."""
    if dtype == torch.bfloat16:
        return lambda a, b: ((a.float() - b.float()).abs()
                             <= TOL_BF16_MAX + 2 ** -6 * b.float().abs()).all(-1)
    return lambda a, b: ((a.float() - b.float()).abs() <= TOL_F32_MAX).all(-1)


def check_bwd_kernel(bwd, reference, witness, params, rows: int, dtype, gen) -> dict:
    """K2 against its plain version on the same inputs, with the rows beyond
    tolerance witnessed at the ReLU kink (see MAX_FLIP_ROW_SHARE)."""
    s = torch.randn(rows, DIM, generator=gen, device="cuda").to(dtype)
    dout = torch.randn(rows, DIM, generator=gen, device="cuda").to(dtype)
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
    print(f"   K2 rows {rows:>9,} {str(dtype):>14}: ds max |kernel - plain| "
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


def check_kernel(fused, reference, params, rows: int, dtype, gen) -> dict:
    s = torch.randn(rows, DIM, generator=gen, device="cuda").to(dtype)
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
    print(f"   rows {rows:>9,} {str(dtype):>14}: max |kernel - plain| "
          f"{max_err:.3e}, mean {mean_err:.3e}", flush=True)
    if dtype == torch.bfloat16:
        ok = max_err <= TOL_BF16_MAX and mean_err <= TOL_BF16_MEAN
    else:
        ok = max_err <= TOL_F32_MAX
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version "
                             f"({dtype}, rows {rows}): max {max_err}, "
                             f"mean {mean_err}")
    return {"max_abs_err": max_err, "mean_abs_err": mean_err}


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


def training_phases(name: str, smi_line: str, fwd, bwd) -> dict:
    """Phases 8-10: the port's Trainer at the full r2_scale config, one step
    through the kernels against one through the plain versions, and one
    step under the profiler."""
    from druggen_tpu_torch.chem.vocab import Vocab
    from druggen_tpu_torch.config import InferenceConfig, TrainConfig
    from druggen_tpu_torch.data.dataset import BatchIterator
    from druggen_tpu_torch.infer.engine import InferenceEngine
    from druggen_tpu_torch.train.optim import AdamW
    from druggen_tpu_torch.train.step import TrainStep
    from druggen_tpu_torch.train.trainer import Trainer

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    with phase("8 training"):
        raw = os.path.join(tmp.name, f"chembl_like_{TRAIN_MOLECULES}.smi")
        with open(SMILES_FILE) as src, open(raw, "w") as dst:
            for _, line in zip(range(TRAIN_MOLECULES), src):
                dst.write(line)
        with open(TRAIN_VOCAB_JSON) as f:
            vocab = Vocab.from_json(f.read())
        # experiments/r2_scale/README.md "Config": batch 512, bf16,
        # --fused_mlp --fused_critic, seed 42; dim 128, depth 1, heads 8
        cfg = TrainConfig(
            raw_file=raw, drug_raw_file=DRUG_FILE, submodel="DrugGEN",
            batch_size=TRAIN_BATCH, epoch=1, compute_dtype="bfloat16",
            fused_mlp=True, fused_critic=True, log_sample_step=TRAIN_CADENCE,
            set_seed=True, seed=42, exp_name="chip_smoke",
            mol_data_dir=tmp.name, drug_data_dir=tmp.name,
            log_dir=os.path.join(tmp.name, "logs"),
            sample_dir=os.path.join(tmp.name, "samples"),
            model_save_dir=os.path.join(tmp.name, "models"), device="cuda")
        t0 = time.perf_counter()
        trainer = Trainer(cfg, vocab=vocab)
        print(f"   trainer set-up (featurise {len(trainer.data)} + "
              f"{len(trainer.drug_data)} molecules, drug fingerprints, models): "
              f"{time.perf_counter() - t0:.2f} s; m_dim {trainer.m_dim}, "
              f"b_dim {trainer.b_dim}, N {trainer.vertexes}")
        opts = (trainer.g_opt, trainer.d_opt)
        before = [o.flat.clone() for o in opts]
        torch.cuda.reset_peak_memory_stats()
        fwd.launches = 0
        bwd.launches = 0
        t0 = time.perf_counter()
        trainer.train(time_steps=True)
        wall = time.perf_counter() - t0
        launches = {"fused_ln_mlp_ln_fwd": fwd.launches,
                    "fused_ln_mlp_ln_bwd": bwd.launches}
        steps = trainer.step
        per_step = cfg.depth + 3 * (cfg.ddepth - 1)
        print(f"   launches: {launches} over {steps} steps (expected "
              f"{per_step} of each a step: G depth + 3 x (critic depth - 1), "
              f"the critic's last-block edge tail skipped)")
        if steps != TRAIN_MOLECULES // TRAIN_BATCH:
            raise AssertionError(f"{steps} steps, expected one epoch")
        if (launches["fused_ln_mlp_ln_fwd"] != per_step * steps
                or launches["fused_ln_mlp_ln_bwd"] != per_step * steps):
            raise AssertionError("the training run did not go through K1 and "
                                 "K2 the expected number of times")
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
        print(f"   training on {name} ({smi_line}): steady step {steady * 1e3:.2f} "
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
            mol_data_dir=tmp.name, output_dir=os.path.join(tmp.name, "inf"),
            compute_dtype="bfloat16", fused_mlp=True, device="cuda")
        engine = InferenceEngine(inf, vocab=vocab)
        trained = trainer.G.state_dict()
        same = all(torch.equal(v.cpu(), trained[k].cpu())
                   for k, v in engine.G.state_dict().items())
        kept, decoded = engine.sample(max_batches=1)
        print(f"   DrugGEN-G.ckpt -> InferenceEngine: weights bit-equal "
              f"{same}; one batch of {len(decoded)} graphs served, "
              f"{len(kept)} valid")
        if not same or len(decoded) != TRAIN_BATCH:
            raise AssertionError("the trained checkpoint did not serve")
        del engine

    with phase("9 step agreement"):
        x, a = next(iter(BatchIterator(trainer.data, TRAIN_BATCH, seed=SEED)))
        dx, da = next(iter(BatchIterator(trainer.drug_data, TRAIN_BATCH, seed=SEED)))
        g_opt = opts[0]
        tail = torch.cat([torch.full((p.numel(),), any(t in n for t in TAIL_PARAMS))
                          for n, p in zip(g_opt.names, g_opt.params)]).cuda()
        for dtype in (torch.bfloat16, torch.float32):
            snap = snapshot(opts)
            eps_gen = torch.Generator(device="cuda").manual_seed(SEED)
            eps = (torch.rand((TRAIN_BATCH, 1, 1), generator=eps_gen,
                              device="cuda", dtype=dtype),
                   torch.rand((TRAIN_BATCH, 1, 1, 1), generator=eps_gen,
                              device="cuda", dtype=dtype))
            results = {}
            for fused in (True, False):
                grads = []
                for o in opts:      # record the gradients each update takes
                    o.step = (lambda g, o=o: (grads.append(o.flat_grads(g)),
                                              AdamW.step(o, g)))
                step = TrainStep(trainer.G, trainer.D, *opts,
                                 lambda_gp=cfg.lambda_gp, m_dim=trainer.m_dim,
                                 b_dim=trainer.b_dim, submodel=cfg.submodel,
                                 compute_dtype=dtype, g_fused=fused,
                                 fused_critic=fused)
                fwd.launches = bwd.launches = 0
                out = step(x, a, dx, da, eps=eps)
                results[fused] = (out["d_loss"].float().item(),
                                  out["g_loss"].float().item(), grads,
                                  (fwd.launches, bwd.launches))
                for o in opts:
                    del o.step
                restore(opts, snap)
            (dk, gk, grads_k, lk), (dp, gp, grads_p, lp) = results[True], results[False]
            rel_d, rel_g = rel_err(grads_k[0], grads_p[0]), rel_err(grads_k[1], grads_p[1])
            rel_tail = rel_err(grads_k[1][tail], grads_p[1][tail])
            dl = abs(dk - dp) / max(1.0, abs(dp))
            gl = abs(gk - gp) / max(1.0, abs(gp))
            print(f"   {str(dtype):>14}: d_loss kernels {dk:.6f} plain {dp:.6f}; "
                  f"g_loss kernels {gk:.6f} plain {gp:.6f}; gradient rel. error "
                  f"D {rel_d:.3e}, G {rel_g:.3e}, G's edge tails {rel_tail:.3e}; "
                  f"launches (K1, K2) kernels {lk}, plain {lp}", flush=True)
            tol = TOL_STEP[dtype]
            if (max(dl, gl, rel_d, rel_g) > tol or rel_tail > TOL_TAIL[dtype]
                    or lp != (0, 0) or min(lk) < 1):
                raise AssertionError(f"step through the kernels disagrees with "
                                     f"the plain step ({dtype}): losses {dl}, "
                                     f"{gl}, gradients D {rel_d}, G {rel_g}, "
                                     f"G's edge tails {rel_tail}")

    with phase("10 step profile"):
        step = trainer.step_fn
        step(x, a, dx, da)
        step_ms = cuda_ms(lambda: step(x, a, dx, da), 3, warmup=1)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            step(x, a, dx, da)
            torch.cuda.synchronize()
        kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0]
        busy = sum(k[1] for k in kernels)
        k1_ms = sum(k[1] for k in kernels if "fused_ln_mlp_ln_fwd_kernel" in k[0])
        # K2's three launches (PyTorch has a reduce_kernel of its own)
        k2_ms = sum(k[1] for k in kernels if any(
            k[0].startswith(f"void (anonymous namespace)::{n}")
            for n in ("rows_kernel<", "wgrad_kernel<", "reduce_kernel(")))
        print(f"   training step, batch {TRAIN_BATCH}, bf16 + fused tails, on "
              f"{name} ({smi_line}): {step_ms:.3f} ms (CUDA events, mean of 3); "
              f"kernels {busy:.3f} ms; idle share "
              f"{max(0.0, 1 - busy / step_ms):.3f}; K1 {k1_ms:.3f} ms "
              f"({100 * k1_ms / max(busy, 1e-9):.1f}%), K2 {k2_ms:.3f} ms "
              f"({100 * k2_ms / max(busy, 1e-9):.1f}%)")
        for key, ms, count in sorted(kernels, key=lambda k: -k[1])[:10]:
            print(f"   {ms:8.3f} ms {100 * ms / busy:5.1f}% x{count:<3d} {key[:90]}")
        if not kernels:
            print("   the profiler recorded no device time")
    tmp.cleanup()
    return {"launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    sys.path.insert(0, REPO)
    from druggen_tpu_torch.chem.vocab import Vocab
    from druggen_tpu_torch.config import InferenceConfig
    from druggen_tpu_torch.data.dataset import BatchIterator
    from druggen_tpu_torch.infer.engine import InferenceEngine
    from druggen_tpu_torch.ops import _build
    from druggen_tpu_torch.ops.fused_mlp import (
        _bwd_lib,
        _kernel_lib,
        fused_ln_mlp_ln,
        fused_ln_mlp_ln_bwd,
        fused_ln_mlp_ln_bwd_reference,
        fused_ln_mlp_ln_reference,
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
        with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
            builds = list(pool.map(_build.build, KERNEL_SOURCES))
        for src, b in zip(KERNEL_SOURCES, builds):
            print(f"   {src}.cu: {b.seconds:.2f} s{' (cached)' if b.cached else ''}")
            for line in b.log.splitlines():
                if "registers" in line or "Compiling entry" in line:
                    print(f"   {line.strip()}")
        lib = _kernel_lib()
        print(f"   fused_mlp dynamic shared memory: bf16 "
              f"{lib.fused_ln_mlp_ln_fwd_smem_bytes(1)} B, f32 "
              f"{lib.fused_ln_mlp_ln_fwd_smem_bytes(0)} B a block", flush=True)
        blib = _bwd_lib()
        print(f"   fused_mlp_bwd rows pass dynamic shared memory: bf16 "
              f"{blib.fused_ln_mlp_ln_bwd_smem_bytes(1)} B, f32 "
              f"{blib.fused_ln_mlp_ln_bwd_smem_bytes(0)} B a block", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = tail_params(gen, "cuda")
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
        torch.cuda.empty_cache()

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    with phase("4 serving"):
        inf_smi = os.path.join(tmp.name, f"chembl_like_{SERVE_MOLECULES}.smi")
        with open(SMILES_FILE) as src, open(inf_smi, "w") as dst:
            for _, line in zip(range(SERVE_MOLECULES), src):
                dst.write(line)
        with open(VOCAB_JSON) as f:
            vocab = Vocab.from_json(f.read())
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

        fused_ln_mlp_ln.launches = fused_ln_mlp_ln_bwd.launches = 0
        results = engine.run()
        launches = {"fused_ln_mlp_ln_fwd": fused_ln_mlp_ln.launches,
                    "fused_ln_mlp_ln_bwd": fused_ln_mlp_ln_bwd.launches}

        n_batches = len(engine.timings)
        expected = cfg.depth * n_batches
        print(f"   launches: {launches} over {n_batches} batches "
              f"(expected depth x batches = {expected} forwards, no backward)")
        if n_batches != SERVE_BATCHES or launches["fused_ln_mlp_ln_fwd"] != expected:
            raise AssertionError("the serving run did not go through the "
                                 "fused kernel once per block per batch")
        if launches["fused_ln_mlp_ln_bwd"] != 0:
            raise AssertionError("the serving run launched the backward kernel")
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
        del engine32
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
        print(f"   fused_ln_mlp_ln_bwd bf16 rows {ROWS:,} on {name} ({smi_line}):")
        print(f"   kernel {kb_ms:.4f} ms (runs {kb_a:.4f}, {kb_b:.4f}); plain "
              f"{pb_ms:.4f} ms; eager autograd backward of the composite "
              f"{cb_ms:.4f} ms; bound {bound_b_ms:.4f} ms ({bound_b_by}); "
              f"kernel at {100 * bound_b_ms / kb_ms:.1f}% of the bound", flush=True)
        torch.cuda.empty_cache()

    with phase("7 profile"):
        x, a = next(iter(BatchIterator(engine.data, SERVE_BATCH, seed=cfg.seed)))
        fwd_ms = cuda_ms(lambda: engine.forward(a, x), 5)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            engine.forward(a, x)
            torch.cuda.synchronize()
        kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0]
        busy = sum(k[1] for k in kernels)
        print(f"   serving forward, batch {SERVE_BATCH}, bf16 + fused tail, "
              f"on {name} ({smi_line}): {fwd_ms:.3f} ms (CUDA events); "
              f"kernels {busy:.3f} ms; idle share "
              f"{max(0.0, 1 - busy / fwd_ms):.3f}")
        for key, ms, count in sorted(kernels, key=lambda k: -k[1])[:10]:
            print(f"   {ms:8.3f} ms {100 * ms / busy:5.1f}% x{count:<3d} {key[:90]}")
        if not kernels:
            print("   the profiler recorded no device time")

    train = training_phases(name, smi_line, fused_ln_mlp_ln, fused_ln_mlp_ln_bwd)

    record = {"kernels": [{
        "name": "fused_ln_mlp_ln_fwd",
        "route": "cuda",
        "source": "druggen_tpu_torch/ops/csrc/fused_mlp.cu",
        "replaces": "druggen_tpu/ops/fused_mlp.py:72",
        "launches": launches["fused_ln_mlp_ln_fwd"],
        "launches_by_path": {"serving": launches["fused_ln_mlp_ln_fwd"],
                             "training": train["launches"]["fused_ln_mlp_ln_fwd"]},
        "max_abs_err": k1["max_abs_err"],
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "fused_ln_mlp_ln_bwd",
        "route": "cuda",
        "source": "druggen_tpu_torch/ops/csrc/fused_mlp_bwd.cu",
        "replaces": "druggen_tpu/ops/fused_mlp.py:91",
        "launches": train["launches"]["fused_ln_mlp_ln_bwd"],
        "launches_by_path": {"serving": launches["fused_ln_mlp_ln_bwd"],
                             "training": train["launches"]["fused_ln_mlp_ln_bwd"]},
        "max_abs_err": k2["max_abs_err"],
        "ms": kb_ms,
        "plain_ms": pb_ms,
        "bound_ms": bound_b_ms,
        "bound_by": bound_b_by,
        "library_ms": None,
        "eager_autograd_ms": cb_ms,
    }]}
    print(json.dumps(record))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
