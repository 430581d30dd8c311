#!/usr/bin/env python3
"""Drive the PyTorch port (``druggen_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printed with its wall time; any failure raises and the script
exits non-zero without printing a result line:

1. device   — card name, count and ``nvidia-smi`` name/power limit.
2. build    — compile every kernel source with nvcc (``-Xptxas -v``).
3. kernels  — each kernel against its plain PyTorch version on the card, at
               the serving shape (bf16 and f32) and on a ragged row count.
4. serving  — the port's ``InferenceEngine.run()`` on the trained r2_scale
               Generator (bf16, fused edge tail), 4 batches of 512 graphs;
               the kernel launch counts of that run are checked.
5. agree    — kernel path vs the plain bf16 path on one batch (labels).
6. timing   — each kernel, its plain version and the eager composite, CUDA
               events, beside the card's bound.
7. profile  — one serving forward under torch.profiler: device time by
               kernel and the card's idle share of the forward.

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

SEED = 0
SERVE_BATCH = 512           # graphs per request batch
SERVE_BATCHES = 4
SERVE_MOLECULES = 4096      # first molecules of the corpus used as inputs
N_ATOMS, DIM, HIDDEN = 45, 128, 384
ROWS = SERVE_BATCH * N_ATOMS * N_ATOMS      # 1,036,800 edge rows per batch
RAGGED_ROWS = 1000
# kernel vs plain, compared in f32.  bf16: the sums run in another order and
# an output of |y| <= 4 is worth ~2 bf16 ulps (2 * 2^-6); f32: order only.
TOL_BF16_MAX, TOL_BF16_MEAN, TOL_F32_MAX = 3e-2, 2e-3, 1e-4
MIN_LABEL_AGREEMENT = 0.999
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and dense bf16 FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

KERNEL_SOURCES = ("fused_mlp",)


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
        _kernel_lib,
        fused_ln_mlp_ln,
        fused_ln_mlp_ln_reference,
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

        fused_ln_mlp_ln.launches = 0
        results = engine.run()
        launches = {"fused_ln_mlp_ln_fwd": fused_ln_mlp_ln.launches}

        n_batches = len(engine.timings)
        expected = cfg.depth * n_batches
        print(f"   launches: {launches} over {n_batches} batches "
              f"(expected depth x batches = {expected})")
        if n_batches != SERVE_BATCHES or launches["fused_ln_mlp_ln_fwd"] != expected:
            raise AssertionError("the serving run did not go through the "
                                 "fused kernel once per block per batch")
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

    record = {"kernels": [{
        "name": "fused_ln_mlp_ln_fwd",
        "route": "cuda",
        "source": "druggen_tpu_torch/ops/csrc/fused_mlp.cu",
        "replaces": "druggen_tpu/ops/fused_mlp.py:72",
        "launches": launches["fused_ln_mlp_ln_fwd"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}
    print(json.dumps(record))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
