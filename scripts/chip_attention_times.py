#!/usr/bin/env python3
"""Time K5 and K6 of one checkout of the PyTorch port on the card, K6 by launch.

    python3 scripts/chip_attention_times.py [--root DIR]

``DIR`` is the root of a checkout of this repository (default: this one),
for example an older commit unpacked with ``git archive``: its
``druggen_tpu_torch`` is imported and its kernels built.  The inputs,
timing and bounds are this checkout's ``chip_smoke.py`` helpers, so two
checkouts run in turns in one call (older, newer, newer, older) are timed
the same way on the same card.  At the training shape (512 graphs of 45
atoms, D 128, 8 heads, bf16) it prints the card's name and power limit, then
one JSON line: K5's and K6's CUDA-event milliseconds (mean of two runs), K6
by launch under ``torch.profiler`` (the Hopper route's stats, rows, node,
wgrad and reduce; the CUDA-core route's rows, deraw, wgrad and reduce), each launch's
registers and spills as ``-Xptxas -v`` printed them, and the bounds.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every K6 launch of either route, by the pattern its kernel's name contains
K6_ANY_ROUTE = {"stats": "attn_bwd_stats", "rows": "attn_bwd_rows", "deraw": "attn_bwd_deraw",
                "node": "attn_bwd_node", "wgrad": "attn_bwd_wgrad", "reduce": "attn_bwd_reduce"}


def ptxas_usage(log: str) -> dict:
    """``{mangled kernel name: (registers, spill store bytes)}`` from nvcc's
    ``-Xptxas -v`` output."""
    out, name, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), spill)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO, help="root of the checkout to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_attention_times: needs a CUDA card")
    root = os.path.abspath(args.root)
    sys.path.insert(0, REPO)
    import chip_smoke as cs   # this checkout's helpers (it imports no port module)
    sys.path.insert(0, root)
    from druggen_tpu_torch.ops import _build
    from druggen_tpu_torch.ops import fused_attention as fa
    if not os.path.abspath(fa.__file__).startswith(root + os.sep):
        raise SystemExit(f"imported {fa.__file__}, not the checkout at {root}")

    torch.backends.cuda.matmul.allow_tf32 = False
    usage = {}
    for src in ("fused_attention", "fused_attention_bwd"):
        for kname, u in ptxas_usage(_build.build(src).log).items():
            if "bfloat16" in kname or "wgmma" in kname or "reduce" in kname:
                usage[kname] = u
    b, n, d, dt = cs.TRAIN_BATCH, cs.N_ATOMS, cs.DIM, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    acts, params, (ge, gn) = cs.attn_inputs(b, n, d, dt, gen)
    t_res = fa.edge_attention_fwd(*acts, *params, cs.HEADS)[2]

    def k5():
        fa.edge_attention_fwd(*acts, *params, cs.HEADS)

    def k6():
        fa.edge_attention_bwd(*acts, *params[:3], t_res, ge, gn, cs.HEADS)

    with torch.no_grad():
        k5_a, k6_a = cs.cuda_ms(k5, 20), cs.cuda_ms(k6, 10)
        k5_b, k6_b = cs.cuda_ms(k5, 20), cs.cuda_ms(k6, 10)
        split = cs.launch_split(k6, K6_ANY_ROUTE, required=("rows", "wgrad", "reduce"))
    (b5, by5, _, e5), (b6, by6, _, e6) = cs.attn_bounds(b, n, d, dt)
    print(cs.nvidia_smi_line())
    print(json.dumps({
        "root": root, "device": torch.cuda.get_device_name(0),
        "shape": {"batch": b, "n": n, "d": d, "heads": cs.HEADS, "dtype": "bf16"},
        "k5_ms": [k5_a, k5_b], "k6_ms": [k6_a, k6_b],
        "k6_by_launch_ms": {k: v for k, v in split.items() if v > 0},
        "bound_ms": {"k5": b5, "k6": b6, "by": [by5, by6],
                     "earlier_pricing": {"k5": e5, "k6": e6}},
        "ptxas": {k: {"registers": r, "spill_store_bytes": sp} for k, (r, sp) in usage.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
