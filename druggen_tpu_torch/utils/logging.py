"""Structured training logs.

The reference logs through wandb + an append-only text file
(``train.py:272-281``, ``src/util/utils.py:338-354``).  Here the primary
sink is JSONL (machine-readable, no external service); a wandb adapter is
attached when wandb is importable and requested, mirroring the reference's
online/offline/disabled modes.

Copied from ``druggen_tpu/utils/logging.py``; imports point at this package.
"""

from __future__ import annotations

import datetime
import json
import os
import time


class RunLogger:
    """JSONL + human-readable text logging with optional wandb mirror."""

    def __init__(self, log_dir: str, run_name: str, use_wandb: bool = False,
                 online: bool = False, config: dict | None = None):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, f"{run_name}.jsonl")
        self.text_path = os.path.join(log_dir, f"{run_name}.txt")
        self.start_time = time.time()
        self._wandb = None
        if use_wandb:
            try:
                import wandb  # type: ignore

                mode = "online" if online else "offline"
                wandb.init(name=run_name, project="druggen_tpu",
                           config=config or {}, mode=mode, reinit=True)
                self._wandb = wandb
            except Exception as e:  # wandb genuinely optional
                print(f"wandb unavailable ({e}); JSONL logging only")

    def log(self, metrics: dict, step: int | None = None,
            echo: bool = True) -> None:
        rec = {"ts": time.time(), "elapsed": time.time() - self.start_time}
        if step is not None:
            rec["step"] = step
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics)
        if echo:
            et = str(datetime.timedelta(seconds=int(rec["elapsed"])))
            parts = [f"Elapsed [{et}]"]
            parts += [f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                      for k, v in metrics.items()]
            line = ", ".join(parts)
            with open(self.text_path, "a") as f:
                f.write(line + "\n")
            # flush: stdout is often a redirected log file whose block
            # buffering would otherwise hide progress for minutes
            print(line, flush=True)

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
