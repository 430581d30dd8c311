"""Inference configuration of the port.

Copied from ``druggen_tpu/config.py`` (``InferenceConfig``,
``parse_inference_args`` and their helpers) with one flag added:
``--device`` (default ``cuda``).  ``platform`` is kept so that the JAX CLI's
command lines parse unchanged; the port ignores it and runs on ``device``.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass


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
    use_pallas: bool = False             # whole-generator kernel: not ported
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
