"""Inference engine (port of ``druggen_tpu/infer/engine.py:39-196``).

Load a trained generator, stream an inference dataset through it (one-hot
-> Generator -> argmax on the device; with ``use_pallas`` the Generator is
the whole-generator kernel K9, ``ops/fused_generator.py``, one wrapper call
a forward, as in JAX :89-107), decode the labels to molecules on the
host, keep the largest fragment with ``*``->``C``, loop until ``sample_num``
valid molecules are collected or the batch cap is hit, then report
validity, generator validity and uniqueness and write
``inference_drugs.csv``.  The report's other metrics and the SMILES
corrector are not ported yet.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from druggen_tpu_torch.chem.canon import mol_to_smiles
from druggen_tpu_torch.chem.codec import matrices_to_mol, strip_to_largest_fragment
from druggen_tpu_torch.chem.smiles import mol_from_smiles
from druggen_tpu_torch.chem.vocab import Vocab, get_vocab
from druggen_tpu_torch.config import InferenceConfig
from druggen_tpu_torch.data.dataset import BatchIterator, load_dataset
from druggen_tpu_torch.interop.msgpack_ckpt import read_flax_checkpoint
from druggen_tpu_torch.interop.weights import flax_generator_to_torch, to_torch_tensors
from druggen_tpu_torch.metrics import molecular as mm
from druggen_tpu_torch.models import Generator
from druggen_tpu_torch.ops.fused_generator import GeneratorWeights, fused_generator_logits

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device(device)``, raising if CUDA is asked for and absent
    (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} was requested but no CUDA "
                           "device is available; pass device='cpu' to run "
                           "on the CPU")
    return dev


class InferenceEngine:
    """``InferenceEngine(cfg, vocab=None, g_state_dict=None, device=None,
    compute_dtype=None)``.

    Weights come from ``g_state_dict`` (the port's Generator layout) or, if
    it is None, from ``<cfg.inference_model>/<cfg.submodel>-G.ckpt`` (the
    JAX package's flax msgpack file).  ``device`` and ``compute_dtype``
    default to ``cfg.device`` and ``cfg.compute_dtype``."""

    def __init__(self, cfg: InferenceConfig, vocab: Vocab | None = None,
                 g_state_dict: dict | None = None,
                 device: str | torch.device | None = None,
                 compute_dtype: str | torch.dtype | None = None):
        self.device = resolve_device(device or cfg.device)
        dtype = compute_dtype or cfg.compute_dtype
        self.compute_dtype = _DTYPES[dtype] if isinstance(dtype, str) else dtype
        if self.compute_dtype == torch.float32 and cfg.fused_mlp:
            # mirrors the JAX engine: its fused kernel measured slower than
            # the plain path at f32, so it turns the kernel off there
            warnings.warn("fused_mlp with compute_dtype=float32: disabling "
                          "fused_mlp (the JAX engine does the same). Use "
                          "bfloat16 to keep it.", stacklevel=2)
            cfg = dataclasses.replace(cfg, fused_mlp=False)
        self.cfg = cfg
        self.vocab = vocab or get_vocab(
            cfg.train_smiles, cfg.train_drug_smiles, cfg.max_atom,
            cache_dir=os.path.join(cfg.mol_data_dir, "vocab"),
            union_ref12=cfg.vocab_ref12)
        self.data = load_dataset(cfg.inf_smiles, self.vocab, cfg.max_atom,
                                 cfg.mol_data_dir)
        self.m_dim = self.vocab.m_dim
        self.b_dim = self.vocab.b_dim
        self.vertexes = int(self.data.x.shape[1])
        self.G = Generator(
            act=cfg.act, vertexes=self.vertexes, edges=self.b_dim,
            nodes=self.m_dim, dropout=cfg.dropout, dim=cfg.dim,
            depth=cfg.depth, heads=cfg.heads, mlp_ratio=cfg.mlp_ratio,
            dtype=None if self.compute_dtype == torch.float32
            else self.compute_dtype,
            fused_mlp=cfg.fused_mlp, use_pallas=cfg.use_pallas)
        if g_state_dict is None:
            path = os.path.join(cfg.inference_model, f"{cfg.submodel}-G.ckpt")
            g_state_dict = to_torch_tensors(
                flax_generator_to_torch(read_flax_checkpoint(path)))
        self.G.load_state_dict(g_state_dict)
        self.G.to(self.device).eval()
        # use_pallas: the forward runs K9 on these weights (packed at its
        # first call) and never the modules, whose flags only mirror JAX's G
        self.k9_weights = GeneratorWeights.of(self.G) if cfg.use_pallas else None
        # per-batch host-clock seconds of the last sample(): the device
        # window (labels in -> labels back, synchronised) and the decode
        self.timings: list[dict] = []

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def forward(self, a_labels, x_labels):
        """int labels ``a`` [B,N,N], ``x`` [B,N] (numpy or tensors) ->
        argmax ``(node_labels [B,N], edge_labels [B,N,N])`` int32 tensors
        on the engine's device."""
        a = torch.as_tensor(np.asarray(a_labels)).to(self.device).long()
        x = torch.as_tensor(np.asarray(x_labels)).to(self.device).long()
        a = F.one_hot(a, self.b_dim).to(self.compute_dtype)
        x = F.one_hot(x, self.m_dim).to(self.compute_dtype)
        if self.k9_weights is not None:
            # one-hot adjacencies of molecules are symmetric: K9's precondition
            node_logits, edge_logits = fused_generator_logits(
                self.k9_weights, a, x, heads=self.cfg.heads)
        else:
            _, _, node_logits, edge_logits = self.G(a, x)
        return (node_logits.argmax(-1).to(torch.int32),
                edge_logits.argmax(-1).to(torch.int32))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def sample(self, sample_num: int | None = None,
               max_batches: int | None = None, seed_offset: int = 0):
        """Run the sampling loop (reference inference.py:180-229).

        Keeps sampling until ``sample_num`` VALID molecules are collected,
        or ``max_batches``/``cfg.inf_max_batches`` batches ran, with the
        JAX engine's stagnation guard.  Returns ``(kept_smiles,
        all_decoded)`` (``None`` for each failed decode)."""
        cfg = self.cfg
        sample_num = sample_num or cfg.sample_num
        batch = max(cfg.inf_batch_size, 1)
        it = iter(BatchIterator(self.data, batch,
                                seed=cfg.seed + seed_offset, loop=True,
                                drop_last=True))
        kept: list[str] = []
        all_decoded: list[str | None] = []
        self.timings = []
        n_batches = 0
        none_counter = 0
        limit = max_batches or cfg.inf_max_batches or 0
        stall_batches = max(200, 2 * sample_num // batch)
        last_progress_batch = 0
        while len(kept) < sample_num and (limit == 0 or n_batches < limit):
            if n_batches - last_progress_batch >= stall_batches:
                print(f"sampling stalled: no valid molecule in the last "
                      f"{stall_batches} batches "
                      f"({len(kept)}/{sample_num} collected) — stopping",
                      flush=True)
                break
            x, a = next(it)
            t0 = time.perf_counter()
            n_labels, e_labels = self.forward(a, x)
            n_labels = n_labels.cpu().numpy()
            e_labels = e_labels.cpu().numpy()
            self._sync()
            t1 = time.perf_counter()
            for bi in range(batch):
                mol = matrices_to_mol(n_labels[bi], e_labels[bi], self.vocab,
                                      strict=False)
                smi = None if mol is None else mol_to_smiles(mol)
                if smi is not None:
                    smi = strip_to_largest_fragment(smi)
                    if mol_from_smiles(smi) is None:
                        smi = None
                if smi is None:
                    none_counter += 1
                    all_decoded.append(None)
                else:
                    kept.append(smi)
                    all_decoded.append(smi)
                    last_progress_batch = n_batches
                if len(kept) >= sample_num:
                    break
            self.timings.append({"graphs": batch, "forward_s": t1 - t0,
                                 "decode_s": time.perf_counter() - t1})
            n_batches += 1
            if none_counter >= sample_num and not kept:
                break
        return kept, all_decoded

    # ------------------------------------------------------------------
    def run(self) -> dict:
        """Sampling + the ported part of the report (reference
        inference.py:141-290)."""
        cfg = self.cfg
        if not cfg.disable_correction:
            raise NotImplementedError("SMILES correction is not ported yet")
        out_dir = os.path.join(cfg.output_dir, cfg.submodel)
        os.makedirs(out_dir, exist_ok=True)
        t0 = time.time()
        kept, all_decoded = self.sample()
        print(f"Inference lasted {time.time() - t0:.2f} seconds "
              f"({len(kept)} raw)")
        results = {
            "submodel": cfg.submodel,
            "validity": round(mm.fraction_valid(kept), 3),
            "generator_validity": round(
                len(kept) / max(len(all_decoded), 1), 3),
            "uniqueness": round(mm.fraction_unique(kept), 3),
        }
        for k, v in results.items():
            print(f"{k}: {v}")
        self._write_csv(os.path.join(out_dir, "inference_results.csv"),
                        [results])
        self._write_csv(os.path.join(out_dir, "inference_drugs.csv"),
                        [{"SMILES": s} for s in kept])
        return results

    @staticmethod
    def _write_csv(path: str, rows: list[dict]) -> None:
        if not rows:
            with open(path, "w") as f:
                f.write("SMILES\n")
            return
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
