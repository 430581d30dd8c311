"""Inference engine (port of ``druggen_tpu/infer/engine.py``).

Load a trained generator, stream an inference dataset through it (one-hot
-> Generator -> argmax on the device; with ``use_pallas`` the Generator is
the whole-generator kernel K9, ``ops/fused_generator.py``, one wrapper call
a forward, as in JAX :89-107), decode the labels to molecules on the
host, keep the largest fragment with ``*``->``C``, loop until ``sample_num``
valid molecules are collected or the batch cap is hit.  ``run()`` then
corrects the set with the rule-based :class:`..infer.corrector.SmilesCorrector`
(unless ``disable_correction``), tops it up with fresh samples until it
reaches ``sample_num``, computes the 14-key report and writes
``inference_drugs.csv`` and ``inference_results.csv``, as the JAX engine
does.  The report's Tanimoto products (SNN, IntDiv) run on the engine's
device.
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
from druggen_tpu_torch.chem.fingerprints import fingerprints_for_smiles, morgan_fingerprint
from druggen_tpu_torch.chem.smiles import mol_from_smiles
from druggen_tpu_torch.chem.vocab import Vocab, get_vocab, read_smiles_file
from druggen_tpu_torch.config import InferenceConfig
from druggen_tpu_torch.data.dataset import BatchIterator, load_dataset
from druggen_tpu_torch.infer.corrector import SmilesCorrector
from druggen_tpu_torch.metrics import molecular as mm
from druggen_tpu_torch.metrics.descriptor_metrics import mean_qed, mean_sa
from druggen_tpu_torch.models import Generator
from druggen_tpu_torch.ops.fused_generator import GeneratorWeights, fused_generator_logits
from druggen_tpu_torch.train.checkpoint import load_params_auto

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
    JAX package's flax msgpack file, unrolled or stacked);
    :meth:`load_generator` swaps them for another checkpoint's.  ``device``
    and ``compute_dtype`` default to ``cfg.device`` and
    ``cfg.compute_dtype``."""

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
            g_state_dict = load_params_auto(
                os.path.join(cfg.inference_model, f"{cfg.submodel}-G.ckpt"))
        self.G.to(self.device).eval()
        self.load_generator(g_state_dict)
        # per-batch host-clock seconds of every sample() since the last
        # run() began: the device window (labels in -> labels back,
        # synchronised) and the decode
        self.timings: list[dict] = []
        # host-clock seconds of the last run() by stage, and its top-up rounds
        self.run_seconds: dict[str, float] = {}
        self.topup_rounds = 0

    def load_generator(self, g_state_dict: dict) -> None:
        """Serve ``g_state_dict``'s weights (the port's Generator layout, e.g.
        ``train.checkpoint.load_params_auto`` of a cadence export) from now
        on: they are copied into G, and under ``use_pallas`` K9's weights
        are taken from G anew (their packed buffers with them)."""
        self.G.load_state_dict(g_state_dict)
        # use_pallas: the forward runs K9 on these weights (packed at its
        # first call) and never the modules, whose flags only mirror JAX's G
        self.k9_weights = (GeneratorWeights.of(self.G) if self.cfg.use_pallas
                           else None)

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
        JAX engine's stagnation guard.  ``seed_offset`` shifts the shuffle
        seed (the top-up rounds' fresh stream).  Returns ``(kept_smiles,
        all_decoded [None for each failed decode], node_label_rows,
        real_mols_first_per_batch)``, as the JAX engine does."""
        cfg = self.cfg
        sample_num = sample_num or cfg.sample_num
        batch = max(cfg.inf_batch_size, 1)
        it = iter(BatchIterator(self.data, batch,
                                seed=cfg.seed + seed_offset, loop=True,
                                drop_last=True))
        kept: list[str] = []
        all_decoded: list[str | None] = []
        node_rows: list[np.ndarray] = []
        real_first: list = []
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
                    node_rows.append(n_labels[bi])
                    last_progress_batch = n_batches
                if len(kept) >= sample_num:
                    break
            # real molecule bookkeeping for SNN (reference keeps the first
            # real mol of each batch, inference.py:225)
            real = matrices_to_mol(np.asarray(x)[0], np.asarray(a)[0],
                                   self.vocab, strict=True)
            if real is not None:
                real_first.append(real)
            self.timings.append({"graphs": batch, "forward_s": t1 - t0,
                                 "decode_s": time.perf_counter() - t1})
            n_batches += 1
            if none_counter >= sample_num and not kept:
                break
        return kept, all_decoded, node_rows, real_first

    # ------------------------------------------------------------------
    def run(self) -> dict:
        """Full inference + metric report (reference inference.py:141-290;
        JAX ``engine.py:198-302``)."""
        cfg = self.cfg
        out_dir = os.path.join(cfg.output_dir, cfg.submodel)
        os.makedirs(out_dir, exist_ok=True)
        self.timings = []
        self.topup_rounds = 0
        secs = self.run_seconds = {}
        clock = time.perf_counter()

        def lap(name: str) -> None:
            nonlocal clock
            now = time.perf_counter()
            secs[name] = now - clock
            clock = now

        chembl_smiles = read_smiles_file(cfg.train_smiles)
        chembl_test = read_smiles_file(cfg.inf_smiles)
        drug_smiles = read_smiles_file(cfg.train_drug_smiles)
        drug_fps = fingerprints_for_smiles(drug_smiles)
        lap("references")

        t0 = time.time()
        kept, all_decoded, node_rows, real_first = self.sample()
        lap("sampling")
        gen_smi = kept
        if not cfg.disable_correction:
            corrector = SmilesCorrector.default(out_dir)
            gen_smi = corrector.correct(kept)
            # the correction dedupes, so the delivered set can shrink below
            # sample_num: top up with fresh samples until it reaches it
            # (JAX engine.py:212-242)
            rounds = 0
            while len(gen_smi) < cfg.sample_num and rounds < 20:
                rounds += 1
                need = cfg.sample_num - len(gen_smi)
                ex_kept, ex_dec, ex_rows, _ = self.sample(
                    sample_num=max(2 * need, 64), seed_offset=rounds)
                if not ex_kept:
                    break
                kept += ex_kept
                all_decoded += ex_dec
                node_rows += ex_rows
                have = set(gen_smi)
                for s in corrector.correct(ex_kept):
                    if s not in have:
                        have.add(s)
                        gen_smi.append(s)
                        if len(gen_smi) >= cfg.sample_num:
                            break
                print(f"correction top-up round {rounds}: "
                      f"{len(gen_smi)}/{cfg.sample_num}", flush=True)
            self.topup_rounds = rounds
            lap("correction")
        elapsed = time.time() - t0
        print(f"Inference lasted {elapsed:.2f} seconds "
              f"({len(kept)} raw, {len(gen_smi)} after correction)")

        gen_fps = fingerprints_for_smiles(kept)
        real_fps = (np.stack([morgan_fingerprint(m) for m in real_first])
                    if real_first else np.zeros((0, 1024), np.uint8))
        lap("fingerprints")

        sample_num = cfg.sample_num
        if not cfg.disable_correction:
            validity = round(len(gen_smi) / sample_num, 3)
        else:
            validity = round(mm.fraction_valid(gen_smi), 3)

        # the keys in the JAX engine's order, each report group timed
        results = {
            "submodel": cfg.submodel,
            "validity": validity,
            "generator_validity": round(
                len(kept) / max(len(all_decoded), 1), 3),
            "uniqueness": round(mm.fraction_unique(gen_smi), 3),
        }
        lap("validity_uniqueness")
        results["novelty"] = round(mm.novelty(
            gen_smi, chembl_smiles,
            train_canon=mm.canonical_set(
                chembl_smiles, n_jobs=2, cache_for=cfg.train_smiles)), 3)
        results["novelty_inference"] = round(mm.novelty(
            gen_smi, chembl_test,
            train_canon=mm.canonical_set(
                chembl_test, n_jobs=2, cache_for=cfg.inf_smiles)), 3)
        results["novelty_real_inhibitor"] = round(
            mm.novelty(gen_smi, drug_smiles), 3)
        lap("novelty")
        results["ave_len"] = round(mm.max_component(gen_smi, self.vertexes), 3)
        results["mean_atom_type"] = (round(mm.mean_atom_type(node_rows), 3)
                                     if node_rows else 0.0)
        lap("ave_len_atom_type")
        results["snn_chembl"] = (round(mm.average_agg_tanimoto(
            real_fps, gen_fps, device=self.device), 3)
            if len(real_fps) and len(gen_fps) else 0.0)
        results["snn_real_inhibitor"] = (round(mm.average_agg_tanimoto(
            drug_fps, gen_fps, device=self.device), 3)
            if len(drug_fps) and len(gen_fps) else 0.0)
        lap("snn")
        results["IntDiv"] = (round(mm.internal_diversity(
            gen_fps, device=self.device)[0], 3) if len(gen_fps) else 0.0)
        lap("int_div")
        results["qed"] = round(mean_qed(gen_smi), 3)
        lap("qed")
        results["sa"] = round(mean_sa(gen_smi), 3)
        lap("sa")
        for k, v in results.items():
            print(f"{k}: {v}")

        # CSV outputs (reference inference.py:280-290)
        self._write_csv(os.path.join(out_dir, "inference_results.csv"),
                        [results])
        self._write_csv(os.path.join(out_dir, "inference_drugs.csv"),
                        [{"SMILES": s} for s in gen_smi])
        lap("csv")
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
