"""SMILES correction pipeline (port of ``druggen_tpu/infer/corrector.py``).

The reference ships a pretrained seq2seq SMILES-token transformer
(``src/util/smiles_cor.py``, adapted from LindeSchoenmaker/SMILES-corrector)
that rewrites invalid SMILES into valid ones, then standardizes + dedupes
(``smiles_cor.py:1219-1283``).  :class:`SmilesCorrector` runs that
pipeline term for term: split valid from invalid, rewrite the invalid ones
with the neural corrector when one is attached (one ``translate_batch`` on
its device), standardize (largest fragment, re-canonicalize), dedupe in
order, drop what does not parse, write ``corrected.smi``.

:meth:`SmilesCorrector.default` attaches a neural corrector from the JAX
package's variables: ``$DRUGGEN_REFERENCE_CORRECTOR`` (a trained
reference-topology directory, or ``model.pkg:src_vocab.pth:trg_vocab.pth``)
first, then ``$DRUGGEN_CORRECTOR_CKPT`` (a :class:`..infer.seq2seq.
Seq2SeqCorrector` directory).  Where the JAX package prints "unavailable"
and corrects with the rules alone, or ignores a checkpoint path that does
not exist, the port raises, naming the variable and the cause.
"""

from __future__ import annotations

import os

import torch

from druggen_tpu_torch.chem.canon import canonical_smiles
from druggen_tpu_torch.chem.codec import strip_to_largest_fragment
from druggen_tpu_torch.chem.smiles import mol_from_smiles

REFERENCE_VAR = "DRUGGEN_REFERENCE_CORRECTOR"
CKPT_VAR = "DRUGGEN_CORRECTOR_CKPT"


class SmilesCorrector:
    def __init__(self, out_dir: str | None = None, neural=None):
        self.out_dir = out_dir
        self.neural = neural          # optional Seq2SeqCorrector / ReferenceCorrector

    @classmethod
    def default(cls, out_dir: str | None = None,
                device: str | torch.device = "cuda") -> "SmilesCorrector":
        """Rule-based pipeline; attaches a neural corrector, on ``device``,
        when one is configured:

        - ``$DRUGGEN_REFERENCE_CORRECTOR`` — a directory trained by
          ``train_corrector --arch reference``, or the
          ``model.pkg:src_vocab.pth:trg_vocab.pth`` paths of the reference's
          released corrector (e.g. PAPYRUS_200), run through
          :class:`..interop.corrector_ckpt.ReferenceCorrector`; it takes
          precedence;
        - ``$DRUGGEN_CORRECTOR_CKPT`` — a Seq2SeqCorrector directory written
          by ``train_corrector``.

        A configured corrector that does not load raises ``RuntimeError``
        naming the variable."""
        ref_spec = os.environ.get(REFERENCE_VAR, "")
        ckpt_path = os.environ.get(CKPT_VAR, "")
        if ref_spec:
            from druggen_tpu_torch.interop.corrector_ckpt import ReferenceCorrector

            try:
                if os.path.isdir(ref_spec):
                    neural = ReferenceCorrector.load_trained(ref_spec, device=device)
                else:
                    parts = ref_spec.split(":")
                    if len(parts) != 3:
                        raise ValueError("expected a trained directory or "
                                         "model.pkg:src_vocab.pth:trg_vocab.pth")
                    neural = ReferenceCorrector.load(*parts, device=device)
            except Exception as e:      # any failure to load: name the variable
                raise RuntimeError(f"${REFERENCE_VAR}={ref_spec!r} does not load "
                                   f"({type(e).__name__}: {e})") from e
            return cls(out_dir, neural)
        if ckpt_path:
            from druggen_tpu_torch.infer.seq2seq import Seq2SeqCorrector

            try:
                if not os.path.isdir(ckpt_path):
                    raise FileNotFoundError("no such directory")
                neural = Seq2SeqCorrector.load(ckpt_path, device=device)
            except Exception as e:      # any failure to load: name the variable
                raise RuntimeError(f"${CKPT_VAR}={ckpt_path!r} does not load "
                                   f"({type(e).__name__}: {e})") from e
            return cls(out_dir, neural)
        return cls(out_dir)

    def correct(self, smiles_list: list[str]) -> list[str]:
        """Reference ``smi_correct.correct`` semantics
        (``smiles_cor.py:1262-1283``): split valid/invalid, neural-correct
        the invalid when a corrector is attached, standardize, dedupe
        (keeping order)."""
        valid, invalid = [], []
        for s in smiles_list:
            if s is None:
                continue
            if mol_from_smiles(s) is not None:
                valid.append(s)
            else:
                invalid.append(s)
        if self.neural is not None and invalid:
            for fixed in self.neural.translate_batch(invalid):
                if fixed and mol_from_smiles(fixed) is not None:
                    valid.append(fixed)

        out: list[str] = []
        seen: set[str] = set()
        for s in valid:
            std = self.standardize(s)
            if std is None or std in seen:
                continue
            seen.add(std)
            out.append(std)
        if self.out_dir:
            os.makedirs(self.out_dir, exist_ok=True)
            with open(os.path.join(self.out_dir, "corrected.smi"), "w") as f:
                f.write("\n".join(out) + ("\n" if out else ""))
        return out

    @staticmethod
    def standardize(smiles: str) -> str | None:
        """Standardization + desalting (the reference delegates to
        chembl_structure_pipeline, ``smiles_cor.py:1240-1260``): keep the
        largest fragment, re-canonicalize."""
        frag = strip_to_largest_fragment(smiles)
        return canonical_smiles(frag)
