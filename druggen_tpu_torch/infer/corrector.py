"""SMILES correction pipeline (port of ``druggen_tpu/infer/corrector.py``,
the rule path).

The reference rewrites invalid SMILES with a pretrained seq2seq corrector,
then standardizes and dedupes (``smiles_cor.py:1219-1283``).  The JAX
package's default, with no corrector configured, is the rule path, which is
what :class:`SmilesCorrector` runs term for term: split valid from invalid,
standardize (largest fragment, re-canonicalize), dedupe in order, drop what
does not parse, write ``corrected.smi``.

The neural correctors the JAX package can attach (``$DRUGGEN_CORRECTOR_CKPT``,
``$DRUGGEN_REFERENCE_CORRECTOR``) are not ported: :meth:`SmilesCorrector.default`
raises when either variable is set rather than correct without them.  The
serving path hands the corrector only SMILES that already parse
(``engine.py``'s ``sample``), so there the neural hook would have nothing to
rewrite.
"""

from __future__ import annotations

import os

from druggen_tpu_torch.chem.canon import canonical_smiles
from druggen_tpu_torch.chem.codec import strip_to_largest_fragment
from druggen_tpu_torch.chem.smiles import mol_from_smiles

NEURAL_CORRECTOR_VARS = ("DRUGGEN_REFERENCE_CORRECTOR", "DRUGGEN_CORRECTOR_CKPT")


class SmilesCorrector:
    def __init__(self, out_dir: str | None = None):
        self.out_dir = out_dir

    @classmethod
    def default(cls, out_dir: str | None = None) -> "SmilesCorrector":
        """The rule-based pipeline.  Raises ``NotImplementedError`` if a
        neural corrector is configured (``$DRUGGEN_REFERENCE_CORRECTOR`` or
        ``$DRUGGEN_CORRECTOR_CKPT`` set): the port has none yet."""
        configured = [v for v in NEURAL_CORRECTOR_VARS if os.environ.get(v)]
        if configured:
            raise NotImplementedError(
                f"{', '.join(configured)} set: the neural SMILES correctors "
                "are not ported to druggen_tpu_torch yet (ROADMAP queue A, "
                "item 1); unset it to correct with the rule path")
        return cls(out_dir)

    def correct(self, smiles_list: list[str]) -> list[str]:
        """Reference ``smi_correct.correct`` semantics
        (``smiles_cor.py:1262-1283``) without the neural step: keep the
        SMILES that parse, standardize, dedupe (keeping order)."""
        valid = [s for s in smiles_list
                 if s is not None and mol_from_smiles(s) is not None]
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
