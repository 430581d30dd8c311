"""QED structural-alert catalogue (SMARTS-based).

Copied from ``druggen_tpu/chem/alerts.py``; imports point at this package.

QED's ALERTS descriptor counts how many entries of the Bickerton et al.
2012 structural-alert list (the Brenk 2008 unwanted-functionality set, 94
SMARTS) match the molecule — RDKit's ``qed`` does one
``HasSubstructMatch`` per alert and sums the booleans.  The reference gets
this through ``rdkit.Chem.QED`` (``reference/inference.py:264``).

This table re-derives the catalogue's chemistry for the from-scratch
SMARTS engine: each entry encodes one published alert class (reactive or
promiscuity-prone functionality).  The rare tail of the original 94 is
represented by its most general member, so ALERTS counts on drug-like
molecules track RDKit's closely (see tests/test_smarts.py).
"""

from __future__ import annotations

from druggen_tpu_torch.chem.mol import Mol
from druggen_tpu_torch.chem.smarts import MolFeatures, compile_smarts

_ALERT_SMARTS: tuple[tuple[str, str], ...] = (
    ("acyl_halide", "[CX3](=[OX1])[F,Cl,Br,I]"),
    ("aldehyde", "[CX3H1](=[OX1])[#6]"),
    ("aliphatic_long_chain", "[CX4H2][CX4H2][CX4H2][CX4H2][CX4H2][CX4H2]"),
    ("alkyl_halide_activated", "[CX4H2]([F,Cl,Br,I])[CX3]=[OX1]"),
    ("anhydride", "[CX3](=[OX1])[OX2][CX3]=[OX1]"),
    ("aniline_unsubstituted", "[NX3H2]c"),
    ("azide", "[NX2]=[NX2+]=[NX1-]"),
    ("azo", "[NX2]=[NX2]"),
    ("aziridine", "[CX4]1[NX3][CX4]1"),
    ("beta_lactam", "[CX3]1(=[OX1])[CX4][CX4][NX3]1"),
    ("carbamic_acid", "[NX3][CX3](=[OX1])[OX2H1]"),
    ("carbazide", "[NX3][NX3][CX3](=[OX1])[NX3][NX3]"),
    ("charged_oxygen_sulfur", "[O+,o+,S+,s+]"),
    ("chloramine", "[NX3][Cl]"),
    ("crown_ether_motif", "[OX2][CX4][CX4][OX2][CX4][CX4][OX2]"),
    ("cyanamide", "[NX3][CX2]#[NX1]"),
    ("diazonium", "[NX2+]#[NX1]"),
    ("diketo", "[CX3](=[OX1])[CX3](=[OX1])"),
    ("disulfide", "[SX2][SX2]"),
    ("enamine_unhindered", "[NX3][CX3]=[CX3H2]"),
    ("enol_ether_acyclic", "[CX3H2]=[CX3][OX2][CX4]"),
    ("epoxide", "[CX4]1[OX2][CX4]1"),
    ("ester_of_HOBT", "[OX2][NX3]"),
    ("halogenated_ring_heavy", "c([F,Cl,Br,I])c([F,Cl,Br,I])c([F,Cl,Br,I])"),
    ("heavy_metal", "[#80,#82,#48,#33,#34,#50,#51]"),
    ("hydantoin", "[CX3]1(=[OX1])[NX3][CX3](=[OX1])[NX3][CX4]1"),
    ("hydrazine", "[NX3H1,NX3H2][NX3H1,NX3H2]"),
    ("hydroquinone", "[OX2H1]c1ccc([OX2H1])cc1"),
    ("hydroxamic_acid", "[CX3](=[OX1])[NX3][OX2H1]"),
    ("imine_acyclic", "[CX4][NX2]=[CX3H1][#6]"),
    ("iodine", "[I]"),
    ("isocyanate", "[NX2]=[CX2]=[OX1]"),
    ("isothiocyanate", "[NX2]=[CX2]=[SX1]"),
    ("isonitrile", "[NX2+]#[CX1-]"),
    ("ketene", "[CX3]=[CX2]=[OX1]"),
    ("michael_acceptor_cyano", "[CX3]=[CX3][CX2]#[NX1]"),
    ("michael_acceptor_keto", "[CX3H1,CX3H2]=[CX3][CX3]=[OX1]"),
    ("michael_acceptor_nitro", "[CX3]=[CX3][NX3+](=[OX1])[OX1-]"),
    ("michael_acceptor_sulfonyl", "[CX3]=[CX3][SX4](=[OX1])=[OX1]"),
    ("n_oxide", "[NX3+][OX1-]"),
    ("nitro", "[NX3+](=[OX1])[OX1-]"),
    ("nitroso", "[NX2]=[OX1]"),
    ("oxime", "[CX3]=[NX2][OX2H1]"),
    ("perfluorinated", "[CX4]([F])([F])[CX4]([F])[F]"),
    ("peroxide", "[OX2][OX2]"),
    ("phosphor_ester", "[PX4](=[OX1])([OX2])[OX2]"),
    ("phosphorane", "[PX5]"),
    ("polyene", "[CX3]=[CX3][CX3]=[CX3][CX3]=[CX3]"),
    ("quaternary_nitrogen", "[NX4+]"),
    ("quinone_para", "[OX1]=C1C=CC(=[OX1])C=C1"),
    ("quinone_ortho", "[OX1]=C1C(=[OX1])C=CC=C1"),
    ("stilbene", "c[CX3H1]=[CX3H1]c"),
    ("sulfonic_acid", "[SX4](=[OX1])(=[OX1])[OX2H1]"),
    ("sulfonyl_halide", "[SX4](=[OX1])(=[OX1])[F,Cl,Br,I]"),
    ("sulfate_ester", "[SX4](=[OX1])(=[OX1])([OX2])[OX2]"),
    ("thiocarbonyl", "[#6]=[SX1]"),
    ("thiocyanate", "[SX2][CX2]#[NX1]"),
    ("thioester", "[SX2][CX3]=[OX1]"),
    ("thiol", "[SX2H1]"),
    ("triphenyl_methyl", "[CX4](c)(c)c"),
    ("vinyl_halide", "[CX3]=[CX3][F,Cl,Br,I]"),
    # ---- round-3 expansion: Brenk/QED alerts that fire on ordinary
    # drug-like chemistry (the earlier catalogue under-counted vs the
    # published 116-SMARTS list; these entries are its most frequently
    # firing members)
    ("alkyl_halide", "[CX4][Cl,Br,I]"),
    ("triple_bond", "C#C"),
    ("acyclic_imine", "[C;!R]=[N;!R]"),
    ("acyclic_nn", "[N;!R]=[N;!R]"),
    ("isolated_alkene",
     "[$([CH2]),$([CH][CX4]),$(C([CX4])[CX4])]="
     "[$([CH2]),$([CH][CX4]),$(C([CX4])[CX4])]"),
    ("catechol", "c1ccc([OX2H1])c([OX2H1])c1"),
    ("phenol_ester", "c[OX2][CX3]=[OX1]"),
    ("cycloheptane", "[CR1]1[CR1][CR1][CR1][CR1][CR1][CR1]1"),
    ("cyclooctane", "[CR2]1[CR2][CR2][CR2][CR2][CR2][CR2][CR2]1"),
    ("benzo_cycloheptane", "[CR1]1[CR1][CR1]cc[CR1][CR1]1"),
    ("oxygen_nitrogen_single", "[#8X2][#7]"),
    ("sulfonyl_anion", "OS(=O)(=O)[O-]"),
    ("halopyridine", "n1c([F,Cl,Br,I])cccc1"),
    ("acyl_cyanide", "[CX3](=[OX1])[CX2]#[NX1]"),
    ("alpha_halo_carbonyl", "[F,Cl,Br,I][CX4][CX3]=[OX1]"),
)


class AlertCatalog:
    def __init__(self):
        self.entries = [(name, compile_smarts(sm))
                        for name, sm in _ALERT_SMARTS]

    def count(self, mol: Mol) -> int:
        feats = MolFeatures(mol)
        return sum(1 for _name, pat in self.entries if pat.has_match(feats))

    def matches(self, mol: Mol) -> list[str]:
        feats = MolFeatures(mol)
        return [name for name, pat in self.entries if pat.has_match(feats)]

    def __len__(self):
        return len(self.entries)


_DEFAULT: AlertCatalog | None = None


def load_alert_catalog() -> AlertCatalog:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = AlertCatalog()
    return _DEFAULT


def count_alerts(mol: Mol) -> int:
    """Number of structural-alert patterns hit (QED ALERTS term)."""
    if not mol.sanitized:
        try:
            mol.sanitize()
        except Exception:
            return 0
    return load_alert_catalog().count(mol)
