"""Built-in SMILES corpora for tests and smoke training.

Copied from ``druggen_tpu/data/corpus.py``; imports point at this package.

The reference downloads ChEMBL/AKT1/CDK2 SMILES from Google Drive
(``setup.sh:33-62``); in an offline environment we ship a small hand-rolled
drug-like corpus plus a deterministic procedural generator so the full
pipeline (vocab -> featurize -> train -> infer -> metrics) can be exercised
without any network access.  Real corpora drop into the same file format
(one SMILES per line).
"""

from __future__ import annotations

import random

# Hand-written drug-like molecules (common drugs + fragments), all parseable
# by druggen_tpu_torch.chem and all within the C/N/O/S/F/Cl/Br/P vocabulary.
DRUGLIKE_SMILES = [
    "CC(=O)Oc1ccccc1C(=O)O",                 # aspirin
    "CC(=O)Nc1ccc(O)cc1",                    # paracetamol
    "Cn1cnc2c1c(=O)n(C)c(=O)n2C",            # caffeine
    "CC(C)Cc1ccc(C(C)C(=O)O)cc1",            # ibuprofen
    "OC(=O)c1ccccc1O",                       # salicylic acid
    "Clc1ccccc1",                            # chlorobenzene
    "c1ccc2ccccc2c1",                        # naphthalene
    "c1ccncc1",                              # pyridine
    "c1cc[nH]c1",                            # pyrrole
    "c1ccoc1",                               # furan
    "c1ccsc1",                               # thiophene
    "C1CCNCC1",                              # piperidine
    "C1CCOCC1",                              # THP
    "C1CNCCN1",                              # piperazine
    "O=C1CCCCC1",                            # cyclohexanone
    "NCCc1ccc(O)c(O)c1",                     # dopamine
    "NC(Cc1ccc(O)cc1)C(=O)O",                # tyrosine
    "NC(CC(=O)O)C(=O)O",                     # aspartic acid
    "NC(CO)C(=O)O",                          # serine
    "CSCCC(N)C(=O)O",                        # methionine
    "NC(Cc1c[nH]c2ccccc12)C(=O)O",           # tryptophan
    "OCC1OC(O)C(O)C(O)C1O",                  # glucose
    "CC(O)C(=O)O",                           # lactic acid
    "OC(=O)CCC(=O)O",                        # succinic acid
    "OC(=O)C=CC(=O)O",                       # fumaric acid
    "Nc1ccc(S(N)(=O)=O)cc1",                 # sulfanilamide
    "CN(C)CCCN1c2ccccc2CCc2ccc(Cl)cc21",     # clomipramine
    "CN1CCC(=C2c3ccccc3CCc3ccccc32)CC1",     # amitriptyline-like
    "Fc1ccc(C(=O)CCCN2CCC(O)CC2)cc1",        # haloperidol fragment
    "COc1ccc2cc(C(C)C(=O)O)ccc2c1",          # naproxen
    "Cc1ccccc1C",                            # xylene
    "CCN(CC)CC",                             # triethylamine
    "CCOC(=O)C",                             # ethyl acetate
    "CC(C)(C)c1ccc(O)cc1",                   # BHT fragment
    "FC(F)(F)c1ccccc1",                      # benzotrifluoride
    "N#Cc1ccccc1",                           # benzonitrile
    "O=[N+]([O-])c1ccccc1",                  # nitrobenzene
    "Brc1ccccc1",                            # bromobenzene
    "OCCO",                                  # ethylene glycol
    "OCCN",                                  # ethanolamine
    "NCCN",                                  # ethylenediamine
    "CC(N)Cc1ccccc1",                        # amphetamine
    "CNC(C)Cc1ccccc1",                       # methamphetamine
    "COc1cc2c(cc1OC)CCN(C)C2",               # tetrahydroisoquinoline frag
    "O=C(O)c1cccnc1",                        # nicotinic acid
    "CN1CCCC1c1cccnc1",                      # nicotine
    "Oc1ccc2[nH]cc(CCN)c2c1",                # serotonin
    "NC(=O)c1ccc(N)cc1",                     # aminobenzamide
    "O=S(=O)(N)c1ccc(Cl)cc1",                # chlorosulfonamide
    "Cc1cccc(C)c1NC(=O)CN(CC)CC",            # lidocaine
    "CC(C)NCC(O)COc1ccc2ccccc2c1",           # propranolol
    "CC(=O)NC1CCc2cc(OC)ccc2C1",             # melatonin-like ring
    "O=C1NC(=O)NC(=O)C1",                    # barbituric acid core
    "O=c1cc[nH]c(=O)[nH]1",                  # uracil (aromatic form)
    "Nc1ncnc2[nH]cnc12",                     # adenine
    "Cc1cn(C)c(=O)[nH]c1=O",                 # methylthymine-like
    "c1cnc2[nH]ccc2c1",                      # azaindole
    "c1ccc(-c2ccccc2)cc1",                   # biphenyl
    "O=C(Nc1ccccc1)c1ccccc1",                # benzanilide
    "O=C(Oc1ccccc1)c1ccccc1",                # phenyl benzoate
    "CCCCCCCC",                              # octane
    "CC(C)CC(C)(C)C",                        # branched alkane
    "C1CC2CCC1CC2",                          # bicyclooctane
    "C1CC2(CC1)CCCC2",                       # spiro
    "OC1CCCCC1O",                            # cyclohexanediol
    "ClCC(Cl)CCl",                           # trichloropropane
    "CSc1ccccc1",                            # thioanisole
    "COP(=O)(OC)OC",                         # trimethyl phosphate
    "CCOC(=O)c1ccccc1N",                     # benzocaine
    "OC(c1ccccc1)c1ccccc1",                  # benzhydrol
    "O=C(c1ccccc1)c1ccccc1",                 # benzophenone
    "C(c1ccccc1)c1ccccc1",                   # diphenylmethane
    "CN(C)c1ccc(C=O)cc1",                    # DMAB
    "Cc1ccc(S(=O)(=O)O)cc1",                 # tosylate acid
    "CC12CCC(CC1)C(C)(C)O2",                 # eucalyptol-like
    "CC(C)=CCCC(C)=CC=O",                    # citral
    "CC1=CCC(CC1)C(C)C",                     # terpinene-like
    "OC(=O)c1cc(O)c(O)c(O)c1",               # gallic acid
    "COc1ccc(C=CC(=O)O)cc1",                 # methoxycinnamic acid
    "Oc1ccc(C=CC(=O)O)cc1O",                 # caffeic acid
]

# A tiny "drug/target" set playing the role of AKT1 inhibitors for the
# DrugGEN submodel tests (reference --drug_raw_file).
TARGET_SMILES = [
    "CC(C)NCC(O)COc1ccc2ccccc2c1",
    "CN1CCC(=C2c3ccccc3CCc3ccccc32)CC1",
    "Fc1ccc(C(=O)CCCN2CCC(O)CC2)cc1",
    "O=C(Nc1ccccc1)c1ccccc1",
    "CN(C)CCCN1c2ccccc2CCc2ccc(Cl)cc21",
    "Nc1ncnc2[nH]cnc12",
    "CC(=O)Nc1ccc(O)cc1",
    "COc1cc2c(cc1OC)CCN(C)C2",
    "Cc1cccc(C)c1NC(=O)CN(CC)CC",
    "O=S(=O)(N)c1ccc(Cl)cc1",
    "CN1CCCC1c1cccnc1",
    "Oc1ccc2[nH]cc(CCN)c2c1",
]

_ALKYL = ["C", "CC", "CCC", "CC(C)", "CCCC", "CC(C)C"]
_RINGS = ["c1ccccc1", "c1ccncc1", "C1CCCCC1", "C1CCNCC1", "c1ccsc1",
          "c1ccoc1", "C1CCOCC1", "c1cc[nH]c1"]
_LINKERS = ["", "O", "N", "C(=O)", "C(=O)O", "C(=O)N", "S", "OC", "NC(=O)"]
_CAPS = ["", "O", "N", "F", "Cl", "Br", "C#N", "C(F)(F)F", "OC", "N(C)C"]


def generate_corpus(n: int, seed: int = 0) -> list[str]:
    """Deterministic procedurally-generated drug-like SMILES: ring + linker +
    ring/alkyl + cap combinations, filtered through our own sanitizer."""
    from druggen_tpu_torch.chem import canonical_smiles

    rng = random.Random(seed)
    out: list[str] = []
    seen: set[str] = set()
    attempts = 0
    while len(out) < n and attempts < n * 50:
        attempts += 1
        ring = rng.choice(_RINGS)
        linker = rng.choice(_LINKERS)
        tail = rng.choice(_ALKYL + _RINGS)
        cap = rng.choice(_CAPS)
        # attach pieces head-to-tail; ring-number collision avoided by
        # renumbering the second ring's digits 1 -> 2
        tail2 = tail.replace("1", "2")
        # two-level grammar: a ring tail may itself carry a substituent
        # (ring3-numbered) — expands the unique space to ~1M so corpora
        # of >=100k molecules are reachable (the one-level space caps out
        # near 20k)
        if tail2.endswith("2") and rng.random() < 0.7:
            linker3 = rng.choice(_LINKERS)
            tail3 = rng.choice(_ALKYL + [r.replace("1", "3")
                                         for r in _RINGS])
            # substitute the ring tail's last-but-one atom (every _RINGS
            # string ends "<atom-char><digit>"); invalid combinations
            # (e.g. a branch landing on [nH]) are filtered by the
            # canonicalizer below
            tail2 = (tail2[:-2] + "(" + linker3 + tail3 + ")" + tail2[-2:])
        smi = ring[:-1] + "(" + linker + tail2 + ")" + ring[-1]
        if cap:
            smi = cap + smi if not cap[0].isdigit() else smi
        can = canonical_smiles(smi)
        if can is None or can in seen:
            continue
        seen.add(can)
        out.append(can)
    return out


# Rare-element supplement: molecules carrying the ChEMBL-v29 atom tail
# (K, Ca, As — reference README.md:141-145) that the fragment-recombination
# corpora lack.  Classic organoarsenicals (cacodylic/arsanilic acids,
# trimethylarsine) plus covalently-written K/Ca salts of the kind ChEMBL
# records; all parse, sanitize, round-trip, and featurize through the
# chem stack (tests/test_vocab_ref12.py).  Injected into training corpora
# via ``scripts/build_corpus_v2.py --inject_ref12`` so a ref12-vocab model
# sees every atom type during training.
REF12_SUPPLEMENT = [
    "C[As](C)C", "C[As](C)(C)=O", "C[As](C)(O)=O", "O[As](O)(O)=O",
    "Nc1ccc(cc1)[As](O)(O)=O", "O[As]=O", "c1ccc(cc1)[As](O)O",
    "C[As]1SCCS1", "OC(=O)C[As](O)(O)=O",
    "CC(=O)O[K]", "[K]OC(=O)c1ccccc1", "[K]Oc1ccccc1", "[K]OS(=O)(=O)C",
    "CCO[K]",
    "O=C1O[Ca]OC1=O", "[Ca](OC(C)=O)OC(C)=O",
    "[Ca]1OC(=O)CN(CC(=O)O1)C",
]


def write_corpus(path: str, smiles: list[str]) -> None:
    with open(path, "w") as f:
        for s in smiles:
            f.write(s + "\n")
