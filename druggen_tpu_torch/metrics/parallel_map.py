"""Host-side parallel mapping for chemistry metrics.

Copied from ``druggen_tpu/metrics/parallel_map.py``; imports point at this package.

The reference parallelizes its RDKit-heavy metric loops with a
``multiprocessing.Pool`` (``mapper(n_jobs)``, ``src/util/utils.py:423-449``,
used by ``results/evaluate.py`` with n_jobs=8).  Same capability here:
top-level per-SMILES worker functions (picklable) + a pool mapper.
"""

from __future__ import annotations

from multiprocessing import Pool


def mapper(n_jobs: int):
    """Reference ``mapper`` contract: ``mapper(1)`` = built-in map,
    ``mapper(n)`` = pool map, pool objects pass through.  ``n_jobs <= 1``
    (including 0) means serial."""
    if isinstance(n_jobs, int) and n_jobs <= 1:
        def _mapper(fn, it):
            return list(map(fn, it))
        return _mapper
    if isinstance(n_jobs, int):
        def _mapper(fn, it):
            with Pool(n_jobs) as pool:
                return pool.map(fn, it, chunksize=64)
        return _mapper
    return n_jobs.map


# ---- picklable per-SMILES workers ---------------------------------------

def qed_of(smiles: str) -> float | None:
    from druggen_tpu_torch.chem.descriptors import qed
    from druggen_tpu_torch.chem.smiles import mol_from_smiles

    m = mol_from_smiles(smiles) if smiles else None
    return None if m is None else qed(m)


def sa_of(smiles: str) -> float | None:
    from druggen_tpu_torch.chem.descriptors import sa_score
    from druggen_tpu_torch.chem.smiles import mol_from_smiles

    m = mol_from_smiles(smiles) if smiles else None
    return None if m is None else sa_score(m)


def lipinski_of(smiles: str) -> int | None:
    from druggen_tpu_torch.chem.descriptors import obey_lipinski
    from druggen_tpu_torch.chem.smiles import mol_from_smiles

    m = mol_from_smiles(smiles) if smiles else None
    return None if m is None else obey_lipinski(m)


def veber_of(smiles: str) -> int | None:
    from druggen_tpu_torch.chem.descriptors import obey_veber
    from druggen_tpu_torch.chem.smiles import mol_from_smiles

    m = mol_from_smiles(smiles) if smiles else None
    return None if m is None else obey_veber(m)


def pains_pass_of(smiles: str) -> bool | None:
    from druggen_tpu_torch.chem.filters import is_pains
    from druggen_tpu_torch.chem.smiles import mol_from_smiles

    m = mol_from_smiles(smiles) if smiles else None
    return None if m is None else (not is_pains(m))


def fingerprint_of(smiles: str):
    from druggen_tpu_torch.chem.fingerprints import morgan_fingerprint
    from druggen_tpu_torch.chem.smiles import mol_from_smiles

    m = mol_from_smiles(smiles) if smiles else None
    return None if m is None else morgan_fingerprint(m)


def canonical_of(smiles: str) -> str | None:
    from druggen_tpu_torch.chem.canon import canonical_smiles

    return canonical_smiles(smiles) if smiles else None
