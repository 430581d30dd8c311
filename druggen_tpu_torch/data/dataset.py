"""Dense fixed-shape dataset pipeline.

Copied from ``druggen_tpu/data/dataset.py``; imports point at this
package, and the native branch raises where the JAX one falls back to
Python.

The reference stores molecules as sparse PyG ``Data`` objects collated into a
``.pt`` (``src/data/dataset.py:280-317``) and re-densifies every batch on the
GPU (``src/data/utils.py:128-142``).  On TPU that detour is pure overhead:
the model consumes dense ``[B, N, m_dim]`` / ``[B, N, N, b_dim]`` tensors, so
we featurize once to dense **label** arrays (int8), cache them as ``.npz``,
and one-hot on device inside the jitted step.  Host->device traffic shrinks
by ~16x vs shipping one-hot float32.

File-name derivation matches the reference (``train.py:54-64``): raw file
``chembl_train.smi`` with max_atom 45 caches to ``chembl_train45.npz``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from druggen_tpu_torch.chem.codec import smiles_to_matrices
from druggen_tpu_torch.chem.vocab import Vocab, read_smiles_file


@dataclass
class GraphData:
    """A featurized corpus: X [M, N] atom labels, A [M, N, N] bond labels,
    optional F [M, N, 54] extra node features (reference --features flag,
    dataset.py:161-185)."""

    x: np.ndarray          # int8 [M, N]
    a: np.ndarray          # int8 [M, N, N]
    smiles: list[str]      # the M source SMILES (post-filter)
    vocab: Vocab
    max_atom: int
    f: np.ndarray | None = None   # int8 [M, N, F_dim]

    def __len__(self) -> int:
        return self.x.shape[0]

    @property
    def feature_dim(self) -> int:
        return 0 if self.f is None else int(self.f.shape[-1])

    def dense_nodes(self, idx) -> np.ndarray:
        """float32 [B, N, m_dim + F] one-hot atom types concatenated with
        the extra features (the reference's x when --features is set,
        dataset.py:303-307)."""
        onehot = np.eye(self.vocab.m_dim, dtype=np.float32)[self.x[idx]]
        if self.f is None:
            return onehot
        return np.concatenate([onehot, self.f[idx].astype(np.float32)],
                              axis=-1)


def cache_path_for(raw_file: str, max_atom: int, data_dir: str) -> str:
    """``<data_dir>/<basename><max_atom>.npz`` (reference train.py:59-64)."""
    base = os.path.splitext(os.path.basename(raw_file))[0]
    return os.path.join(data_dir, f"{base}{max_atom}.npz")


def featurize_smiles(smiles_list: list[str], vocab: Vocab, max_atom: int,
                     log_every: int = 0, use_native: bool = True,
                     features: bool = False) -> GraphData:
    """Filter + featurize a SMILES list (reference ``_filter_smiles`` +
    ``process``, dataset.py:80-117,280-317).  Molecules that fail to parse,
    exceed ``max_atom``, use out-of-vocab atoms/bonds, or have isolated
    atoms are dropped.

    Uses the multithreaded C++ kernel (:mod:`druggen_tpu_torch.native`),
    built at first use; its outputs are bit-identical to the Python path.
    A failed build raises; ``use_native=False`` takes the Python path."""
    if use_native and not features:  # native path has no extra-feature block
        from druggen_tpu_torch import native

        X, A, kept_idx = native.featurize_batch_native(smiles_list, vocab,
                                                       max_atom)
        if len(kept_idx) == 0:
            raise ValueError("no molecules survived filtering")
        return GraphData(x=X, a=A, smiles=[smiles_list[i] for i in kept_idx],
                         vocab=vocab, max_atom=max_atom)
    xs, as_, fs, kept = [], [], [], []
    from druggen_tpu_torch.chem.codec import atom_features
    from druggen_tpu_torch.chem.smiles import mol_from_smiles
    for i, smi in enumerate(smiles_list):
        res = smiles_to_matrices(smi, vocab, max_atom)
        if res is None:
            continue
        x, a = res
        xs.append(x)
        as_.append(a)
        if features:
            fs.append(atom_features(mol_from_smiles(smi), max_atom))
        kept.append(smi)
        if log_every and len(kept) % log_every == 0:
            print(f"featurized {len(kept)} molecules ({i + 1} scanned)")
    if not xs:
        raise ValueError("no molecules survived filtering")
    return GraphData(x=np.stack(xs), a=np.stack(as_), smiles=kept,
                     vocab=vocab, max_atom=max_atom,
                     f=np.stack(fs) if features else None)


# copied from druggen_tpu/data/dataset.py:109-130 pad_vertices
def pad_vertices(data: GraphData, to: int) -> GraphData:
    """Zero-pad the vertex axes of a corpus to ``to`` atoms.

    Label 0 is the PAD atom class and BondType.ZERO (reference
    ``src/data/utils.py:97-109`` vocab construction), so padding labels
    with zeros means exactly "no atom / no bond" — the same semantics as
    building the dataset with a larger ``max_atom``.  Used by the
    edge-partitioned trainer to make vertexes divisible by the 'node'
    mesh axis (e.g. 45 -> 48)."""
    n = data.x.shape[1]
    if to < n:
        raise ValueError(f"cannot pad {n} vertices down to {to}")
    if to == n:
        return data
    pad = to - n
    x = np.pad(data.x, ((0, 0), (0, pad)))
    a = np.pad(data.a, ((0, 0), (0, pad), (0, pad)))
    f = None if data.f is None else np.pad(data.f,
                                           ((0, 0), (0, pad), (0, 0)))
    return GraphData(x=x, a=a, smiles=data.smiles, vocab=data.vocab,
                     max_atom=data.max_atom, f=f)


def load_dataset(raw_file: str, vocab: Vocab, max_atom: int,
                 data_dir: str = "data", use_cache: bool = True,
                 features: bool = False) -> GraphData:
    """Load-or-build the dense cache for a raw SMILES file."""
    path = cache_path_for(raw_file, max_atom, data_dir)
    if features:
        path = path.replace(".npz", "_feat.npz")
    if use_cache and os.path.exists(path):
        with np.load(path, allow_pickle=False) as z:
            cached_vocab = Vocab(tuple(z["atom_labels"].tolist()),
                                 tuple(z["bond_labels"].tolist()))
            if cached_vocab == vocab and int(z["max_atom"]) == max_atom:
                return GraphData(x=z["x"], a=z["a"],
                                 smiles=[s for s in z["smiles"].tolist()],
                                 vocab=vocab, max_atom=max_atom,
                                 f=z["f"] if "f" in z.files else None)
    data = featurize_smiles(read_smiles_file(raw_file), vocab, max_atom,
                            features=features)
    if use_cache:
        os.makedirs(data_dir, exist_ok=True)
        tmp = path + f".tmp{os.getpid()}"
        extra = {"f": data.f} if data.f is not None else {}
        np.savez_compressed(
            tmp, x=data.x, a=data.a,
            smiles=np.array(data.smiles, dtype=np.str_),
            atom_labels=np.array(vocab.atom_labels, dtype=np.int64),
            bond_labels=np.array(vocab.bond_labels, dtype=np.int64),
            max_atom=np.int64(max_atom), **extra)
        os.replace(tmp + ".npz", path)
    return data


class BatchIterator:
    """Shuffled, drop-last minibatch iterator over a :class:`GraphData`.

    Replaces the PyG DataLoader of reference ``train.py:97-100`` — plain
    array slicing, nothing to collate.  Supports per-host sharding for
    multi-host training: host ``h`` of ``num_hosts`` sees a disjoint
    1/num_hosts slice of every epoch's permutation, so the global batch is
    the union of per-host batches (SURVEY.md §2.2 multi-host plan)."""

    def __init__(self, data: GraphData, batch_size: int, *,
                 shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                 loop: bool = False):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.data = data
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.loop = loop
        self._epoch = 0

    def __len__(self) -> int:
        m = len(self.data) // self.num_hosts
        return m // self.batch_size if self.drop_last else -(-m // self.batch_size)

    def epoch_batches(self, epoch: int):
        """Yield (x_labels [B,N] int8, a_labels [B,N,N] int8) for one epoch.
        Deterministic given (seed, epoch)."""
        m = len(self.data)
        if self.shuffle:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
            perm = rng.permutation(m)
        else:
            perm = np.arange(m)
        per_host = m // self.num_hosts
        mine = perm[self.host_id * per_host:(self.host_id + 1) * per_host]
        nb = len(mine) // self.batch_size if self.drop_last \
            else -(-len(mine) // self.batch_size)
        dense = self.data.f is not None
        for i in range(nb):
            idx = mine[i * self.batch_size:(i + 1) * self.batch_size]
            if dense:
                # --features mode: nodes arrive as dense float blocks
                yield self.data.dense_nodes(idx), self.data.a[idx]
            else:
                yield self.data.x[idx], self.data.a[idx]

    def __iter__(self):
        if self.loop:
            return self._infinite()
        return self.epoch_batches(self._next_epoch())

    def _next_epoch(self) -> int:
        e = self._epoch
        self._epoch += 1
        return e

    def _infinite(self):
        if len(self) == 0:
            raise ValueError(
                f"BatchIterator would yield no batches: dataset of "
                f"{len(self.data)} molecules < batch_size {self.batch_size} "
                f"with drop_last (use a smaller batch or a larger corpus)")
        while True:
            yield from self.epoch_batches(self._next_epoch())
