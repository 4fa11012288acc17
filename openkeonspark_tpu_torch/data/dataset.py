"""Dataset I/O in the reference's on-disk layout.

Replaces the I/O half of ``base/Reader.h`` (``importTrainFiles`` /
``importTestFiles``, reconstructed ``Reader.h:~1–180`` per SURVEY.md §2.2)
and the L0 data layout (SURVEY.md §1): plain-text id files where the first
line is the count and each following line is ``e1 e2 rel`` (head tail
relation) for triple files, ``name id`` for vocab files. Incremental mode
(numbered batch subfolders ``0/ 1/ …``, each a growing snapshot) is handled
by pointing ``load_dataset`` at the subfolder.

The port's own copy of ``openkeonspark_tpu/data/dataset.py`` (numpy and the standard library only; the port imports nothing of the JAX package). ``tests/test_torch_copies.py`` holds the two equal.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

# Column order inside triple arrays. Files store "h t r" per line (the
# reference's train2id.txt layout); we keep the same column order in memory.
H, T, R = 0, 1, 2


@dataclass
class Dataset:
    n_ent: int
    n_rel: int
    train: np.ndarray                 # [n_train, 3] int32, columns (h, t, r)
    valid: Optional[np.ndarray] = None
    test: Optional[np.ndarray] = None
    ent_names: Optional[Dict[int, str]] = field(default=None, repr=False)
    rel_names: Optional[Dict[int, str]] = field(default=None, repr=False)

    def __post_init__(self):
        self.train = _as_triples(self.train)
        if self.valid is not None:
            self.valid = _as_triples(self.valid)
        if self.test is not None:
            self.test = _as_triples(self.test)

    @property
    def n_train(self) -> int:
        return len(self.train)

    @property
    def n_valid(self) -> int:
        return 0 if self.valid is None else len(self.valid)

    @property
    def n_test(self) -> int:
        return 0 if self.test is None else len(self.test)

    def all_triples(self) -> np.ndarray:
        """train+valid+test concatenated — the reference's ``tripleList``
        used for filtered ranking (Reader.h ``importTestFiles``)."""
        parts = [self.train]
        if self.valid is not None and len(self.valid):
            parts.append(self.valid)
        if self.test is not None and len(self.test):
            parts.append(self.test)
        return np.concatenate(parts, axis=0)

    def validate(self):
        for name in ("train", "valid", "test"):
            arr = getattr(self, name)
            if arr is None or len(arr) == 0:
                continue
            if arr[:, (H, T)].min() < 0 or arr[:, (H, T)].max() >= self.n_ent:
                raise ValueError(f"{name}: entity id out of range [0,{self.n_ent})")
            if arr[:, R].min() < 0 or arr[:, R].max() >= self.n_rel:
                raise ValueError(f"{name}: relation id out of range [0,{self.n_rel})")


def _as_triples(arr) -> np.ndarray:
    arr = np.asarray(arr, dtype=np.int32)
    if arr.ndim != 2 or arr.shape[1] != 3:
        raise ValueError(f"triple array must be [N,3], got {arr.shape}")
    return np.ascontiguousarray(arr)


def _read_id_file(path: str) -> np.ndarray:
    """Read a `count \\n h t r ...` triple file."""
    with open(path, "r") as f:
        n = int(f.readline().split()[0])
        data = np.loadtxt(f, dtype=np.int64, max_rows=n, ndmin=2)
    if data.shape[0] != n:
        raise ValueError(f"{path}: header says {n} rows, found {data.shape[0]}")
    return data[:, :3].astype(np.int32)


def _read_vocab(path: str) -> Dict[int, str]:
    names: Dict[int, str] = {}
    with open(path, "r") as f:
        n = int(f.readline().split()[0])
        for _ in range(n):
            line = f.readline().rstrip("\n")
            # "name id" — name may contain spaces/tabs; id is the last field
            name, _, idx = line.rpartition("\t")
            if not name:
                name, _, idx = line.rpartition(" ")
            names[int(idx)] = name
    return names


def _vocab_count(path: str) -> int:
    with open(path, "r") as f:
        return int(f.readline().split()[0])


def load_dataset(path: str, load_names: bool = False) -> Dataset:
    """Load an OpenKE-layout dataset dir (entity2id.txt, relation2id.txt,
    train2id.txt, optional valid2id.txt/test2id.txt)."""
    n_ent = _vocab_count(os.path.join(path, "entity2id.txt"))
    n_rel = _vocab_count(os.path.join(path, "relation2id.txt"))
    train = _read_id_file(os.path.join(path, "train2id.txt"))

    def opt(name):
        p = os.path.join(path, name)
        return _read_id_file(p) if os.path.exists(p) else None

    ds = Dataset(
        n_ent=n_ent, n_rel=n_rel, train=train,
        valid=opt("valid2id.txt"), test=opt("test2id.txt"),
        ent_names=_read_vocab(os.path.join(path, "entity2id.txt")) if load_names else None,
        rel_names=_read_vocab(os.path.join(path, "relation2id.txt")) if load_names else None,
    )
    ds.validate()
    return ds


def save_dataset(ds: Dataset, path: str):
    """Write a dataset in the reference's text layout (for fixtures and for
    feeding the C++ host sampler, which reads the same files the reference's
    Reader.h did)."""
    os.makedirs(path, exist_ok=True)

    def write_triples(name, arr):
        with open(os.path.join(path, name), "w") as f:
            f.write(f"{len(arr)}\n")
            np.savetxt(f, arr, fmt="%d")

    def write_vocab(name, n, names):
        with open(os.path.join(path, name), "w") as f:
            f.write(f"{n}\n")
            for i in range(n):
                label = names[i] if names and i in names else f"x{i}"
                f.write(f"{label}\t{i}\n")

    write_vocab("entity2id.txt", ds.n_ent, ds.ent_names)
    write_vocab("relation2id.txt", ds.n_rel, ds.rel_names)
    write_triples("train2id.txt", ds.train)
    if ds.valid is not None:
        write_triples("valid2id.txt", ds.valid)
    if ds.test is not None:
        write_triples("test2id.txt", ds.test)
