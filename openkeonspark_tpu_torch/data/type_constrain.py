"""Type-constraint files: per-relation allowed head/tail entity sets.

Reference parity: upstream OpenKE ships ``n-n.py`` which generates
``type_constrain.txt`` from the dataset (SURVEY.md §2.1 "Dataset tooling"),
and ``Test.h`` has a type-constrained ranking variant that only ranks the
gold entity against candidates allowed for the relation (SURVEY.md §2.2
[M]). File format (OpenKE):

    <n_relations>
    <rel_id> <n_heads> <h1> <h2> ...
    <rel_id> <n_tails> <t1> <t2> ...
    (two lines per relation)

The port's own copy of ``openkeonspark_tpu/data/type_constrain.py`` (numpy
and the standard library only; the port imports nothing of the JAX
package). ``tests/test_torch_copies.py`` holds the two equal.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from openkeonspark_tpu_torch.data.dataset import Dataset, H, R, T


@dataclass
class TypeConstraints:
    n_rel: int
    heads: Dict[int, np.ndarray]   # rel -> sorted allowed head ids
    tails: Dict[int, np.ndarray]   # rel -> sorted allowed tail ids

    def head_mask(self, n_ent: int) -> np.ndarray:
        """[R, E] uint8 allowed-head matrix (dense; fine at benchmark
        scales — gate at ~10^9 cells)."""
        m = np.zeros((self.n_rel, n_ent), np.uint8)
        for rel, ids in self.heads.items():
            m[rel, ids] = 1
        return m

    def tail_mask(self, n_ent: int) -> np.ndarray:
        m = np.zeros((self.n_rel, n_ent), np.uint8)
        for rel, ids in self.tails.items():
            m[rel, ids] = 1
        return m


def build_type_constraints(ds: Dataset,
                           splits: str = "all") -> TypeConstraints:
    """Observed heads/tails per relation (upstream n-n.py derives them from
    the full dataset; ``splits='train'`` restricts to train)."""
    arr = ds.train if splits == "train" else ds.all_triples()
    heads: Dict[int, np.ndarray] = {}
    tails: Dict[int, np.ndarray] = {}
    for rel in range(ds.n_rel):
        m = arr[:, R] == rel
        heads[rel] = np.unique(arr[m, H]).astype(np.int32)
        tails[rel] = np.unique(arr[m, T]).astype(np.int32)
    return TypeConstraints(n_rel=ds.n_rel, heads=heads, tails=tails)


def save_type_constraints(tc: TypeConstraints, path: str):
    with open(path, "w") as f:
        f.write(f"{tc.n_rel}\n")
        for rel in range(tc.n_rel):
            hs = tc.heads.get(rel, np.empty(0, np.int32))
            ts = tc.tails.get(rel, np.empty(0, np.int32))
            f.write(f"{rel}\t{len(hs)}\t" + "\t".join(map(str, hs)) + "\n")
            f.write(f"{rel}\t{len(ts)}\t" + "\t".join(map(str, ts)) + "\n")


def load_type_constraints(path: str) -> TypeConstraints:
    with open(path) as f:
        n_rel = int(f.readline().split()[0])
        heads: Dict[int, np.ndarray] = {}
        tails: Dict[int, np.ndarray] = {}
        for _ in range(n_rel):
            hline = f.readline().split()
            tline = f.readline().split()
            heads[int(hline[0])] = np.asarray(
                sorted(int(x) for x in hline[2:2 + int(hline[1])]),
                np.int32)
            tails[int(tline[0])] = np.asarray(
                sorted(int(x) for x in tline[2:2 + int(tline[1])]),
                np.int32)
    return TypeConstraints(n_rel=n_rel, heads=heads, tails=tails)


def maybe_load(path_dir: str) -> Optional[TypeConstraints]:
    p = os.path.join(path_dir, "type_constrain.txt")
    return load_type_constraints(p) if os.path.exists(p) else None
