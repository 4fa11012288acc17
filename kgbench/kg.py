"""The benchmark's knowledge graphs: a frozen copy of the port's
``random_kg``.

Copied from ``openkeonspark_tpu_torch/data/synth.py`` (``_dedup``,
``_split``, ``random_kg``) at commit 84369da9 (unchanged through 3ffe0770),
so that a later change to the port's generator cannot change what the
benchmark trains and ranks on. The arithmetic is the original's line for
line; only the return type differs: plain numpy arrays, which the traffic
modules hand to the port's ``Dataset`` and to the reference alike.

Uniform-ish random KG with Zipf-skewed entity popularity (``skew``), so
group sizes and the Bernoulli statistics are those of a real KG's long
tail. Triples are ``[n, 3]`` int32 with columns (h, t, r)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

H, T, R = 0, 1, 2


@dataclass
class KG:
    n_ent: int
    n_rel: int
    train: np.ndarray     # [n_train, 3] int32, columns (h, t, r)
    valid: np.ndarray
    test: np.ndarray

    def all_triples(self) -> np.ndarray:
        return np.concatenate([self.train, self.valid, self.test])


def _dedup(triples: np.ndarray) -> np.ndarray:
    return np.unique(triples, axis=0)


def _split(triples: np.ndarray, n_valid: int, n_test: int,
           rng: np.random.Generator
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    perm = rng.permutation(len(triples))
    triples = triples[perm]
    test = triples[:n_test]
    valid = triples[n_test:n_test + n_valid]
    train = triples[n_test + n_valid:]
    return train, valid, test


def random_kg(n_ent: int = 1000, n_rel: int = 20, n_triples: int = 20000,
              n_valid: int = 500, n_test: int = 500, seed: int = 0,
              skew: float = 1.2) -> KG:
    """Uniform-ish random KG with Zipf-skewed entity popularity."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_ent + 1, dtype=np.float64) ** skew
    w /= w.sum()
    n_draw = int(n_triples * 1.3) + n_valid + n_test
    h = rng.choice(n_ent, size=n_draw, p=w)
    t = rng.choice(n_ent, size=n_draw, p=w)
    r = rng.integers(0, n_rel, size=n_draw)
    triples = _dedup(np.stack([h, t, r], axis=1).astype(np.int32))
    triples = triples[rng.permutation(len(triples))][
        :n_triples + n_valid + n_test]
    train, valid, test = _split(triples, n_valid, n_test, rng)
    return KG(n_ent=n_ent, n_rel=n_rel,
              train=np.ascontiguousarray(train, dtype=np.int32),
              valid=np.ascontiguousarray(valid, dtype=np.int32),
              test=np.ascontiguousarray(test, dtype=np.int32))


def kg_of(config: dict, seed: int) -> KG:
    """The KG a configuration file states (``n_ent``, ``n_rel``,
    ``n_train``, ``n_valid``, ``n_test``, ``kg_skew``), drawn from
    ``seed``, with exactly the stated split sizes on every seed.

    At these skews ``random_kg`` loses about a tenth of its draws to
    duplicates (FB15K-237's sizes give 243k train triples, not 272,115),
    and how many depends on the seed. So it is asked for
    ``kg_draw_factor`` times the train triples and the train split is cut
    to ``n_train``: every seed then trains on as many triples, in batches
    of the same size."""
    want = config["n_train"]
    kg = random_kg(n_ent=config["n_ent"], n_rel=config["n_rel"],
                   n_triples=int(want * config["kg_draw_factor"]),
                   n_valid=config["n_valid"], n_test=config["n_test"],
                   seed=seed, skew=config["kg_skew"])
    if len(kg.train) < want:
        raise ValueError(f"the KG drew {len(kg.train)} distinct train "
                         f"triples, fewer than the {want} asked for")
    kg.train = np.ascontiguousarray(kg.train[:want])
    return kg
