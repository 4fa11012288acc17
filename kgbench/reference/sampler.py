"""The batch a training step's u32 draws select, worked out plainly.

The rules are OpenKE's (``Base.cpp::getBatch``, ``Corrupt.h``) as the
port documents its device sampler: draws are values in [0, 2³²) laid out
``[B, 1 + 2·negE]`` — column 0 picks the positive (``bits % n_train``),
columns 1..negE the Bernoulli flips (``(bits >> 8)·2⁻²⁴ < p_head[r]``, with
``p_head = tph / (tph + hpt)`` in float32), the next negE the corrupted
entity: the ``x``-th entity, ``x = bits % (n_ent − |G|)``, of those outside
``G``, the train entities that form a triple with the kept side (the
tails of (h, r) when the tail is corrupted, the heads of (t, r) when the
head is). A group that holds every entity falls back to a uniform draw
over the entities but the positive's own.

The ``x``-th non-member (from 0) of a group ``g₀ < g₁ < …`` is
``v = x + |{i : gᵢ − i ≤ x}|``: ``gᵢ − i`` counts the non-members below
``gᵢ``, and it never falls as ``i`` grows. So one sorted search per
group finds it."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

H, T, R = 0, 1, 2


@dataclass
class Groups:
    """Sorted ``key · n_val + value`` codes of the distinct (key, value)
    pairs of the train split, for one side, and beside each the code of
    its key and of the non-members below its value (``gᵢ − i``)."""
    codes: np.ndarray
    below: np.ndarray
    n_val: int

    @staticmethod
    def of(key: np.ndarray, val: np.ndarray, n_val: int) -> "Groups":
        codes = np.unique(key.astype(np.int64) * n_val + val.astype(np.int64))
        key_of = codes // n_val
        start = np.searchsorted(codes, key_of * n_val, "left")
        rank = np.arange(len(codes)) - start
        return Groups(codes, codes - rank, n_val)

    def size(self, key: np.ndarray) -> np.ndarray:
        lo = np.searchsorted(self.codes, key * self.n_val, "left")
        hi = np.searchsorted(self.codes, (key + 1) * self.n_val, "left")
        return hi - lo

    def nth_outside(self, key: np.ndarray, x: np.ndarray) -> np.ndarray:
        """The ``x``-th value outside the group of each ``key``."""
        lo = np.searchsorted(self.below, key * self.n_val, "left")
        return x + np.searchsorted(self.below, key * self.n_val + x,
                                   "right") - lo


class TrainSampler:
    """The reference's view of the train split: the two corruption group
    sets and the per-relation head-corruption probabilities."""

    def __init__(self, train: np.ndarray, n_ent: int, n_rel: int):
        self.train = train.astype(np.int64)
        self.n_ent, self.n_rel = n_ent, n_rel
        h, t, r = self.train[:, H], self.train[:, T], self.train[:, R]
        self.tails = Groups.of(h * n_rel + r, t, n_ent)   # (h, r) -> tails
        self.heads = Groups.of(t * n_rel + r, h, n_ent)   # (t, r) -> heads
        n_r = np.bincount(r, minlength=n_rel).astype(np.float64)
        heads_r = np.bincount(np.unique(h * n_rel + r) % n_rel,
                              minlength=n_rel).astype(np.float64)
        tails_r = np.bincount(np.unique(t * n_rel + r) % n_rel,
                              minlength=n_rel).astype(np.float64)
        tph = np.ones(n_rel, np.float32)
        hpt = np.ones(n_rel, np.float32)
        on = n_r > 0
        tph[on] = (n_r[on] / heads_r[on]).astype(np.float32)
        hpt[on] = (n_r[on] / tails_r[on]).astype(np.float32)
        self.p_head = (tph / (tph + hpt)).astype(np.float32)

    def batch(self, bits: np.ndarray, negative_ent: int, bern: bool):
        """(h, t, r, neg_h, neg_t) int64 of the step whose draws are
        ``bits`` [B, 1 + 2·negE] (values in [0, 2³²))."""
        bits = bits.astype(np.int64)
        n_e = negative_ent
        pos = self.train[bits[:, 0] % len(self.train)]
        h, t, r = pos[:, H], pos[:, T], pos[:, R]
        u = ((bits[:, 1:1 + n_e] >> 8).astype(np.float32)
             * np.float32(2.0 ** -24))
        p = self.p_head[r][:, None] if bern else np.float32(0.5)
        corrupt_head = u < p
        neg_h = np.repeat(h[:, None], n_e, 1)
        neg_t = np.repeat(t[:, None], n_e, 1)
        for k in range(n_e):
            xb = bits[:, 1 + n_e + k]
            ch = corrupt_head[:, k]
            for head, groups, key, avoid in (
                    (True, self.heads, t * self.n_rel + r, h),
                    (False, self.tails, h * self.n_rel + r, t)):
                sel = ch == head
                if not sel.any():
                    continue
                cnt = groups.size(key[sel])
                full = cnt >= self.n_ent
                x = xb[sel] % np.maximum(
                    np.where(full, self.n_ent - 1, self.n_ent - cnt), 1)
                v = groups.nth_outside(key[sel], x)
                v = np.where(full, x + (x >= avoid[sel]), v)
                (neg_h if head else neg_t)[sel, k] = v
        return h, t, r, neg_h, neg_t
