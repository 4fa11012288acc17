"""Shared helpers for the PyTorch port's parity tests against the JAX
package.

The port sums a residual over d = 0 … D−1 in sequence; the JAX package's
generic path sums in XLA's reduction order and its Pallas kernel in 8-wide
chunks. Two float orders can rank a candidate differently only when its
score lies within rounding of the gold score, so rank comparisons between
the packages skip queries with such a near-tie (the float-tie class of
``openkeonspark_tpu/ops/pallas_rank.py:39-46``) and bound how many there
are."""

import numpy as np
import torch

# a candidate is a near-tie when its float64 score lies within this
# relative distance of the gold score: far above fp32 rounding over d ≤ 200
# terms (~1e-7 · √d relative), far below the typical score gap
NEAR_TIE_RTOL = 1e-5
# near-tie queries must stay below this share of all queries
MAX_NEAR_TIE_SHARE = 0.01


def residual_scores64(q: np.ndarray, table: np.ndarray, sign: float,
                      p: int) -> np.ndarray:
    """float64 scores [C, E] of every table row against every query."""
    res = q.astype(np.float64)[:, None, :] + sign * table.astype(np.float64)[None]
    return np.abs(res).sum(-1) if p == 1 else (res * res).sum(-1)


def near_tie_queries(scores64: np.ndarray, gold: np.ndarray,
                     exclude: np.ndarray = None) -> np.ndarray:
    """[C] bool: some candidate (other than ``exclude[c]``) scores within
    NEAR_TIE_RTOL of ``gold[c]``."""
    gap = np.abs(scores64 - gold[:, None])
    if exclude is not None:
        gap[np.arange(len(gold)), exclude] = np.inf
    return (gap <= NEAR_TIE_RTOL * np.abs(gold)[:, None]).any(1)


def transe_near_tie_counts(ent: np.ndarray, rel: np.ndarray,
                           triples: np.ndarray, p: int) -> dict:
    """{"tail": [N], "head": [N]}: for test triples (h, t, r), the number
    of candidates within NEAR_TIE_RTOL of the true entity's float64 score.
    Two float orders can move a rank, raw or filtered, by at most this
    many places, and not at all where it is 0."""
    h, t, r = triples[:, 0], triples[:, 1], triples[:, 2]
    out = {}
    for name, q, sign, gold_ids in (("tail", ent[h] + rel[r], -1.0, t),
                                    ("head", rel[r] - ent[t], 1.0, h)):
        s = residual_scores64(q, ent, sign, p)
        gold = s[np.arange(len(triples)), gold_ids]
        gap = np.abs(s - gold[:, None])
        gap[np.arange(len(triples)), gold_ids] = np.inf
        out[name] = (gap <= NEAR_TIE_RTOL * np.abs(gold)[:, None]).sum(1)
    return out


def require_cuda():
    """Skip a card-only test, decided at run time, never at import."""
    import pytest
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels build with nvcc there)")


def transr_near_tie_counts(ent: np.ndarray, rel: np.ndarray,
                           transfer: np.ndarray, triples: np.ndarray,
                           p: int) -> dict:
    """As :func:`transe_near_tie_counts` for TransR: candidates are scored
    in relation space, ``‖h·M_r + v_r − t·M_r‖`` in float64."""
    de, dr = ent.shape[1], rel.shape[1]
    out = {"tail": np.zeros(len(triples), np.int64),
           "head": np.zeros(len(triples), np.int64)}
    for r in np.unique(triples[:, 2]):
        rows = np.flatnonzero(triples[:, 2] == r)
        proj = ent.astype(np.float64) @ transfer[r].reshape(de, dr)
        sub = triples[rows]
        for name, q, sign, gold_ids in (
                ("tail", proj[sub[:, 0]] + rel[r], -1.0, sub[:, 1]),
                ("head", rel[r] - proj[sub[:, 1]], 1.0, sub[:, 0])):
            s = residual_scores64(q, proj, sign, p)
            gold = s[np.arange(len(sub)), gold_ids]
            gap = np.abs(s - gold[:, None])
            gap[np.arange(len(sub)), gold_ids] = np.inf
            out[name][rows] = (gap <= NEAR_TIE_RTOL * np.abs(gold)[:, None]
                               ).sum(1)
    return out
