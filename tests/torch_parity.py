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
    of candidates within NEAR_TIE_RTOL of the true entity's float64
    score. Two float orders can move a rank, raw or filtered, by at most
    this many places, and not at all where it is 0."""
    return model_near_tie_counts(
        "transe", {"ent_embeddings": ent, "rel_embeddings": rel}, triples, p)


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


def model_scores64(model: str, tables: dict, h, t, r, p: int) -> np.ndarray:
    """float64 scores of id triples (broadcasting index arrays) straight
    from the model's definition, for transe, transh, transd and rotate."""
    P = {k: np.asarray(v, np.float64) for k, v in tables.items()}
    E, R = P["ent_embeddings"], P["rel_embeddings"]
    eh, et = E[h], E[t]
    if model == "rotate":
        d = R.shape[1]
        cos, sin = np.cos(R[r]), np.sin(R[r])
        re = eh[..., :d] * cos - eh[..., d:] * sin - et[..., :d]
        im = eh[..., :d] * sin + eh[..., d:] * cos - et[..., d:]
        return np.sqrt(re * re + im * im + 1e-12).sum(-1)
    if model == "transh":
        w = P["normal_vectors"][r]
        w = w / np.sqrt((w * w).sum(-1, keepdims=True) + 1e-12)
        eh = eh - (eh * w).sum(-1, keepdims=True) * w
        et = et - (et * w).sum(-1, keepdims=True) * w
    elif model == "transd":
        EP, rp = P["ent_transfer"], P["rel_transfer"][r]
        eh = eh + (eh * EP[h]).sum(-1, keepdims=True) * rp
        et = et + (et * EP[t]).sum(-1, keepdims=True) * rp
    res = eh + R[r] - et
    return np.abs(res).sum(-1) if p == 1 else (res * res).sum(-1)


def model_near_tie_counts(model: str, tables: dict, triples: np.ndarray,
                          p: int) -> dict:
    """As :func:`transe_near_tie_counts` for any model of
    :func:`model_scores64`: per test triple (h, t, r) and direction, the
    number of candidates within NEAR_TIE_RTOL of the true entity's float64
    score. ``tables`` are stripped of pad rows."""
    n_ent = tables["ent_embeddings"].shape[0]
    h, t, r = triples[:, 0], triples[:, 1], triples[:, 2]
    ids, rows = np.arange(n_ent)[None, :], np.arange(len(triples))
    out = {}
    for name, hh, tt, gold_ids in (("tail", h[:, None], ids, t),
                                   ("head", ids, t[:, None], h)):
        s = model_scores64(model, tables, hh, tt, r[:, None], p)
        gold = s[rows, gold_ids]
        gap = np.abs(s - gold[:, None])
        gap[rows, gold_ids] = np.inf
        out[name] = (gap <= NEAR_TIE_RTOL * np.abs(gold)[:, None]).sum(1)
    return out


def transh_scores64(q, w, table, sign: float, p: int) -> np.ndarray:
    """float64 [C, E] scores ‖q + sign·(e − (w·e)w)‖_p (B6's sweep)."""
    q, w, e = (np.asarray(x, np.float64) for x in (q, w, table))
    dot = w @ e.T
    res = q[:, None, :] + sign * (e[None] - dot[:, :, None] * w[:, None, :])
    return np.abs(res).sum(-1) if p == 1 else (res * res).sum(-1)


def transd_scores64(q, rp, table, cdot, sign: float, p: int) -> np.ndarray:
    """float64 [C, E] scores ‖q + sign·(e + cdot_e·rp)‖_p (B2's sweep)."""
    q, rp, e, cd = (np.asarray(x, np.float64) for x in (q, rp, table, cdot))
    res = q[:, None, :] + sign * (e[None] + cd[None, :, None]
                                  * rp[:, None, :])
    return np.abs(res).sum(-1) if p == 1 else (res * res).sum(-1)


def rotate_scores64(q, table, sign: float) -> np.ndarray:
    """float64 [C, E] modulus sums of q + sign·e over [re | im] rows (B3's
    sweep)."""
    q, e = np.asarray(q, np.float64), np.asarray(table, np.float64)
    res = q[:, None, :] + sign * e[None]
    d = res.shape[-1] // 2
    return np.sqrt(res[..., :d] ** 2 + res[..., d:] ** 2 + 1e-12).sum(-1)
