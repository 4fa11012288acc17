"""Top-k answers judged against exact scores.

A query asks for the ``k`` entities of lowest TransE score that complete
(h, r, ?) or (?, r, t). Each candidate's exact score and its fp32 bound
``b`` come from :func:`kgbench.reference.ranks.exact_scores`. An answer
of ``k`` (id, score) pairs is sound when its ids are ``k`` distinct
entities, each reported score lies within ``b`` of its id's exact score,
the scores come in ascending order, and no entity left out is surely
better than one put in (``s(c) + b(c) < s(t) − b(t)``). Each pair that
breaks one of these counts once."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from kgbench.reference.ranks import exact_scores


def violations(E: torch.Tensor, R: torch.Tensor, queries: np.ndarray,
               answers: List[Tuple[np.ndarray, np.ndarray]], k: int,
               n_ent: int, block: int = 1024) -> np.ndarray:
    """int64 [Q]: the broken pairs of each answer. ``queries`` [Q, 3]
    holds (replace: 0 tail / 1 head, anchor, relation)."""
    out = np.zeros(len(queries), np.int64)
    for s in range(0, len(queries), block):
        q = queries[s:s + block]
        for code, replace in ((0, "tail"), (1, "head")):
            sel = np.flatnonzero(q[:, 0] == code)
            if not len(sel):
                continue
            S, b = exact_scores(E, R, q[sel, 1].astype(np.int64),
                                q[sel, 2].astype(np.int64), replace, n_ent)
            S, b = S.cpu().numpy(), b.cpu().numpy()
            for j, i in enumerate(sel):
                out[s + i] = _judge(S[j], b[j], *answers[s + i], k, n_ent)
    return out


def _judge(S: np.ndarray, b: np.ndarray, ids: np.ndarray,
           scores: np.ndarray, k: int, n_ent: int) -> int:
    ids = np.asarray(ids).astype(np.int64).ravel()
    scores = np.asarray(scores, np.float64).ravel()
    want = min(k, n_ent)
    bad = abs(len(ids) - want) + abs(len(scores) - len(ids))
    n = min(len(ids), len(scores))
    ids, scores = ids[:n], scores[:n]
    inside = (ids >= 0) & (ids < n_ent)
    bad += int((~inside).sum())
    ids, scores = ids[inside], scores[inside]
    bad += len(ids) - len(np.unique(ids))
    bad += int((np.abs(scores - S[ids]) > b[ids]).sum())
    bad += int((np.diff(scores) < 0).sum())
    rest = np.ones(n_ent, bool)
    rest[ids] = False
    if rest.any() and len(ids):
        best_left = (S[rest] + b[rest]).min()
        bad += int((S[ids] - b[ids] > best_left).sum())
    return bad


def lower_precision_answers(E: torch.Tensor, R: torch.Tensor,
                            queries: np.ndarray, k: int, n_ent: int,
                            dtype=torch.bfloat16):
    """The top-k answers of ``queries`` with every score computed in
    ``dtype``: the control."""
    El, Rl = E[:n_ent].to(dtype), R.to(dtype)
    out = []
    for code, a, r in queries.astype(np.int64):
        ea, rv = El[int(a)], Rl[int(r)]
        q = ea + rv if code == 0 else ea - rv
        s = (q[None, :] - El).abs().sum(-1).float()
        best, idx = torch.sort(s, stable=True)
        out.append((idx[:k].cpu().numpy(), best[:k].cpu().numpy()))
    return out
