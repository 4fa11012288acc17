"""Link prediction's ranks, plainly, as the band that fp32 rounding allows.

A TransE (p = 1) triple's score is ``s = Σ_l |h_l + r_l − t_l|``, lower
is better. Ranking the tail of a test triple (h, r, t) counts the
entities ``c ≠ t`` with ``s(h, r, c) < s(h, r, t)`` (raw) and, filtered,
only those ``c`` that form no triple (h, r, c) in any split; the head
likewise. Ranks are kept 0-based: the count of better candidates.

Scores are computed here in float64 from the fp32 tables
(``torch.cdist`` with p = 1), exact to far below fp32's rounding. A score
the program computes in fp32 lies within

    b(c) = 1.01 · u · (‖a‖₁ + ‖r‖₁ + ‖e_c‖₁ + (D + 1) · s(c)),  u = 2⁻²⁴,

of the exact one, whatever order it adds the D lanes in and however it
associates the three terms of a lane: each lane's two rounded adds err by
at most u times the magnitudes they add, and a sum of D non-negative
terms by at most (D − 1)·u of its value (Higham, "Accuracy and Stability
of Numerical Algorithms", §4.2). So a program that scores in fp32 counts
every candidate with ``s(c) + b(c) < s(g) − b(g)`` and none with
``s(c) − b(c) ≥ s(g) + b(g)``: its count lies in ``[lo, hi]``, and most
bands are a single value. A score in a lower precision (bfloat16, TF32)
errs by hundreds of times ``b`` and falls outside."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

U32 = 2.0 ** -24
KINDS = ("raw_head", "raw_tail", "filt_head", "filt_tail")
METRICS = ("mr", "mrr", "hits1", "hits3", "hits10")


def sides(triples: np.ndarray, replace: str):
    """(anchor, relation, gold) columns of ``triples`` (h, t, r) when the
    ``replace`` side is ranked."""
    h, t, r = (triples[:, i].astype(np.int64) for i in range(3))
    return (h, r, t) if replace == "tail" else (t, r, h)


def exact_scores(E: torch.Tensor, R: torch.Tensor, anchor: np.ndarray,
                 rel: np.ndarray, replace: str, n_ent: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, b), float64 [C, n_ent]: the exact scores of every candidate for
    the queries (``anchor``, ``rel``) and each score's fp32 bound."""
    dev = E.device
    a = torch.from_numpy(anchor).to(dev)
    r = torch.from_numpy(rel).to(dev)
    E64 = E[:n_ent].double()
    A, Rv = E[a].double(), R[r].double()
    # tail: s = Σ|(a + r) − e|; head: s = Σ|e + r − a| = Σ|e − (a − r)|
    q = A + Rv if replace == "tail" else A - Rv
    S = torch.cdist(q[None], E64[None], p=1)[0]
    qn = (A.abs().sum(1) + Rv.abs().sum(1))[:, None]
    D = E.shape[1]
    b = 1.01 * U32 * (qn + E64.abs().sum(1)[None, :] + (D + 1) * S)
    return S, b


class Known:
    """The entities that complete (anchor, relation) in any split."""

    def __init__(self, all_triples: np.ndarray, n_ent: int, n_rel: int):
        h, t, r = (all_triples[:, i].astype(np.int64) for i in range(3))
        self.n_ent, self.n_rel = n_ent, n_rel
        self.codes = {"tail": np.unique((h * n_rel + r) * n_ent + t),
                      "head": np.unique((t * n_rel + r) * n_ent + h)}

    def mask(self, anchor: np.ndarray, rel: np.ndarray, replace: str,
             dev) -> torch.Tensor:
        """bool [C, n_ent]: True where the candidate is known true."""
        codes = self.codes[replace]
        key = (anchor * self.n_rel + rel) * self.n_ent
        lo = np.searchsorted(codes, key, "left")
        hi = np.searchsorted(codes, key + self.n_ent, "left")
        lens = hi - lo
        rows = np.repeat(np.arange(len(anchor)), lens)
        at = np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens, lens)
        vals = codes[np.repeat(lo, lens) + at] % self.n_ent
        m = torch.zeros(len(anchor), self.n_ent, dtype=torch.bool, device=dev)
        m[torch.from_numpy(rows).to(dev), torch.from_numpy(vals).to(dev)] = True
        return m


def bands(E: torch.Tensor, R: torch.Tensor, triples: np.ndarray,
          known: Known, block: int = 1024) -> Dict[str, np.ndarray]:
    """``{kind: lo}`` and ``{kind + "_hi": hi}`` int64 [N] for the four rank
    kinds of every triple."""
    n_ent, dev = known.n_ent, E.device
    out = {}
    for replace in ("head", "tail"):
        parts = {k: [] for k in ("raw", "raw_hi", "filt", "filt_hi")}
        for s in range(0, len(triples), block):
            anchor, rel, gold = sides(triples[s:s + block], replace)
            S, b = exact_scores(E, R, anchor, rel, replace, n_ent)
            g = torch.from_numpy(gold).to(dev)[:, None]
            sg, bg = S.gather(1, g), b.gather(1, g)
            other = torch.arange(n_ent, device=dev)[None, :] != g
            sure = (S + b < sg - bg) & other
            maybe = (S - b < sg + bg) & other
            unknown = ~known.mask(anchor, rel, replace, dev)
            for k, m in (("raw", sure), ("raw_hi", maybe),
                         ("filt", sure & unknown),
                         ("filt_hi", maybe & unknown)):
                parts[k].append(m.sum(1).cpu().numpy())
        for k, v in parts.items():
            base, hi = k.split("_hi")[0], k.endswith("_hi")
            out[f"{base}_{replace}" + ("_hi" if hi else "")] = \
                np.concatenate(v).astype(np.int64)
    return out


def lower_precision_ranks(E: torch.Tensor, R: torch.Tensor,
                          triples: np.ndarray, known: Known,
                          dtype=torch.bfloat16, block: int = 32
                          ) -> Dict[str, np.ndarray]:
    """The four rank kinds counted as the program counts them but with
    every score computed in ``dtype``: the control."""
    n_ent, dev = known.n_ent, E.device
    El = E[:n_ent].to(dtype)
    Rl = R.to(dtype)
    out = {k: [] for k in KINDS}
    for replace in ("head", "tail"):
        for s in range(0, len(triples), block):
            anchor, rel, gold = sides(triples[s:s + block], replace)
            a = torch.from_numpy(anchor).to(dev)
            r = torch.from_numpy(rel).to(dev)
            q = El[a] + Rl[r] if replace == "tail" else El[a] - Rl[r]
            S = (q[:, None, :] - El[None]).abs().sum(-1)
            g = torch.from_numpy(gold).to(dev)[:, None]
            other = torch.arange(n_ent, device=dev)[None, :] != g
            better = (S < S.gather(1, g)) & other
            unknown = ~known.mask(anchor, rel, replace, dev)
            out[f"raw_{replace}"].append(better.sum(1).cpu().numpy())
            out[f"filt_{replace}"].append(
                (better & unknown).sum(1).cpu().numpy())
    return {k: np.concatenate(v).astype(np.int64) for k, v in out.items()}


def metrics(ranks: np.ndarray) -> Dict[str, float]:
    """MR, MRR and Hits@1/3/10 of 0-based ranks."""
    r = ranks.astype(np.float64) + 1.0
    return {"mr": float(r.mean()), "mrr": float((1.0 / r).mean()),
            "hits1": float((r <= 1).mean()), "hits3": float((r <= 3).mean()),
            "hits10": float((r <= 10).mean())}


def outside(result: Dict[str, dict], band: Dict[str, np.ndarray]) -> int:
    """How many of a result's ranks, and of the metrics it reports for
    them, lie outside what the band allows. ``result`` holds ``ranks``
    ({kind: int [N]}) and ``metrics`` ({kind: {metric: value}})."""
    bad = 0
    for k in KINDS:
        lo, hi = band[k], band[k + "_hi"]
        got = np.asarray(result["ranks"].get(k, []))
        if got.shape != lo.shape:
            bad += len(lo)
            continue
        bad += int(((got < lo) | (got > hi)).sum())
        m_lo, m_hi = metrics(lo), metrics(hi)
        for name in METRICS:
            v = result["metrics"][k][name]
            a, b = sorted((m_lo[name], m_hi[name]))
            tol = 1e-12 * max(1.0, abs(a), abs(b))
            bad += int(not a - tol <= v <= b + tol)
    return bad
