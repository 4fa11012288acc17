"""Triple classification: per-relation score thresholds fitted on the
validation split, accuracy reported on test.

Counterpart of ``openkeonspark_tpu/eval/classification.py``. Negatives
come from :func:`corrupt_split`, which draws from the same numpy stream as
the reference's, so both packages classify the same negatives. Scoring runs
through the torch model on the tables' device, or through a given
``score_fn`` (the grid's ``parallel.eval.ShardedTripleScorer``); the
threshold sweep runs on the host, as in the reference."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.data.dataset import Dataset, H, R, T
from openkeonspark_tpu_torch.data.index import KGIndex
from openkeonspark_tpu_torch.models.base import get_model


def _np_upper_bound(adj: np.ndarray, off: np.ndarray, cnt: np.ndarray,
                    x: np.ndarray) -> np.ndarray:
    """Vectorized per-window ``searchsorted(adj[off:off+cnt], x, 'right')``."""
    lo = np.zeros(len(off), np.int64)
    hi = cnt.astype(np.int64).copy()
    iters = int(max(cnt.max(), 1)).bit_length()
    probe_clip = np.maximum(cnt.astype(np.int64) - 1, 0)
    for _ in range(iters):
        mid = (lo + hi) >> 1
        probe = adj[off + np.minimum(mid, probe_clip)]
        right = (mid < hi) & (probe <= x)
        lo = np.where(right, mid + 1, lo)
        hi = np.where(right, hi, mid)
    return lo


def corrupt_split(triples: np.ndarray, index: KGIndex, n_ent: int,
                  seed: int) -> np.ndarray:
    """One filtered corrupted negative per triple (head or tail uniformly,
    the reference's ``getValidBatch``/``getTestBatch``), by the complement
    trick over the train group index."""
    rng = np.random.default_rng(seed)
    out = triples.copy()
    corrupt_head = rng.random(len(triples)) < 0.5
    for gi, rows, col in ((index.tr, np.nonzero(corrupt_head)[0], H),
                          (index.hr, np.nonzero(~corrupt_head)[0], T)):
        if len(rows) == 0:
            continue
        a = triples[rows, T] if col == H else triples[rows, H]
        b = triples[rows, R]
        off, cnt = gi.lookup(a, b)
        space = np.maximum(n_ent - cnt, 1)
        x = rng.integers(0, space).astype(np.int64)
        if len(gi.adj):
            k = _np_upper_bound(gi.adj, off.astype(np.int64), cnt, x)
        else:
            k = np.zeros(len(rows), np.int64)
        out[rows, col] = (x + k).astype(out.dtype)
    return out


@torch.no_grad()
def score_triples(params: Dict[str, torch.Tensor], cfg: Config, n_ent: int,
                  n_rel: int, triples: np.ndarray,
                  batch: int = 8192) -> np.ndarray:
    """Scores of id triples through the torch model (in the tables'
    dtype), float32 on the host."""
    model = get_model(cfg.model)(cfg, n_ent, n_rel, params)
    dev = params["ent_embeddings"].device
    outs = []
    for s in range(0, len(triples), batch):
        chunk = torch.from_numpy(
            np.ascontiguousarray(triples[s:s + batch], np.int64)).to(dev)
        outs.append(model.score_triples(chunk[:, H], chunk[:, T],
                                        chunk[:, R]).float().cpu().numpy())
    return np.concatenate(outs) if outs else np.empty(0, np.float32)


@dataclass
class Thresholds:
    """Per-relation decision thresholds (score < thresh ⇒ true) and a
    global fallback for relations unseen in valid."""

    per_rel: np.ndarray       # [R] float32
    has_rel: np.ndarray       # [R] bool — fitted from valid data?
    fallback: float

    def decide(self, scores: np.ndarray, rels: np.ndarray) -> np.ndarray:
        th = np.where(self.has_rel[rels], self.per_rel[rels], self.fallback)
        return scores < th


def _best_threshold(pos: np.ndarray, neg: np.ndarray) -> Tuple[float, float]:
    """Threshold maximizing accuracy of (pos classified true, neg false),
    swept over interval midpoints (the reference's ``getBestThreshold``)."""
    if len(pos) == 0:
        return 0.0, 0.0
    scores = np.concatenate([pos, neg])
    labels = np.concatenate([np.ones(len(pos), bool),
                             np.zeros(len(neg), bool)])
    order = np.argsort(scores, kind="stable")
    s_sorted, l_sorted = scores[order], labels[order]
    # below-threshold positives + at-or-above negatives are correct
    pos_below = np.concatenate([[0], np.cumsum(l_sorted)])
    neg_above = np.concatenate([[0], np.cumsum(~l_sorted)])
    neg_total = (~labels).sum()
    correct = pos_below + (neg_total - neg_above)  # [n+1] cut positions
    best = int(np.argmax(correct))
    n = len(scores)
    if best == 0:
        th = float(s_sorted[0]) - 1.0
    elif best == n:
        th = float(s_sorted[-1]) + 1.0
    else:
        th = float(s_sorted[best - 1] + s_sorted[best]) / 2.0
    return th, float(correct[best]) / n


def _scorer(cfg: Config, ds: Dataset, score_fn: Optional[Callable]):
    if score_fn is not None:
        return score_fn
    return lambda p, tr: score_triples(p, cfg, ds.n_ent, ds.n_rel, tr)


def fit_thresholds(params: Dict[str, torch.Tensor], cfg: Config, ds: Dataset,
                   index: KGIndex, neg_triples: Optional[np.ndarray] = None,
                   seed: int = 1234, score_fn: Optional[Callable] = None
                   ) -> Tuple[Thresholds, float]:
    """Fit per-relation thresholds on valid; returns (thresholds, valid
    accuracy). ``score_fn(params, triples) -> scores`` replaces the
    single-device scorer (``parallel.eval.ShardedTripleScorer`` for
    row-sharded tables), as the reference's ``score_fn`` does."""
    if ds.valid is None or not len(ds.valid):
        raise ValueError("no valid split")
    if neg_triples is None:
        neg_triples = corrupt_split(ds.valid, index, ds.n_ent, seed)
    score = _scorer(cfg, ds, score_fn)
    pos_s = score(params, ds.valid)
    neg_s = score(params, neg_triples)

    per_rel = np.zeros(ds.n_rel, np.float32)
    has_rel = np.zeros(ds.n_rel, bool)
    rels = ds.valid[:, R]
    for rel in np.unique(rels):
        m = rels == rel
        th, _ = _best_threshold(pos_s[m], neg_s[neg_triples[:, R] == rel])
        per_rel[rel] = th
        has_rel[rel] = True
    fallback, _ = _best_threshold(pos_s, neg_s)
    thr = Thresholds(per_rel=per_rel, has_rel=has_rel, fallback=fallback)

    dec_pos = thr.decide(pos_s, rels)
    dec_neg = thr.decide(neg_s, neg_triples[:, R])
    acc = (dec_pos.sum() + (~dec_neg).sum()) / (len(pos_s) + len(neg_s))
    return thr, float(acc)


def triple_classification(params: Dict[str, torch.Tensor], cfg: Config,
                          ds: Dataset, index: KGIndex,
                          thresholds: Optional[Thresholds] = None,
                          seed: int = 1234,
                          score_fn: Optional[Callable] = None
                          ) -> Dict[str, float]:
    """Fit on valid (unless given thresholds); report accuracy / precision /
    recall / F1 on test positives + one corrupted negative each.
    ``score_fn`` as in :func:`fit_thresholds`."""
    if ds.test is None or not len(ds.test):
        raise ValueError("no test split")
    valid_acc = None
    if thresholds is None:
        thresholds, valid_acc = fit_thresholds(params, cfg, ds, index,
                                               seed=seed, score_fn=score_fn)
    neg = corrupt_split(ds.test, index, ds.n_ent, seed + 1)
    score = _scorer(cfg, ds, score_fn)
    pos_s = score(params, ds.test)
    neg_s = score(params, neg)
    dec_pos = thresholds.decide(pos_s, ds.test[:, R])
    dec_neg = thresholds.decide(neg_s, neg[:, R])
    tp = int(dec_pos.sum())
    fn = len(pos_s) - tp
    fp = int(dec_neg.sum())
    tn = len(neg_s) - fp
    acc = (tp + tn) / max(tp + tn + fp + fn, 1)
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    out = {
        "accuracy": acc,
        "precision": prec,
        "recall": rec,
        "f1": 2 * prec * rec / max(prec + rec, 1e-12),
    }
    if valid_acc is not None:
        out["valid_accuracy"] = valid_acc
    return out
