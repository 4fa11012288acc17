"""Hot-row replication and degree-table exchange capacities.

Counterpart of ``openkeonspark_tpu/parallel/hot.py`` (its numpy logic is
re-written here, not imported):

- **Hot-row replication** (``cfg.exchange_hot_rows``). The top-K
  highest-degree entity rows live, besides their sharded home, in a small
  replicated companion ``<table>#hot`` ([K, d], and one companion per
  optimizer slot). The hierarchical step (``parallel/hier.py``) reads hot
  ids from the companion (no wire), sums their gradients into one dense
  ``[K, d + 1]`` buffer reduced over the grid, applies the same update to
  every replica, and mirrors the owned hot rows back into the sharded
  tables, so checkpoints, export and evaluation read the sharded tables
  as before.
- **Degree-table capacities** (``cfg.exchange_capacity='stats'``). Every
  owner-bucket capacity is sized from the dataset's degree tables:
  P(row i touched by a stream) = 1 − exp(−λ_i), λ_i = m_h·deg_h(i)/T +
  m_t·deg_t(i)/T + m_u/n_ent, and the capacity is the largest bucket's
  mean + ``CAP_Z``·σ. Overflow past it takes the steps' exact fallbacks.

The statistics come from the training triples (:func:`degree_stats`), the
same (h, t) columns the JAX package reads from its sampler's packed store
(``hot.py:87-98``) and the port's sampler holds as ``trip[:, 0:2]``
(``sampling/device.py``). On a grid the tables are row-sharded local
tensors, so :func:`sync_hot_cache` is a collective."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.data.dataset import H as HEAD, T as TAIL
from openkeonspark_tpu_torch.data.dataset import Dataset
from openkeonspark_tpu_torch.models.base import KGEModel
from openkeonspark_tpu_torch.parallel.mesh import HOT_SUFFIX, all_reduce

# (head degree [n_ent], tail degree [n_ent], training triples)
Degrees = Tuple[np.ndarray, np.ndarray, int]

# Headroom over the expected largest bucket load: capacity = max over
# buckets of mean + CAP_Z·σ, a per-bucket overflow probability of ~2e-4
# (``hot.py:163-171``).
CAP_Z = 3.5


def is_hot_key(name: str) -> bool:
    return name.endswith(HOT_SUFFIX)


def drop_hot(params: Dict) -> Dict:
    """``params`` without the ``#hot`` companions (evaluation reads the
    sharded tables only, ``parallel/eval.py:48-53``)."""
    return {k: v for k, v in params.items() if not is_hot_key(k)}


def entity_table_names(model: KGEModel) -> Tuple[str, ...]:
    """Tables gathered through entity anchors (h/t): their id space is the
    entity ids, and they share one hot set."""
    return tuple(sorted({table for _, table, anchor in model.gathers()
                         if anchor in ("h", "t")}))


def hot_k(cfg: Config, n_ent: int) -> int:
    """Hot-set size: ``cfg.exchange_hot_rows`` clamped to the entity count
    and floored to a multiple of 8; 0 turns replication off."""
    k = min(cfg.exchange_hot_rows, n_ent)
    k -= k % 8
    return max(0, k)


def degree_stats(ds: Dataset) -> Degrees:
    """(head degree, tail degree, n_train) of the training triples."""
    n = ds.n_ent
    return (np.bincount(ds.train[:, HEAD], minlength=n).astype(np.float64),
            np.bincount(ds.train[:, TAIL], minlength=n).astype(np.float64),
            int(len(ds.train)))


def choose_hot_ids(dh: np.ndarray, dt: np.ndarray, k: int) -> np.ndarray:
    """Ascending int32 ids of the ``k`` entities of highest total degree
    (ties to the lower id, so every process picks the same set)."""
    if k <= 0:
        return np.zeros((0,), np.int32)
    deg = dh + dt
    top = (np.argpartition(-deg, min(k, len(deg) - 1))[:k] if k < len(deg)
           else np.arange(len(deg)))
    top = top[np.lexsort((top, -deg[top]))][:k]
    return np.sort(top).astype(np.int32)


def expected_counts(dh: np.ndarray, dt: np.ndarray, n_train: int,
                    n_ent: int, m_h: float, m_t: float, m_u: float,
                    rows_phys: int) -> np.ndarray:
    """Expected entries of a stream of ``m_h`` head-degree, ``m_t``
    tail-degree and ``m_u`` uniform draws hitting each row (the mass of a
    stream that is not deduplicated); padding rows are never hit."""
    lam = np.zeros(rows_phys, np.float64)
    lam[:n_ent] = (m_h * dh / max(1, n_train) + m_t * dt / max(1, n_train)
                   + m_u / n_ent)
    return lam


def touch_probs(dh: np.ndarray, dt: np.ndarray, n_train: int, n_ent: int,
                m_h: float, m_t: float, m_u: float,
                rows_phys: int) -> np.ndarray:
    """P(row touched) by the same stream, 1 − exp(−λ) (the mass of a
    deduplicated stream)."""
    return 1.0 - np.exp(-expected_counts(dh, dt, n_train, n_ent, m_h, m_t,
                                         m_u, rows_phys))


def _cap(load_max: float, n_ids: int,
         local_rows: Optional[int] = None) -> int:
    """``load_max`` rounded up to a multiple of 8 and clamped to [8,
    n_ids] (and the owner's rows when given), as
    ``exchange.capacity_for`` clamps."""
    c = -(-int(np.ceil(load_max)) // 8) * 8
    c = max(8, min(n_ids, c))
    if local_rows is not None:
        c = min(c, local_rows)
    return max(1, c)


def stream_mix(model: KGEModel, table: str, b: int,
               negative_ent: int) -> Tuple[float, float, float]:
    """(m_h, m_t, m_u) of one rank's stream for ``table`` at sub-batch
    ``b``: a degree draw per h- or t-anchored slot's positives, and one
    uniform draw per (positive, entity negative) — the uncorrupted side
    repeats the positive's id."""
    nh = sum(1 for _, tb, a in model.gathers() if tb == table and a == "h")
    nt = sum(1 for _, tb, a in model.gathers() if tb == table and a == "t")
    return (float(nh * b), float(nt * b),
            float(min(1, nh + nt) * negative_ent * b))


def bucket_cap(weights: np.ndarray, cold: np.ndarray, groups: np.ndarray,
               n_groups: int, n_ids: int, local_rows: Optional[int] = None,
               var: Optional[np.ndarray] = None) -> int:
    """max over buckets of (mean + CAP_Z·σ) load: ``weights`` is each
    row's expected mass, ``var`` its variance (Poisson, ``weights``, by
    default), ``groups`` its bucket and ``cold`` masks the replicated hot
    rows, which are never routed."""
    mean = np.bincount(groups, weights=weights * cold, minlength=n_groups)
    v = np.bincount(groups, weights=(var if var is not None else weights)
                    * cold, minlength=n_groups)
    return _cap((mean + CAP_Z * np.sqrt(v)).max(), n_ids, local_rows)


def _stream_weights(degrees: Degrees, rows_phys: int):
    """``w(m_h, m_t, m_u, dedup)``: a stream's per-row mass."""
    dh, dt, n_train = degrees
    n_ent = len(dh)

    def w(m_h, m_t, m_u, dedup):
        f = touch_probs if dedup else expected_counts
        return f(dh, dt, n_train, n_ent, m_h, m_t, m_u, rows_phys)

    return w


class HotPlan:
    """The hot set and the hierarchical step's stage capacities for one
    (model, cfg, dataset, grid geometry) (``hot.py:193-269``):
    ``hot_ids_np`` (ascending), ``hot_tables`` (the entity tables that
    replicate it) and ``caps[table] = {'g1', 'u1', 'c2'}`` (gather stage
    1, update stage 1, the shared stage 2) for the tables of
    ``lp_by_table`` (their local row counts). A deduplicated stream is
    sized on touch probabilities, a raw one on expected counts."""

    def __init__(self, model: KGEModel, cfg: Config, degrees: Degrees,
                 b_sub: int, lp_by_table: Dict[str, int], L: int, H: int):
        dh, dt, _ = degrees
        self.lp_by_table = dict(lp_by_table)
        self.k = hot_k(cfg, len(dh))
        self.use_stats = cfg.exchange_capacity == "stats"
        self.hot_tables = (tuple(t for t in entity_table_names(model)
                                 if t in lp_by_table) if self.k else ())
        self.hot_ids_np = (choose_hot_ids(dh, dt, self.k) if self.k
                           else np.zeros((0,), np.int32))
        self.caps: Dict[str, Dict[str, int]] = {}
        if not self.use_stats:
            return
        neg = cfg.negative_ent
        dg = cfg.exchange_dedup in ("gather", "both")
        du = cfg.exchange_dedup == "both"
        for table, lp in lp_by_table.items():
            rows_phys = lp * L * H
            owner = np.arange(rows_phys) // lp
            relay = owner % L
            cold = np.ones(rows_phys, bool)
            if table in self.hot_tables:
                cold[self.hot_ids_np] = False
            m_h, m_t, m_u = stream_mix(model, table, b_sub, neg)
            if m_h + m_t + m_u == 0:
                continue
            n_g = int(np.ceil((m_h + m_t) * (1 + neg)))   # raw gather length
            n_u = int(np.ceil(m_h + m_t + m_u))           # update length
            w = _stream_weights(degrees, rows_phys)
            # a raw gather stream counts every negative slot as a draw
            wg = (w(m_h, m_t, m_u, True) if dg else
                  w(m_h * (1 + neg), m_t * (1 + neg), m_u, False))
            g1 = bucket_cap(wg, cold, relay, L, n_g,
                            local_rows=H * lp if dg else None,
                            var=wg * (1 - wg) if dg else None)
            wu = w(m_h, m_t, m_u, du)
            u1 = bucket_cap(wu, cold, relay, L, n_u,
                            var=wu * (1 - wu) if du else None)
            # stage 2: the relay at local position ρ serves exactly the
            # rows of device O·L + ρ, so the bucket load is a device's cold
            # mass in the host's deduplicated union
            wh = w(L * m_h, L * m_t, L * m_u, True)
            c2 = bucket_cap(wh, cold, owner, H * L, L * max(n_g, n_u),
                            local_rows=lp, var=wh * (1 - wh))
            self.caps[table] = {"g1": g1, "u1": u1, "c2": c2}


def flat_stats_caps(model: KGEModel, cfg: Config, degrees: Degrees,
                    b_sub: int, lp: int, n_grid: int
                    ) -> Dict[str, Dict[str, int]]:
    """Degree-table capacities of the flat exchange's ``n_grid`` owner
    buckets, ``{table: {'g': gather, 'u': update}}`` (``hot.py:272-310``),
    for entity tables of ``lp`` local rows."""
    neg = cfg.negative_ent
    dg = cfg.exchange_dedup in ("gather", "both")
    du = cfg.exchange_dedup == "both"
    rows_phys = lp * n_grid
    owner = np.arange(rows_phys) // lp
    cold = np.ones(rows_phys, bool)
    w = _stream_weights(degrees, rows_phys)
    out: Dict[str, Dict[str, int]] = {}
    for table in entity_table_names(model):
        m_h, m_t, m_u = stream_mix(model, table, b_sub, neg)
        if m_h + m_t + m_u == 0:
            continue
        n_g = int(np.ceil((m_h + m_t) * (1 + neg)))
        n_u = int(np.ceil(m_h + m_t + m_u))
        wg = (w(m_h, m_t, m_u, True) if dg else
              w(m_h * (1 + neg), m_t * (1 + neg), m_u, False))
        wu = w(m_h, m_t, m_u, du)
        out[table] = {
            "g": bucket_cap(wg, cold, owner, n_grid, n_g,
                            local_rows=lp if dg else None,
                            var=wg * (1 - wg) if dg else None),
            "u": bucket_cap(wu, cold, owner, n_grid, n_u,
                            local_rows=lp if du else None,
                            var=wu * (1 - wu) if du else None)}
    return out


def init_hot_params(params: Dict[str, torch.Tensor], model: KGEModel,
                    cfg: Config, n_ent: int) -> Dict[str, torch.Tensor]:
    """Add a zeroed companion ``<table>#hot`` [K, d], in the table's dtype
    and on its device, for every entity table (before the optimizer's
    init, so each slot gets a companion too); :func:`sync_hot_cache`
    fills them."""
    k = hot_k(cfg, n_ent)
    if k <= 0:
        return params
    for t in entity_table_names(model):
        if t in params:
            params[t + HOT_SUFFIX] = params[t].new_zeros(
                (k, params[t].shape[1]))
    return params


def sync_hot_cache(state, model: KGEModel, degrees: Degrees, sharding=None):
    """Refill every companion (values and optimizer slots) from the
    authoritative tables at the hot ids: after init or a restore, before
    the first step; no-op when the state carries none. With ``sharding``
    (the state's row layout on a grid) it is a collective: each rank
    writes the hot rows it owns into a zeroed [K, d] buffer and one fp32
    ``all_reduce`` over the layout's axis fills every replica, exactly
    (each element has one nonzero contributor). Updates the state in
    place and returns it."""
    names = [t for t in entity_table_names(model)
             if t + HOT_SUFFIX in state.params]
    if not names:
        return state
    dh, dt, _ = degrees
    k = state.params[names[0] + HOT_SUFFIX].shape[0]
    ids = torch.from_numpy(choose_hot_ids(dh, dt, k)).long().to(
        state.params[names[0]].device)

    def refill(table: torch.Tensor, companion: torch.Tensor) -> None:
        if sharding is None:
            companion.copy_(table[ids])
            return
        lp = table.shape[0]
        lid = ids - sharding.index * lp
        owned = (lid >= 0) & (lid < lp)
        buf = torch.zeros(companion.shape, dtype=torch.float32,
                          device=companion.device)
        buf[owned] = table[lid[owned]].float()
        companion.copy_(all_reduce(buf, sharding.grid, sharding.axis))

    for t in names:
        refill(state.params[t], state.params[t + HOT_SUFFIX])
        for slots in state.opt_state.values():
            refill(slots[t], slots[t + HOT_SUFFIX])
    return state
