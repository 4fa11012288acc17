"""Type-constrained link prediction: the candidates of the head (tail) slot
are the entities ``type_constrain.txt`` allows for the relation; ranks and
metrics are otherwise those of :func:`link_prediction` (raw and filtered,
head and tail).

Counterpart of ``openkeonspark_tpu/eval/type_constrained.py``
(``type_constrained_link_prediction`` ``:112-183``,
``_rank_chunk_constrained`` ``:38-90``). Dense per-relation masks ``[R,
rows]`` (uint8) go to the device once; each chunk gathers its queries'
mask rows by relation and ranks on the generic route
(``link_prediction._rank_chunk``) with the mask conjoined into the count:
a candidate counts only where it is allowed, and a known-true id is
subtracted only where it is allowed, never the gold. The gold needs no
mask bit of its own: the count is strict, so it never counts itself. The
reference's path has no ``pallas_call``, and this one runs no kernel: plain
torch ops, in ``cfg.eval_dtype``."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.data.dataset import Dataset
from openkeonspark_tpu_torch.data.index import KGIndex
from openkeonspark_tpu_torch.data.type_constrain import TypeConstraints
from openkeonspark_tpu_torch.eval.link_prediction import (
    LinkPredictionResult, _chunked_link_prediction, _rank_chunk,
    guard_finite_params, known_windows)
from openkeonspark_tpu_torch.runtime import check_supported, torch_dtype

# the reference's refusal (type_constrained.py:118-120): dense masks of
# more cells than this would not fit
MAX_MASK_CELLS = 1_000_000_000


@torch.no_grad()
def type_constrained_link_prediction(params: Dict[str, torch.Tensor],
                                     cfg: Config, ds: Dataset,
                                     index: KGIndex, tc: TypeConstraints,
                                     triples: Optional[np.ndarray] = None,
                                     log=None) -> LinkPredictionResult:
    """Type-constrained link prediction over ``triples`` (default: the test
    split) on the device the tables lie on; ``index`` built with
    ``for_eval=True``."""
    check_supported(cfg)
    if triples is None:
        triples = ds.test
    if triples is None or len(triples) == 0:
        raise ValueError("no test triples")
    if ds.n_ent * ds.n_rel > MAX_MASK_CELLS:
        raise ValueError("dense type-constraint masks too large for this "
                         "dataset; use unconstrained eval")
    dev = params["ent_embeddings"].device
    offs, k_max, vals_t, vals_h = known_windows(index, triples, dev)
    guard_finite_params(params)
    dt = torch_dtype(cfg.eval_dtype)
    params = {k: v.to(dt) for k, v in params.items()}
    rows = params["ent_embeddings"].shape[0]
    masks = {}
    for replace, mask in (("tail", tc.tail_mask(ds.n_ent)),
                          ("head", tc.head_mask(ds.n_ent))):
        full = np.zeros((ds.n_rel, rows), np.uint8)
        full[:, :ds.n_ent] = mask
        masks[replace] = torch.from_numpy(full).to(dev)

    def rank_chunk(h, t, r, replace, gold, known):
        return _rank_chunk(params, cfg, h, t, r, gold, known, replace,
                           ds.n_ent, allowed=masks[replace][r.long()])

    return LinkPredictionResult.from_ranks(_chunked_link_prediction(
        cfg, triples, offs, k_max, vals_t, vals_h, rows, dev, rank_chunk,
        log, label="type-constrained link-pred"))
