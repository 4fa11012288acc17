"""The id scorers' padding contract on the CPU: the plain id scorers give
NaN for an id outside [0, rows), as the kernels do, and link prediction
pads its known-id windows with the swept table's row count, so no id in
[n_ent, rows) reaches a scorer and ranks equal the JAX package's whatever
the number of pad rows, on the chunked route (TransE, TransD, RotatE) and
the relation-by-relation route (TransR, TransH)."""

import jax
import numpy as np
import pytest
import torch

from openkeonspark_tpu.config import Config
from openkeonspark_tpu.data.index import build_kg_index
from openkeonspark_tpu.data.synth import random_kg
from openkeonspark_tpu.eval import link_prediction as jax_link_prediction
from openkeonspark_tpu.models import get_model as jax_get_model
from openkeonspark_tpu.train.step import init_state
from openkeonspark_tpu_torch.ckpt import params_from_numpy
from openkeonspark_tpu_torch.eval import link_prediction
from openkeonspark_tpu_torch.eval.link_prediction import eval_route
from openkeonspark_tpu_torch.models import get_model
from openkeonspark_tpu_torch.ops import rank

from torch_parity import (model_near_tie_counts, port_config,
                          transr_near_tie_counts)

CPU = torch.device("cpu")
# (model, p): RotatE has no norm to choose
SCORERS = [(m, p) for m in ("transe", "transh", "transd") for p in (1, 2)] + [
    ("rotate", None)]
ROUTES = ["transe", "transd", "rotate", "transr", "transh"]


def _operands(model, C, D, rows, g):
    """A scorer's leading operands, seeded: (q, table), (q, w, table) with
    unit normals, (q, rp, table, cdot); RotatE rows [re | im]."""
    width = 2 * D if model == "rotate" else D
    table = torch.from_numpy(g.standard_normal((rows, width), np.float32))
    q = torch.from_numpy(g.standard_normal((C, width), np.float32))
    v = torch.from_numpy(g.standard_normal((C, width), np.float32))
    if model == "transh":
        return q, v / v.norm(dim=1, keepdim=True), table
    if model == "transd":
        return q, v, table, (table * 0.1 * v[:1]).sum(1)
    return q, table


@pytest.mark.parametrize("sign", [-1.0, 1.0])
@pytest.mark.parametrize("model,p", SCORERS)
def test_plain_id_scorers_give_nan_outside_rows(model, p, sign):
    """Ids -1, rows and rows + 7 score NaN; every other id scores what it
    scores in a window without them, bit for bit; [C] ids as [C, K]."""
    g = np.random.default_rng(11)
    C, K, D, rows = 5, 9, 7, 23
    ops = _operands(model, C, D, rows, g)
    norm = () if p is None else (p,)
    scores = rank.KERNELS[model][3]
    ids = torch.from_numpy(g.integers(0, rows, (C, K)).astype(np.int32))
    bad = ids.clone()
    bad[:, 2], bad[1, 5], bad[3, 0] = -1, rows, rows + 7
    bad[4, :] = rows                    # a query whose window is all padding
    out = bad < 0
    out |= bad >= rows
    got = scores(*ops, bad, sign, *norm)
    want = scores(*ops, ids, sign, *norm)
    assert torch.isnan(got[out]).all()
    assert not torch.isnan(want).any()
    assert torch.equal(got[~out], want[~out])
    # the gold call's [C] ids
    one = torch.tensor([0, -1, rows, rows - 1, rows + 7], dtype=torch.int32)
    got1 = scores(*ops, one, sign, *norm)
    assert torch.isnan(got1[[1, 2, 4]]).all()
    assert torch.equal(got1[[0, 3]], scores(
        *ops, one.clamp(0, rows - 1), sign, *norm)[[0, 3]])


@pytest.fixture(scope="module")
def kg():
    ds = random_kg(n_ent=89, n_rel=5, n_triples=1100, n_valid=30,
                   n_test=90, seed=9)
    return ds, build_kg_index(ds, for_eval=True)


def _cfg(model):
    if model == "transr":
        return Config(model="transr", ent_size=16, rel_size=8, p_norm=1,
                      eval_chunk=16, eval_block=32)
    return Config(model=model, hidden_size=12 if model == "rotate" else 16,
                  p_norm=1, eval_chunk=16, eval_block=32)


def _tables(kg, model, pad):
    """(JAX params, the port's params with ``pad`` zero rows under every
    entity table, port config)."""
    ds, _ = kg
    cfg = _cfg(model)
    st = init_state(jax_get_model(model), cfg, ds.n_ent, ds.n_rel,
                    jax.random.key(6))
    jp = {k: np.asarray(v) for k, v in st.params.items()}
    tcfg = port_config(cfg)
    tp = params_from_numpy(jp, get_model(model), tcfg, ds.n_ent, ds.n_rel,
                           CPU)
    tp = {k: torch.cat([v, torch.zeros(pad - 1, v.shape[1])])
          if k.startswith("ent") else v for k, v in tp.items()}
    return st.params, tp, tcfg


def _ties(ds, tp, model):
    tables = {k: v[:ds.n_ent if k.startswith("ent") else ds.n_rel].numpy()
              for k, v in tp.items()}
    if model == "transr":
        return transr_near_tie_counts(
            tables["ent_embeddings"], tables["rel_embeddings"],
            tables["transfer_matrix"], ds.test, 1)
    return model_near_tie_counts(model, tables, ds.test, 1)


@pytest.fixture(scope="module")
def jax_ranks(kg):
    ds, idx = kg
    return {m: jax_link_prediction(_tables(kg, m, 1)[0], _cfg(m), ds, idx)
            for m in ROUTES}


@pytest.mark.parametrize("pad", [1, 8])
@pytest.mark.parametrize("model", ROUTES)
def test_ranks_match_jax_with_pad_rows(kg, jax_ranks, model, pad,
                                       monkeypatch):
    """With 1 or 8 pad rows the known windows are padded with the table's
    rows; ranks equal the JAX package's (but for near-ties) and are the
    same for both pad counts."""
    monkeypatch.delenv("OKST_EVAL_TRANSH_KERNEL", raising=False)
    ds, idx = kg
    _, tp, cfg = _tables(kg, model, pad)
    assert (eval_route(cfg) == "grouped") == (model in ("transr",
                                                        "transh"))
    got = link_prediction(tp, cfg, ds, idx)
    ties = _ties(ds, tp, model)
    want = jax_ranks[model]
    for k in want.ranks:
        diff = np.abs(got.ranks[k] - want.ranks[k])
        assert (diff <= ties[k.split("_")[1]]).all(), k
    if pad > 1:
        one = link_prediction(_tables(kg, model, 1)[1], cfg, ds, idx)
        for k in got.ranks:
            np.testing.assert_array_equal(got.ranks[k], one.ranks[k],
                                          err_msg=k)


@pytest.mark.parametrize("model", ROUTES)
def test_scorers_never_see_pad_row_ids(kg, model, monkeypatch):
    """Every id a scorer is given lies in [0, n_ent) or equals the table's
    row count (the window's padding), never in [n_ent, rows); each known
    window has padding, and the padding scores NaN."""
    monkeypatch.delenv("OKST_EVAL_TRANSH_KERNEL", raising=False)
    ds, idx = kg
    _, tp, cfg = _tables(kg, model, 8)
    rows = tp["ent_embeddings"].shape[0]
    seen = []
    # the relation-by-relation route sweeps projected tables with TransE's
    key = "transe" if model in ("transr", "transh") else model
    fns = rank.KERNELS[key]

    def recording(*args, **kw):
        ids = next(a for a in args if torch.is_tensor(a)
                   and a.dtype == torch.int32)
        out = fns[1](*args, **kw)
        seen.append((ids.clone(), out))
        return out

    monkeypatch.setitem(rank.KERNELS, key, (fns[0], recording, *fns[2:]))
    link_prediction(tp, cfg, ds, idx)
    assert seen
    windows = [(i, s) for i, s in seen if i.dim() == 2]
    assert windows and all((i == rows).any() for i, _ in windows)
    for ids, out in seen:
        assert not ((ids >= ds.n_ent) & (ids < rows)).any()
        assert ((ids >= 0) & (ids <= rows)).all()
        assert torch.isnan(out[ids == rows]).all()
        assert not torch.isnan(out[ids < ds.n_ent]).any()
