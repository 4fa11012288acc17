"""The port's generic link-prediction route (``eval/link_prediction.py::
_rank_chunk``) against the JAX package's generic path, and the route
switches against the reference's: ``use_pallas_eval=False`` sends every
model there, ``OKST_EVAL_FORCE_GENERIC=1`` sends TransR and TransH there,
and TransH reaches B6 only with ``OKST_EVAL_TRANSH_KERNEL=1`` beside it.
Ranks are held to the JAX package's but for near-ties (two float orders,
``tests/torch_parity.py``)."""

import importlib

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
from openkeonspark_tpu_torch.models import get_model

from torch_parity import (model_near_tie_counts, port_config,
                          transr_near_tie_counts)

# the module, which its package's link_prediction function shadows
lp_mod = importlib.import_module(
    "openkeonspark_tpu_torch.eval.link_prediction")
CPU = torch.device("cpu")
MODELS = ["transe", "transh", "transr", "transd", "rotate", "distmult",
          "complex"]
TRANSH_KERNEL = "OKST_EVAL_TRANSH_KERNEL"
FORCE_GENERIC = "OKST_EVAL_FORCE_GENERIC"
# (OKST_EVAL_TRANSH_KERNEL, OKST_EVAL_FORCE_GENERIC) -> the reference's
# route (link_prediction.py:454-455, 463, 531-532)
ROUTES = {
    "transh": {(None, None): "grouped", ("1", None): "grouped",
               (None, "1"): "generic", ("1", "1"): "kernel"},
    "transr": {(None, None): "grouped", ("1", None): "grouped",
               (None, "1"): "generic", ("1", "1"): "generic"},
}


@pytest.fixture(scope="module")
def kg():
    ds = random_kg(n_ent=97, n_rel=6, n_triples=1200, n_valid=30,
                   n_test=60, seed=8)
    return ds, build_kg_index(ds, for_eval=True)


def _cfg(model, **kw):
    dims = ({"ent_size": 16, "rel_size": 8} if model == "transr" else
            {"hidden_size": 12 if model in ("rotate", "complex") else 16})
    return Config(model=model, p_norm=1, eval_chunk=16, eval_block=32,
                  **dims, **kw)


def _setup(kg, model, **kw):
    ds, idx = kg
    cfg = _cfg(model, **kw)
    st = init_state(jax_get_model(model), cfg, ds.n_ent, ds.n_rel,
                    jax.random.key(3))
    jp = {k: np.asarray(v) for k, v in st.params.items()}
    tcfg = port_config(cfg)
    tp = params_from_numpy(jp, get_model(model), tcfg, ds.n_ent, ds.n_rel,
                           CPU)
    return ds, idx, cfg, jp, tp, tcfg


def _ties(ds, tp, model, p):
    tables = {k: v[:-1].numpy() for k, v in tp.items()}
    if model == "transr":
        return transr_near_tie_counts(
            tables["ent_embeddings"], tables["rel_embeddings"],
            tables["transfer_matrix"], ds.test, p)
    return model_near_tie_counts(model, tables, ds.test, p)


def _assert_within_ties(got, want, ties):
    for k in want.ranks:
        diff = np.abs(got.ranks[k] - want.ranks[k])
        assert (diff <= ties[k.split("_")[1]]).all(), k


def _no_kernel_route(monkeypatch):
    """Make the kernel routes (and their plain versions) and the grouped
    route raise, so a test shows the generic route reached neither."""
    def refuse(*a, **k):
        raise AssertionError("the generic route reached a kernel route")
    monkeypatch.setattr(lp_mod, "_scorers", refuse)
    monkeypatch.setattr(lp_mod, "_grouped_link_prediction", refuse)


@pytest.mark.parametrize("model", MODELS)
def test_use_pallas_eval_false_matches_jax_generic_path(kg, model,
                                                        monkeypatch):
    """``use_pallas_eval=False``: every model ranks on the generic route
    (DistMult and ComplEx on the bilinear one, their generic route), no
    kernel route is reached, and the ranks equal the JAX package's
    generic path (no ``OKST_PALLAS_INTERPRET``) but for near-ties."""
    for var in (TRANSH_KERNEL, FORCE_GENERIC, "OKST_PALLAS_INTERPRET"):
        monkeypatch.delenv(var, raising=False)
    ds, idx, cfg, jp, tp, tcfg = _setup(kg, model, use_pallas_eval=False)
    assert lp_mod.eval_route(tcfg) == ("bilinear" if model in (
        "distmult", "complex") else "generic")
    want = jax_link_prediction(jp, cfg, ds, idx)
    if model not in ("distmult", "complex"):
        _no_kernel_route(monkeypatch)
    got = link_prediction(tp, tcfg, ds, idx)
    _assert_within_ties(got, want, _ties(ds, tp, model, 1))
    for d in ("head", "tail"):
        assert (got.ranks[f"filt_{d}"] <= got.ranks[f"raw_{d}"]).all()


@pytest.mark.parametrize("switches", list(ROUTES["transh"]))
@pytest.mark.parametrize("model", ["transh", "transr"])
def test_route_switches_follow_the_reference(kg, model, switches,
                                             monkeypatch):
    """The four settings of the two variables route TransH and TransR as
    the reference does (its kernel routes in interpret mode), and the
    port's ranks on that route equal the JAX package's but for
    near-ties."""
    ds, idx, cfg, jp, tp, tcfg = _setup(kg, model)
    for var, val in zip((TRANSH_KERNEL, FORCE_GENERIC), switches):
        if val is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, val)
    route = ROUTES[model][switches]
    assert lp_mod.eval_route(tcfg) == route
    monkeypatch.setenv("OKST_PALLAS_INTERPRET", "1")
    want = jax_link_prediction(jp, cfg, ds, idx)
    if route == "generic":
        _no_kernel_route(monkeypatch)
    lines = []
    got = link_prediction(tp, tcfg, ds, idx, log=lines.append)
    assert any("grouped" in s for s in lines) == (route == "grouped")
    _assert_within_ties(got, want, _ties(ds, tp, model, 1))


def test_generic_route_sweeps_in_blocks_and_chunks(kg, monkeypatch):
    """The generic route's ranks do not depend on the candidate block (one
    row, a ragged 32, the whole table), on the chunk, nor on whether the
    sweep is kept or computed twice."""
    for var in (TRANSH_KERNEL, FORCE_GENERIC):
        monkeypatch.delenv(var, raising=False)
    ds, idx, _, _, tp, tcfg = _setup(kg, "transd", use_pallas_eval=False)
    want = link_prediction(tp, tcfg, ds, idx).ranks
    for kw, elems in (({"eval_block": 1}, None), ({"eval_block": 1024}, None),
                      ({"eval_chunk": 7}, None), ({}, 16 * 40)):
        with pytest.MonkeyPatch.context() as mp:
            if elems is not None:
                mp.setattr(lp_mod, "BILINEAR_SWEEP_ELEMS", elems)
            got = link_prediction(tp, tcfg.replace(**kw), ds, idx).ranks
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(kw))
