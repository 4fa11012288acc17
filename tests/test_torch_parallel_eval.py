"""The port's sharded evaluators (``parallel/eval.py``) on gloo process
grids: link prediction, plain and type-constrained, on (1, 2) and (2, 2)
grids ranks every test triple as the port's single-device generic route
does, and as the JAX package's sharded evaluator does on its 8 virtual
CPU devices; triple classification through the sharded triple scorer, in
either row layout, equals the single-device classification
(``tests/test_parallel.py:228``). The ranks run in
``tests/torch_dist_worker.py``, which imports no jax."""

import jax
import numpy as np
import pytest
import torch

from openkeonspark_tpu.config import Config as JConfig
from openkeonspark_tpu.data.index import build_kg_index as jax_index
from openkeonspark_tpu.data.synth import random_kg as jax_random_kg
from openkeonspark_tpu.data.type_constrain import \
    build_type_constraints as jax_tc
from openkeonspark_tpu.models import get_model as jax_model
from openkeonspark_tpu.parallel import (make_mesh as jax_mesh,
                                        shard_state as jax_shard_state)
from openkeonspark_tpu.parallel.eval import (
    sharded_link_prediction as jax_sharded_lp,
    sharded_type_constrained_link_prediction as jax_sharded_tc)
from openkeonspark_tpu.train.step import init_state as jax_init
from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.data import (build_kg_index,
                                          build_type_constraints, random_kg)
from openkeonspark_tpu_torch.eval import (link_prediction,
                                          triple_classification,
                                          type_constrained_link_prediction)

import torch_dist_worker as W

KG = dict(n_ent=100, n_rel=6, n_triples=1000, n_valid=30, n_test=30, seed=2)
N_TEST, PAD = 24, 4
MODELS = ["transe", "transh", "transr", "transd", "distmult", "complex",
          "rotate"]
JAX_MODELS = ["transe", "transh", "transd", "distmult"]
GRIDS = [(1, 2), (2, 2)]
TC_MODELS = ["transe", "transh"]


def cfg_kw(model):
    return dict(model=model, hidden_size=16, eval_chunk=8, eval_block=32,
                use_pallas_eval=False)


def _gid(g):
    return f"{g[0]}x{g[1]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_eval")
    ds = jax_random_kg(**KG)
    jidx = jax_index(ds, for_eval=True)
    tds = random_kg(**KG)
    tidx = build_kg_index(tds, for_eval=True)
    tc = build_type_constraints(tds)
    triples = ds.test[:N_TEST]
    worlds = {2: [], 4: []}
    single, jax_ranks = {}, {}
    for model in MODELS:
        kw = cfg_kw(model)
        jcfg = JConfig(**kw)
        state = jax_init(jax_model(model), jcfg, ds.n_ent, ds.n_rel,
                         jax.random.key(8), pad_to_multiple=PAD)
        path = str(tmp / f"{model}.npz")
        np.savez(path, **{k: np.asarray(v) for k, v in state.params.items()})
        params = {k: torch.from_numpy(np.asarray(v).copy())
                  for k, v in state.params.items()}
        cfg = Config(**kw)
        single[model] = link_prediction(params, cfg, tds, tidx,
                                        triples=triples).ranks
        if model in TC_MODELS:
            single[model, "tc"] = type_constrained_link_prediction(
                params, cfg, tds, tidx, tc, triples=triples).ranks
        if model in JAX_MODELS:
            mesh = jax_mesh((2, 2))
            sh = jax_shard_state(state, mesh)
            jax_ranks[model] = jax_sharded_lp(sh.params, jcfg, ds, jidx,
                                              mesh, triples=triples).ranks
            if model in TC_MODELS:
                jax_ranks[model, "tc"] = jax_sharded_tc(
                    sh.params, jcfg, ds, jidx, jax_tc(ds), mesh,
                    triples=triples).ranks
        for g in GRIDS:
            base = {"grid": list(g), "cfg": kw, "kg": KG, "params": path}
            worlds[g[0] * g[1]].append(
                {**base, "kind": "link_prediction", "n_test": N_TEST,
                 "name": f"{model}-{_gid(g)}"})
            if model in TC_MODELS:
                worlds[g[0] * g[1]].append(
                    {**base, "kind": "link_prediction", "n_test": N_TEST,
                     "tc": True, "name": f"{model}-tc-{_gid(g)}"})
            if model == "transe":
                for flat in (False, True):
                    worlds[g[0] * g[1]].append(
                        {**base, "kind": "classification", "flat": flat,
                         "name": f"classify-{flat}-{_gid(g)}"})
        if model == "transe":
            single["classify"] = triple_classification(params, cfg, tds,
                                                       tidx)
    return W.launch(tmp, worlds), single, jax_ranks


@pytest.mark.parametrize("grid", GRIDS, ids=_gid)
@pytest.mark.parametrize("model", MODELS)
def test_sharded_ranks_equal_single_device(runs, model, grid):
    got, single, _ = runs
    for k, want in single[model].items():
        np.testing.assert_array_equal(got[f"{model}-{_gid(grid)}"][k],
                                      want, err_msg=k)


@pytest.mark.parametrize("grid", GRIDS, ids=_gid)
@pytest.mark.parametrize("model", JAX_MODELS)
def test_sharded_ranks_equal_jax_sharded(runs, model, grid):
    got, _, jax_ranks = runs
    for k, want in jax_ranks[model].items():
        np.testing.assert_array_equal(got[f"{model}-{_gid(grid)}"][k],
                                      want, err_msg=k)


@pytest.mark.parametrize("grid", GRIDS, ids=_gid)
@pytest.mark.parametrize("model", TC_MODELS)
def test_sharded_type_constrained_ranks(runs, model, grid):
    """The allowed masks sharded along the entity axis rank as the
    single-device dense masks and as the JAX sharded evaluator."""
    got, single, jax_ranks = runs
    out = got[f"{model}-tc-{_gid(grid)}"]
    for k in single[model, "tc"]:
        np.testing.assert_array_equal(out[k], single[model, "tc"][k],
                                      err_msg=k)
        np.testing.assert_array_equal(out[k], jax_ranks[model, "tc"][k],
                                      err_msg=k)
        assert (out[k] <= got[f"{model}-{_gid(grid)}"][k]).all()


@pytest.mark.parametrize("grid", GRIDS, ids=_gid)
@pytest.mark.parametrize("flat", [False, True])
def test_sharded_scorer_classifies_as_single_device(runs, flat, grid):
    """Thresholds fitted through ``ShardedTripleScorer`` (rows over
    'model', or over the whole grid) give the single-device metrics: the
    scores are the same bits."""
    got, single, _ = runs
    out = got[f"classify-{flat}-{_gid(grid)}"]
    for k, v in single["classify"].items():
        assert float(out[k]) == v, (k, float(out[k]), v)
