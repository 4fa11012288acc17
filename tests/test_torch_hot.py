"""The port's hot-row replication and degree-table capacities
(``parallel/hot.py``), against the JAX package's (the counterparts of
``tests/test_hot.py``):

- the degree tables, the hot set, every ``HotPlan`` capacity and
  ``flat_stats_caps`` equal the JAX package's, exactly;
- the hierarchical step with hot rows and ``'stats'`` capacities equals
  the JAX one on the JAX draws and tables (fp32 wire, rtol 1e-6 / atol
  1e-7) for TransE, TransD (two entity tables, one hot set), TransR with
  Adagrad and one relation negative; afterwards every rank's companions
  equal the sharded rows at the hot ids and are bit-identical across
  ranks;
- ``sync_hot_cache`` fills the companions from sharded and unsharded
  tables; the flat exchange step's ``'stats'`` capacities equal
  ``flat_stats_caps`` at the state's rows and change no result;
- the CAP_Z capacities rarely overflow (``tests/test_hot.py:324-354``);
- the reference faults stay repaired: a run without hot rows resumes into
  one with them (the JAX restore raises a ``KeyError``), and capacities
  come from the state's real local rows (the JAX step guesses them from
  the entity count).

The grid runs take one launch of ``torch_dist_worker.py`` (no jax in the
ranks)."""

import jax
import numpy as np
import pytest
import torch

from openkeonspark_tpu.config import Config as JConfig
from openkeonspark_tpu.data.index import build_kg_index as jax_index
from openkeonspark_tpu.data.synth import random_kg as jax_random_kg
from openkeonspark_tpu.models import get_model as jax_model
from openkeonspark_tpu.models import strip_padding as jax_strip
from openkeonspark_tpu.parallel import (build_train_step_for as jax_build,
                                        make_mesh as jax_mesh,
                                        shard_sampler as jax_shard_sampler,
                                        shard_state as jax_shard_state,
                                        sync_hot_cache as jax_sync)
from openkeonspark_tpu.parallel import hot as jhot
from openkeonspark_tpu.sampling.device import DeviceSampler as JSampler
from openkeonspark_tpu.train.step import init_state as jax_init
from openkeonspark_tpu_torch.ckpt import CheckpointManager, latest_step
from openkeonspark_tpu_torch.cli import train as train_cli
from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.data import (load_dataset, planted_kg,
                                          random_kg, save_dataset)
from openkeonspark_tpu_torch.models import get_model
from openkeonspark_tpu_torch.parallel import hot
from openkeonspark_tpu_torch.train.step import init_state

import torch_dist_worker as W
from test_torch_exchange import _noise_proxy, _params, _tables
from torch_parity import assert_tables_match, jax_row_draws

CPU = torch.device("cpu")
# test_hot.py's KG: Zipf-skewed entities, 3,000 of them, past
# SMALL_TABLE_ROWS on every grid here
KG = dict(n_ent=3000, n_rel=20, n_triples=8000, n_valid=50, n_test=50,
          seed=3)
# 512 entities: 520 physical rows padded to 8 (2× a grid of 4), past
# SMALL_TABLE_ROWS, where the JAX step's guess (4 × 128) is not
KG_EDGE = dict(n_ent=512, n_rel=6, n_triples=3000, n_valid=20, n_test=20,
               seed=5)
GRID, B, K, STEPS = (2, 1, 2), 512, 256, 3


def hot_kw(model, opt="sgd", neg_rel=0, **kw):
    out = dict(model=model, negative_ent=1, negative_rel=neg_rel,
               opt_method=opt, alpha=0.05, exchange_wire_dtype="float32",
               exchange_ici_wire_dtype="float32", exchange_hot_rows=K,
               exchange_capacity="stats")
    out.update(ent_size=16, rel_size=8) if model == "transr" \
        else out.update(hidden_size=16)
    out.update(kw)
    return out


# name -> (cfg, steps) of the JAX and port hierarchical runs with hot
# rows; Adam and Adagrad one step: they scale a cell's update by its own
# gradient's size, so a small cell's summation-order noise compounds
HOT_RUNS = {
    "transe": (hot_kw("transe"), STEPS),
    "transd-adam": (hot_kw("transd", "adam"), 1),
    "transr-adagrad": (hot_kw("transr", "adagrad"), 1),
    "transe-negrel": (hot_kw("transe", neg_rel=1), STEPS),
}


@pytest.fixture(scope="module")
def kg():
    return jax_random_kg(**KG), random_kg(**KG)


def jax_hot_runs(tmp, ds):
    """Each ``HOT_RUNS`` configuration through the JAX package's
    hierarchical step (keys 100, 101, 102, as ``tests/test_hot.py``), and
    the port tasks that run its draws from its tables."""
    sampler = JSampler.build(ds, jax_index(ds, for_eval=False))
    mesh = jax_mesh(GRID)
    ss = jax_shard_sampler(sampler, mesh)
    rows = GRID[0] * GRID[1]
    want, tasks = {}, []
    for name, (kw, steps) in HOT_RUNS.items():
        cfg = JConfig(**kw)
        model = jax_model(cfg.model)
        state = jax_init(model, cfg, ds.n_ent, ds.n_rel, jax.random.key(0),
                         pad_to_multiple=8)
        np.savez(tmp / f"{name}_init.npz",
                 **{k: np.asarray(v) for k, v in state.params.items()})
        st = jax_sync(jax_shard_state(state, mesh, flat=True), model, cfg,
                      sampler)
        step = jax.jit(jax_build(model, cfg, ss, B, mesh))
        draws = jax_row_draws(sampler, cfg, rows, ds.n_train, B // rows)
        batches, losses = {}, []
        for i in range(steps):
            key = jax.random.key(100 + i)
            for d, b in enumerate(draws(key)):
                batches.update({f"s{i}_d{d}_{f}": v for f, v in b.items()})
            st, loss = step(st, ss, key)
            losses.append(float(loss))
        np.savez(tmp / f"{name}_batches.npz", **batches)
        want[name] = {"loss": np.asarray(losses), "params": jax_strip(
            st.params, model.tables(cfg, ds.n_ent, ds.n_rel))}
        tasks.append({"kind": "steps", "name": name, "grid": list(GRID),
                      "cfg": kw, "kg": KG,
                      "params": str(tmp / f"{name}_init.npz"),
                      "step": "hier", "batch": B, "steps": steps,
                      "batches": str(tmp / f"{name}_batches.npz")})
    return want, tasks


@pytest.fixture(scope="module")
def runs(tmp_path_factory, kg):
    tmp = tmp_path_factory.mktemp("hot")
    want, tasks = jax_hot_runs(tmp, kg[0])
    base = {k: v for k, v in hot_kw("transe").items()
            if not k.startswith("exchange_hot") and k != "exchange_capacity"}
    for name, cap in (("flat-uniform", "uniform"), ("flat-stats", "stats")):
        kw = dict(base, exchange_capacity=cap)
        tasks.append({"kind": "steps", "name": name, "grid": [2, 2],
                      "cfg": kw, "kg": KG, "params": _params(tmp, kw, KG),
                      "step": "exchange", "batch": B, "steps": STEPS})
    edge = dict(hot_kw("transe", hidden_size=8), exchange_hot_rows=64)
    for name, step, grid in (("edge/hier", "hier", GRID),
                             ("edge/flat", "exchange", [2, 2])):
        tasks.append({"kind": "steps", "name": name, "grid": list(grid),
                      "cfg": edge, "kg": KG_EDGE,
                      "params": _params(tmp, edge, KG_EDGE), "step": step,
                      "batch": 64, "steps": 1})
    for t in tasks:
        t["name"] = t["name"].replace("/", "__")
    got = W.launch(tmp, {4: tasks})
    got = {k.replace("__", "/"): v for k, v in got.items()}
    got["jax"] = want
    got["init"] = {name: dict(np.load(tmp / f"{name}_init.npz"))
                   for name in HOT_RUNS}
    return got


@pytest.mark.parametrize("name", list(HOT_RUNS))
def test_hier_hot_stats_matches_jax(runs, kg, name):
    """Hot rows and degree-table capacities on (2, 1, 2): the port's step
    on the JAX draws and tables equals the JAX step. Afterwards each
    rank's companions (and slot companions) equal the sharded rows at the
    hot ids, bit for bit on every rank."""
    want, got = runs["jax"][name], runs[name]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    assert_tables_match(want["params"], got,
                        _noise_proxy(got, HOT_RUNS[name][0]["opt_method"]),
                        msg=name)
    dh, dt, _ = hot.degree_stats(kg[1])
    ids = hot.choose_hot_ids(dh, dt, K)
    names = [k[4:] for k in got if k.startswith("hot_")]
    assert "ent_embeddings" in names, names
    for k in names:
        reps = got[f"hot_{k}"]
        table = got.get(f"p_{k}", got.get(f"s_{k}"))
        for r in range(len(reps)):
            np.testing.assert_array_equal(reps[r], table[ids], err_msg=k)
            assert reps[r].tobytes() == reps[0].tobytes(), k


def test_sync_fills_sharded_companions(runs, kg):
    """``sync_hot_cache`` on the sharded initial state: every rank's
    companion is the initial table's rows at the hot ids."""
    dh, dt, _ = hot.degree_stats(kg[1])
    ids = hot.choose_hot_ids(dh, dt, K)
    init = runs["init"]["transd-adam"]
    for t in ("ent_embeddings", "ent_transfer"):
        got = runs["transd-adam"][f"sync_{t}"]
        assert got.shape == (4, K, 16)
        for r in range(4):
            np.testing.assert_array_equal(got[r], init[t][ids])
    np.testing.assert_array_equal(runs["transd-adam"]["sync_m_ent_transfer"],
                                  0.0)


def test_sync_hot_cache_one_device(kg):
    """On one device the companions are the table's rows at the hot ids,
    as the JAX package's ``sync_hot_cache`` gives them."""
    jds, ds = kg
    cfg = Config(model="transe", hidden_size=16, exchange_hot_rows=64,
                 exchange_capacity="stats", opt_method="adagrad")
    model = get_model("transe")
    st = init_state(model, cfg, ds.n_ent, ds.n_rel,
                    torch.Generator().manual_seed(1), CPU)
    comp = st.params["ent_embeddings#hot"]
    assert comp.shape == (64, 16) and not comp.any()
    assert st.opt_state["accum"]["ent_embeddings#hot"].shape == (64, 16)
    hot.sync_hot_cache(st, model, hot.degree_stats(ds))
    jsam = JSampler.build(jds, jax_index(jds, for_eval=False))
    ids = jhot.choose_hot_ids(*jhot.degree_stats(jsam)[:2], 64)
    np.testing.assert_array_equal(comp.numpy(),
                                  st.params["ent_embeddings"].numpy()[ids])
    np.testing.assert_array_equal(
        st.opt_state["accum"]["ent_embeddings#hot"].numpy(),
        st.opt_state["accum"]["ent_embeddings"].numpy()[ids])


def test_flat_stats_caps_change_nothing(runs, kg):
    """The flat exchange step's 'stats' capacities are
    ``flat_stats_caps`` at the state's local rows, and its tables equal
    the uniform capacities' run."""
    a, b = runs["flat-uniform"], runs["flat-stats"]
    np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-6)
    assert_tables_match(_tables(a), b, msg="stats")
    cfg = Config(**hot_kw("transe", exchange_hot_rows=0))
    lp = -(-(KG["n_ent"] + 1) // 8) * 8 // 4
    caps = hot.flat_stats_caps(get_model("transe"), cfg,
                               hot.degree_stats(kg[1]), B // 2 // 2 // 2,
                               lp, 4)
    np.testing.assert_array_equal(b["caps_ent_embeddings"],
                                  [caps["ent_embeddings"][k]
                                   for k in ("g", "u")])
    assert "caps_ent_embeddings" not in a


def test_capacities_from_the_real_local_rows(runs):
    """Tables padded to 2× a grid of 4 (520 rows of 512 entities): the
    hierarchical plan and the flat step's capacities come from the local
    130 rows, past ``SMALL_TABLE_ROWS``, so the entity table is planned,
    replicated and capped. The JAX step's guess, ceil(512 / 4) = 128 rows
    a rank, would call the table small and plan nothing for it."""
    ds = random_kg(**KG_EDGE)
    deg = hot.degree_stats(ds)
    model = get_model("transe")
    cfg = Config(**dict(hot_kw("transe", hidden_size=8),
                        exchange_hot_rows=64))
    got = runs["edge/hier"]
    assert int(got["lp"]) == 130
    plan = hot.HotPlan(model, cfg, deg, 64 // 2 // 2 // 2,
                       {"ent_embeddings": 130}, 2, 2)
    np.testing.assert_array_equal(got["caps_ent_embeddings"],
                                  [plan.caps["ent_embeddings"][k]
                                   for k in ("c2", "g1", "u1")])
    assert got["hot_ent_embeddings"].shape == (4, 64, 8)
    flat = hot.flat_stats_caps(model, cfg, deg, 64 // 2 // 2 // 2, 130, 4)
    np.testing.assert_array_equal(runs["edge/flat"]["caps_ent_embeddings"],
                                  [flat["ent_embeddings"][k]
                                   for k in ("g", "u")])
    assert_tables_match(_tables(runs["edge/flat"]), got, msg="edge")
    guess = -(-KG_EDGE["n_ent"] // 4)
    assert guess * 4 <= 512 < 130 * 4


@pytest.mark.parametrize("dedup", ["gather", "both", "off"])
@pytest.mark.parametrize("model_name,neg", [("transe", 1), ("transd", 2),
                                            ("transr", 1)])
def test_plan_and_caps_equal_jax(kg, dedup, model_name, neg):
    """Degree tables, hot ids and every capacity equal the JAX package's,
    exactly, for the same dataset and geometry."""
    jds, ds = kg
    deg = hot.degree_stats(ds)
    jsam = JSampler.build(jds, jax_index(jds, for_eval=False))
    jdh, jdt, jT = jhot.degree_stats(jsam)
    np.testing.assert_array_equal(deg[0], jdh)
    np.testing.assert_array_equal(deg[1], jdt)
    assert deg[2] == jT
    kw = dict(hot_kw(model_name), negative_ent=neg, exchange_dedup=dedup)
    cfg, jcfg = Config(**kw), JConfig(**kw)
    model, jm = get_model(model_name), jax_model(model_name)
    assert hot.entity_table_names(model) == jhot.entity_table_names(jm)
    for lp, L, H in ((376, 4, 2), (752, 2, 2), (1500, 1, 2)):
        lps = {t: lp for t in hot.entity_table_names(model)}
        p = hot.HotPlan(model, cfg, deg, 64, lps, L, H)
        q = jhot.HotPlan(jm, jcfg, jsam, 64, lps, L, H)
        np.testing.assert_array_equal(p.hot_ids_np, q.hot_ids_np)
        assert p.hot_tables == q.hot_tables and p.caps == q.caps
        assert hot.flat_stats_caps(model, cfg, deg, 64, lp, L * H) == \
            jhot.flat_stats_caps(jm, jcfg, jsam, 64, lp, L * H)
    assert hot.hot_k(Config(exchange_hot_rows=100,
                            exchange_capacity="stats"), ds.n_ent) == 96


def test_stats_caps_rarely_overflow_monte_carlo(kg):
    """200 simulated host chunks at the plan's own geometry overflow the
    stage-2 capacity at most twice (``tests/test_hot.py:324-354``)."""
    _, ds = kg
    L, H, n_grid, b_sub = 4, 2, 8, 256
    lp = -(-ds.n_ent // n_grid)
    cfg = Config(model="transe", hidden_size=32, negative_ent=1,
                 exchange_hot_rows=128, exchange_capacity="stats")
    plan = hot.HotPlan(get_model("transe"), cfg, hot.degree_stats(ds),
                       b_sub, {"ent_embeddings": lp}, L, H)
    cap2 = plan.caps["ent_embeddings"]["c2"]
    cold = np.ones(lp * n_grid, bool)
    cold[plan.hot_ids_np] = False
    owner = np.arange(lp * n_grid) // lp
    rng = np.random.default_rng(0)
    overflows = 0
    for _ in range(200):
        pos = rng.integers(0, len(ds.train), L * b_sub)
        ids = np.unique(np.concatenate([
            ds.train[pos, 0], ds.train[pos, 1],
            rng.integers(0, ds.n_ent, L * b_sub)]))
        ids = ids[cold[ids]]
        if np.bincount(owner[ids], minlength=n_grid).max() > cap2:
            overflows += 1
    assert overflows <= 2, (overflows, cap2)


def test_resume_without_hot_rows_into_hot_rows(tmp_path):
    """A checkpoint written without hot rows resumes into a run with them
    (the JAX restore raises ``KeyError '…#hot'``): the missing companions
    restore as zeros, ``sync_hot_cache`` fills them from the restored
    tables, and the tables and slots equal an uninterrupted hot-row run's
    bit for bit."""
    save_dataset(planted_kg(n_ent=200, n_rel=5, n_triples=2000, n_valid=50,
                            n_test=50, dim=8, noise=0.0, seed=1),
                 str(tmp_path / "kg"))
    argv = ["--input", str(tmp_path / "kg"), "--device", "cpu", "--model",
            "transe", "--hidden_size", "8", "--alpha", "0.05",
            "--nbatches", "5", "--negative_ent", "1", "--opt_method",
            "adagrad", "--log_every", "100"]
    hot_flags = ["--exchange_hot_rows", "16", "--exchange_capacity",
                 "stats"]
    resumed, whole = tmp_path / "resumed", tmp_path / "whole"
    train_cli.main(argv + ["--output", str(resumed), "--train_times", "1"])
    first = CheckpointManager(str(resumed)).restore(init_state(
        get_model("transe"), Config(model="transe", hidden_size=8,
                                    opt_method="adagrad"), 200, 5,
        torch.Generator(), CPU))[0]
    train_cli.main(argv + hot_flags + ["--output", str(resumed),
                                       "--train_times", "2"])
    train_cli.main(argv + hot_flags + ["--output", str(whole),
                                       "--train_times", "2"])
    step = latest_step(str(whole))
    assert latest_step(str(resumed)) == step == 10

    def load(out):
        return torch.load(str(out / f"step_{step}" / "state.pt"),
                          weights_only=True)

    a, b = load(resumed), load(whole)
    for tree in ("params", "opt_state"):
        assert a[tree].keys() == b[tree].keys()
    for k, v in b["params"].items():
        if not k.endswith("#hot"):
            assert torch.equal(a["params"][k], v), k
    for s, slots in b["opt_state"].items():
        for k, v in slots.items():
            if not k.endswith("#hot"):
                assert torch.equal(a["opt_state"][s][k], v), k
    ids = torch.from_numpy(hot.choose_hot_ids(*hot.degree_stats(
        load_dataset(str(tmp_path / "kg")))[:2], 16)).long()
    # one device never updates a companion: the resumed run's is the
    # restored table's rows at the hot ids, filled by the sync
    assert torch.equal(a["params"]["ent_embeddings#hot"],
                       first.params["ent_embeddings"][ids])
    assert torch.equal(a["opt_state"]["accum"]["ent_embeddings#hot"],
                       first.opt_state["accum"]["ent_embeddings"][ids])
