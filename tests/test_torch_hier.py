"""The port's hierarchical relay step (``parallel/hier.py``) on gloo
process grids, against the port's flat exchange step and the JAX
package's hierarchical step (the counterparts of ``tests/test_hier.py``):

- with the fp32 wire it equals the flat exchange step on the equal flat
  ``(H·Di, M)`` grid and the same draws, at rtol 1e-6 / atol 1e-7, on
  ``(2, 1, 2)`` and ``(2, 2, 1)``, for SGD and Adam, TransR and ComplEx,
  the small-table path, dedup ``off`` and ``both``, through both exact
  fallbacks at slack 0.01, and whatever the microbatches;
- it equals the JAX hierarchical step on the JAX draws and tables;
- its cross-host wire bytes are at least 2.5× below the flat step's on
  ``(2, 2, 2)`` at batch 2048, counted by
  ``parallel.comm.CollectiveCounter``;
- the bf16 ICI wire stays within ``tests/test_hier.py:179-196``'s bound;
- a dense gradient is rounded to the wire dtype once per rank and summed
  in fp32 (the JAX step sums in the wire dtype, ``hier.py:459``);
- the microbatches it runs are reported when the per-rank batch does not
  divide (``hier.py:137-140`` lowers them silently).

Each grid size runs its cases in one launch of ``torch_dist_worker.py``
(no jax in the ranks)."""

import jax
import numpy as np
import pytest
import torch

from openkeonspark_tpu.config import Config as JConfig
from openkeonspark_tpu.data.index import build_kg_index as jax_index
from openkeonspark_tpu.data.synth import random_kg as jax_random_kg
from openkeonspark_tpu.models import get_model as jax_model
from openkeonspark_tpu.models import strip_padding as jax_strip
from openkeonspark_tpu.parallel import (build_hier_train_step,
                                        make_mesh as jax_mesh,
                                        shard_sampler as jax_shard_sampler,
                                        shard_state as jax_shard_state)
from openkeonspark_tpu.sampling.device import DeviceSampler as JSampler
from openkeonspark_tpu.train.step import init_state as jax_init
from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.models import get_model
from openkeonspark_tpu_torch.parallel import (Grid, build_exchange_train_step,
                                              build_hier_train_step as
                                              port_hier_step,
                                              plan_sharded_step)

import torch_dist_worker as W
from test_torch_exchange import (KG_BIG, KG_SMALL, LR, STEPS, _noise_proxy,
                                 _params, _tables, cfg_kw)
from torch_parity import assert_tables_match, jax_row_draws

CPU = torch.device("cpu")


def flat_of(hier):
    """The flat grid of the same ranks and rows: (H·Di, M)."""
    return [hier[0] * hier[1], hier[2]]


# name -> (hier grid, cfg, kg, batch, steps); each runs the flat exchange
# step ("<name>/flat") and the hierarchical step ("<name>/hier")
PAIRS = {
    "sgd-212": ((2, 1, 2), cfg_kw(), KG_BIG, 64, STEPS),
    "sgd-221": ((2, 2, 1), cfg_kw(), KG_BIG, 64, STEPS),
    # Adam one step: a cancelled cell's sign compounds over steps
    "adam-212": ((2, 1, 2), cfg_kw(opt="adam"), KG_BIG, 64, 1),
    "adam-221": ((2, 2, 1), cfg_kw(opt="adam"), KG_BIG, 64, 1),
    "small-212": ((2, 1, 2), cfg_kw(), KG_SMALL, 64, STEPS),
    "transr-212": ((2, 1, 2), cfg_kw("transr"), KG_BIG, 64, STEPS),
    "complex-212": ((2, 1, 2), cfg_kw("complex"), KG_BIG, 64, STEPS),
    "dedup-off-212": ((2, 1, 2), cfg_kw(exchange_dedup="off"), KG_BIG, 64,
                      STEPS),
    "dedup-both-212": ((2, 1, 2), cfg_kw(exchange_dedup="both"), KG_BIG, 64,
                       STEPS),
    "overflow-212": ((2, 1, 2), cfg_kw(opt="adam", exchange_slack=0.01),
                     KG_BIG, 512, 1),
}
# hierarchical-only runs: name -> (grid, cfg, kg, batch, steps)
SINGLES = {
    "mb1": ((2, 1, 2), cfg_kw(exchange_microbatches=1), KG_BIG, 64, STEPS),
    "mb2": ((2, 1, 2), cfg_kw(exchange_microbatches=2), KG_BIG, 64, STEPS),
    "ici-f32": ((2, 2, 2), cfg_kw(), KG_BIG, 64, STEPS),
    "ici-bf16": ((2, 2, 2), cfg_kw(exchange_ici_wire_dtype="bfloat16"),
                 KG_BIG, 64, STEPS),
}
# the cross-host bytes: one step at tests/test_hier.py:146-176's geometry
BYTES_KW = cfg_kw(hidden_size=64, exchange_microbatches=1)
JAX_GRID = (2, 1, 2)


def _task(tmp, name, step, grid, kw, kg, batch, steps, **extra):
    return {"kind": "steps", "name": name, "grid": list(grid), "cfg": kw,
            "kg": kg, "params": _params(tmp, kw, kg), "step": step,
            "batch": batch, "steps": steps, **extra}


def jax_hier(tmp):
    """The JAX package's hierarchical step on ``JAX_GRID`` (fp32 wire,
    keys 0, 1, 2, batch 64) and the port task that runs its draws from
    its tables."""
    ds = jax_random_kg(**KG_BIG)
    model = jax_model("transe")
    kw = cfg_kw()
    cfg = JConfig(**kw)
    sampler = JSampler.build(ds, jax_index(ds, for_eval=False))
    mesh = jax_mesh(JAX_GRID)
    ss = jax_shard_sampler(sampler, mesh)
    state = jax_init(model, cfg, ds.n_ent, ds.n_rel, jax.random.key(0),
                     pad_to_multiple=8)
    step = jax.jit(build_hier_train_step(model, cfg, ss, 64, mesh))
    rows = JAX_GRID[0] * JAX_GRID[1]
    draws = jax_row_draws(sampler, cfg, rows, ds.n_train, 64 // rows)
    st = jax_shard_state(state, mesh, flat=True)
    batches, losses = {}, []
    for i in range(STEPS):
        key = jax.random.key(i)
        for d, b in enumerate(draws(key)):
            batches.update({f"s{i}_d{d}_{f}": v for f, v in b.items()})
        st, loss = step(st, ss, key)
        losses.append(float(loss))
    np.savez(tmp / "jax_init.npz",
             **{k: np.asarray(v) for k, v in state.params.items()})
    np.savez(tmp / "jax_batches.npz", **batches)
    want = {"loss": np.asarray(losses), "params": jax_strip(
        st.params, model.tables(cfg, ds.n_ent, ds.n_rel))}
    task = {"kind": "steps", "name": "jax/hier", "grid": list(JAX_GRID),
            "cfg": kw, "kg": KG_BIG, "params": str(tmp / "jax_init.npz"),
            "step": "hier", "batch": 64, "steps": STEPS,
            "batches": str(tmp / "jax_batches.npz")}
    return want, task


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hier")
    worlds = {4: [], 8: []}
    for name, (grid, kw, kg, batch, steps) in PAIRS.items():
        worlds[4] += [
            _task(tmp, f"{name}/flat", "exchange", flat_of(grid), kw, kg,
                  batch, steps),
            _task(tmp, f"{name}/hier", "hier", grid, kw, kg, batch, steps)]
    for name, (grid, kw, kg, batch, steps) in SINGLES.items():
        worlds[int(np.prod(grid))].append(
            _task(tmp, f"{name}/hier", "hier", grid, kw, kg, batch, steps))
    for name, step, grid in (("bytes/flat", "exchange", (4, 2)),
                             ("bytes/hier", "hier", (2, 2, 2))):
        worlds[8].append(_task(tmp, name, step, grid, BYTES_KW, KG_BIG,
                               2048, 1, count_bytes=4))
    worlds[4].append({"kind": "wire_sum", "name": "wire_sum",
                      "grid": [2, 1, 2]})
    jax_out, task = jax_hier(tmp)
    worlds[4].append(task)
    for ts in worlds.values():
        for t in ts:
            t["name"] = t["name"].replace("/", "__")
    got = W.launch(tmp, worlds)
    got = {k.replace("__", "/"): v for k, v in got.items()}
    got["jax"] = jax_out
    return got


@pytest.mark.parametrize("name", list(PAIRS))
def test_hier_matches_flat(runs, name):
    """Same draws: the gathered rows and per-row gradients are exact; only
    the order in which duplicate rows are summed differs (the relay sums
    the host's first)."""
    a, b = runs[f"{name}/flat"], runs[f"{name}/hier"]
    np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-6)
    assert_tables_match(_tables(a), b,
                        _noise_proxy(a, PAIRS[name][1]["opt_method"]),
                        msg=name)


def test_overflow_fallbacks_ran(runs):
    """At slack 0.01 both exact fallbacks run, stage 1 and stage 2 of the
    relay both drop ids, and the result above still equals the flat
    step's."""
    out = runs["overflow-212/hier"]
    gather, update = out["fallbacks"]
    assert gather > 0 and update > 0
    assert (out["overflow"] > 0).all(), out["overflow"]


def test_microbatch_invariance(runs):
    """Every microbatch takes its gradients at the same tables: one and two
    microbatches give the same tables."""
    assert_tables_match(_tables(runs["mb1/hier"]), runs["mb2/hier"],
                        msg="mb")
    assert runs["mb1/hier"]["microbatches"] == 1
    assert runs["mb2/hier"]["microbatches"] == 2


def test_hier_matches_jax(runs):
    """The port's hierarchical step on the JAX draws and tables against the
    JAX package's hierarchical step, at the fp32 wire."""
    want, got = runs["jax"], runs["jax/hier"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    assert_tables_match(want["params"], got, msg="jax")


def test_cross_host_bytes_drop(runs):
    """Rows cross hosts once per host, not once per rank: on (2, 2, 2) at
    batch 2048 the hierarchical step's cross-host wire bytes
    (``parallel.comm.CollectiveCounter``'s ``wire_dcn``, hosts of 4 ranks)
    are at least 2.5× below the flat (4, 2) step's, while it does cross
    hosts and its relay hops ride the links inside a host
    (``tests/test_hier.py:146-176``); the ``all_to_all``s alone cross
    hosts 2.5× less and send bytes inside a host as well."""
    flat, hier = runs["bytes/flat"], runs["bytes/hier"]
    assert hier["comm_wire_dcn"] * 2.5 <= flat["comm_wire_dcn"], (
        flat["comm_wire_dcn"], hier["comm_wire_dcn"])
    assert hier["comm_wire_dcn"] > 0
    assert hier["comm_wire_ici"] > 0
    assert hier["comm_a2a_wire_dcn"] > 0, hier
    assert hier["comm_a2a_wire_dcn"] * 2.5 <= flat["comm_a2a_wire_dcn"]
    assert hier["comm_a2a_wire_ici"] > 0, hier


def test_ici_bf16_stage1_close_to_f32(runs):
    """The bf16 ICI wire quantizes the stage-1 update route; after three SGD
    steps the tables track the fp32 run at bf16 resolution, the bound of
    ``tests/test_hier.py:179-196``."""
    pf = _tables(runs["ici-f32/hier"])
    pb = _tables(runs["ici-bf16/hier"])
    for k in pf:
        diff = np.abs(pf[k] - pb[k])
        rows, dim = pf[k].shape[0], pf[k].size // pf[k].shape[0]
        row_cap = max(2, int(0.01 * rows))
        tol = 0.02 * np.abs(pf[k]) + 0.01
        assert float(np.mean(diff > tol)) <= row_cap * dim / diff.size \
            + 0.01, k
        assert float(diff.max()) <= 2.0 * STEPS * LR, k
    assert np.abs(pf["ent_embeddings"] - pb["ent_embeddings"]).max() > 0


def test_dense_gradient_rounded_once_then_summed_in_fp32(runs):
    """``wire_sum`` at the bf16 wire: each rank's buffer rounded to bf16
    once, the four summed exactly in fp32 (magnitudes in [0.5, 2)); a sum
    in bf16, as the JAX step's ``psum`` in the wire dtype, rounds its
    partial sums and differs."""
    xs = [W.wire_sum_input(r).to(torch.bfloat16) for r in range(4)]
    exact = sum(x.double() for x in xs).float().numpy()
    np.testing.assert_array_equal(runs["wire_sum"]["got"], exact)
    in_bf16 = xs[0]
    for x in xs[1:]:
        in_bf16 = in_bf16 + x
    assert (in_bf16.float().numpy() != exact).any()


@pytest.mark.parametrize("step", ["hier", "flat"])
def test_microbatches_reported_when_lowered(step):
    """An odd per-rank batch (b_local / M = 3) cannot split in two: the
    step runs one microbatch and says so (``step.microbatches``), as the
    CLI's ``mesh:`` line then does."""
    cfg = Config(**cfg_kw(exchange_microbatches=2))
    model = get_model(cfg.model)
    if step == "hier":
        grid = Grid(2, 2, 0, CPU, hosts=2)
        assert plan_sharded_step(cfg, 12, grid) == "hier"
        fn = port_hier_step(model, cfg, grid, 12, 100)
    else:
        grid = Grid(2, 2, 0, CPU)
        fn = build_exchange_train_step(model, cfg, grid, 12, 100)
    assert fn.microbatches == 1
    fn = (port_hier_step if step == "hier" else build_exchange_train_step)(
        model, cfg, grid, 16, 100)
    assert fn.microbatches == 2


def test_hier_grid_shape():
    """A (host, data, model) grid is the flat (H·Di, M) grid's ranks with
    host-major local groups; the hierarchical step refuses a geometry that
    does not divide, as ``exchange.py:296-304`` does."""
    g = Grid(4, 2, 5, CPU, hosts=2)
    assert (g.size, g.local, g.d_idx, g.m_idx) == (8, 4, 2, 1)
    assert [g.axis_size(a) for a in ("local", "host", "data", "model")] \
        == [4, 2, 4, 2]
    cfg = Config(**cfg_kw())
    with pytest.raises(ValueError, match="divisible"):
        plan_sharded_step(cfg, 4 * 3, g)
    with pytest.raises(ValueError, match="exchange"):
        plan_sharded_step(cfg.replace(sharded_step="psum"), 16, g)
