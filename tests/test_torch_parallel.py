"""The port's psum step (``parallel/sharded.py``) on (data, model) grids of
gloo processes, held two ways on the same per-data-row batches (the JAX
package's draws, made outside ``shard_map`` as ``parallel/sharded.py:95-104``
makes them) and the same tables, rtol 1e-6 / atol 1e-7
(``tests/test_parallel.py:63``): against the JAX package's sharded step
on its 8 virtual CPU devices, and against the port's single-device step
on the union of the data rows' batches (the gradient-sum semantics of
``tests/test_parallel.py:138``). A (1, 1) grid equals the port's
single-device step bit for bit. The ranks run in
``tests/torch_dist_worker.py``, which imports no jax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openkeonspark_tpu.config import Config as JConfig
from openkeonspark_tpu.data.index import build_kg_index as jax_index
from openkeonspark_tpu.data.synth import random_kg as jax_random_kg
from openkeonspark_tpu.models import get_model as jax_model
from openkeonspark_tpu.models import strip_padding as jax_strip
from openkeonspark_tpu.parallel import (build_sharded_train_step,
                                        make_mesh as jax_mesh,
                                        shard_sampler as jax_shard_sampler,
                                        shard_state as jax_shard_state)
from openkeonspark_tpu.sampling.device import DeviceSampler as JSampler
from openkeonspark_tpu.train.step import init_state as jax_init
from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.data import build_kg_index, random_kg
from openkeonspark_tpu_torch.models import get_model
from openkeonspark_tpu_torch.models.base import strip_padding
from openkeonspark_tpu_torch.parallel import (Grid, build_sharded_train_step
                                              as port_sharded_step,
                                              make_mesh, shard_state)
from openkeonspark_tpu_torch.parallel.sharded import data_partition
from openkeonspark_tpu_torch.sampling import DeviceSampler, SampledBatch
from openkeonspark_tpu_torch.train.loop import group_generator
from openkeonspark_tpu_torch.train.optim import make_optimizer
from openkeonspark_tpu_torch.train.step import (TrainState, build_batch_step,
                                                build_train_step, init_state)

import torch_dist_worker as W
from torch_parity import assert_tables_match, jax_row_draws

KG = dict(n_ent=100, n_rel=6, n_triples=1000, n_valid=30, n_test=30, seed=2)
BATCH, STEPS, PAD = 64, 3, 4
CPU = torch.device("cpu")
FIELDS = ("h", "t", "r", "neg_h", "neg_t", "neg_rel")
# (grid, optimizer, model)
CASES = [((1, 2), "sgd", "transe"), ((2, 1), "sgd", "transe"),
         ((2, 2), "sgd", "transe"), ((2, 2), "adam", "transe"),
         ((2, 2), "sgd", "transr")]


def cfg_kw(opt, model):
    kw = dict(model=model, alpha=0.05, negative_ent=2, negative_rel=1,
              opt_method=opt)
    if model == "transr":
        kw.update(ent_size=16, rel_size=8)
    else:
        kw.update(hidden_size=16)
    return kw


def jax_run(grid, opt, model_name, tmp):
    """The JAX sharded step's losses, tables and Adam moments; the port's
    single-device step on the union batches; and the task that runs the
    port's grid on the same tables and batches."""
    kw = cfg_kw(opt, model_name)
    cfg = JConfig(**kw)
    ds = jax_random_kg(**KG)
    model = jax_model(model_name)
    sampler = JSampler.build(ds, jax_index(ds, for_eval=False))
    state = jax_init(model, cfg, ds.n_ent, ds.n_rel, jax.random.key(0),
                     pad_to_multiple=PAD)
    mesh = jax_mesh(grid)
    ss = jax_shard_sampler(sampler, mesh)
    step = jax.jit(build_sharded_train_step(model, cfg, ss, BATCH, mesh))
    draws = jax_row_draws(sampler, cfg, grid[0], ds.n_train,
                          BATCH // grid[0])
    st = jax_shard_state(state, mesh)
    batches, unions, losses = {}, [], []
    for i in range(STEPS):
        key = jax.random.key(i)
        rows = draws(key)
        for d, b in enumerate(rows):
            batches.update({f"s{i}_d{d}_{f}": v for f, v in b.items()})
        unions.append({f: np.concatenate([b[f] for b in rows])
                       for f in rows[0]})
        st, loss = step(st, ss, key)
        losses.append(float(loss))
    specs = model.tables(cfg, ds.n_ent, ds.n_rel)
    name = f"{model_name}_{opt}_{grid[0]}x{grid[1]}"
    init = {k: np.asarray(v) for k, v in state.params.items()}
    np.savez(tmp / f"{name}_params.npz", **init)
    np.savez(tmp / f"{name}_batches.npz", **batches)
    jax_out = {"loss": np.asarray(losses),
               "params": jax_strip(st.params, specs),
               "m": (jax_strip(st.opt_state["m"], specs) if opt == "adam"
                     else None)}
    task = {"kind": "steps", "name": name, "grid": list(grid), "cfg": kw,
            "kg": KG, "params": str(tmp / f"{name}_params.npz"),
            "batches": str(tmp / f"{name}_batches.npz"), "step": "psum",
            "steps": STEPS, "batch": BATCH}
    return jax_out, single_on_unions(kw, init, unions), task


def single_on_unions(kw, init, unions):
    """The port's single-device step on each step's union batch."""
    cfg = Config(**kw)
    ds = random_kg(**KG)
    model = get_model(cfg.model)
    params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    state = TrainState(params, make_optimizer(cfg).init(params), 0)
    step = build_batch_step(model, cfg)
    losses = []
    for u in unions:
        state, loss = step(state, SampledBatch(**{
            f: torch.from_numpy(u[f]).long() if f in u else None
            for f in FIELDS}))
        losses.append(float(loss))
    specs = model.tables(cfg, ds.n_ent, ds.n_rel)
    return {"loss": np.asarray(losses),
            "params": strip_padding(state.params, specs),
            "m": (strip_padding(state.opt_state["m"], specs)
                  if "m" in state.opt_state else None)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("psum")
    want, tasks = {}, {2: [], 4: []}
    for grid, opt, model in CASES:
        jax_out, single, task = jax_run(grid, opt, model, tmp)
        want[(grid, opt, model)] = (jax_out, single, task["name"])
        tasks[grid[0] * grid[1]].append(task)
    got = W.launch(tmp, tasks)
    return {case: (j, s, got[name]) for case, (j, s, name) in want.items()}


def case_id(c):
    return f"{c[2]}-{c[1]}-{c[0][0]}x{c[0][1]}"


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_psum_step_matches_single_device_on_union(runs, case):
    _, single, got = runs[case]
    np.testing.assert_allclose(got["loss"], single["loss"], rtol=1e-6)
    assert_tables_match(single["params"], got, single["m"], msg=str(case))


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_psum_step_matches_jax(runs, case):
    jax_out, _, got = runs[case]
    np.testing.assert_allclose(got["loss"], jax_out["loss"], rtol=1e-6)
    assert_tables_match(jax_out["params"], got, jax_out["m"], msg=str(case))


# (grid, step, model) of the host-sampler grid runs
HOST_CASES = [((1, 2), "psum", "transe"), ((2, 1), "psum", "transe"),
              ((1, 2), "exchange", "transe"), ((2, 1), "exchange", "transe"),
              ((1, 2), "exchange", "transr")]


def host_cfg_kw(model):
    """One epoch of a stacked group of 2 host batches of 64 (a multiple of
    every grid here) and a group of 1: the STEPS of the psum and exchange
    tests, whose exchange step equals psum to rtol 1e-6 / atol 1e-7 up to
    the order of its sums; the fp32 wire."""
    return dict(cfg_kw("sgd", model), sampler="host", batch_size=BATCH,
                nbatches=STEPS, steps_per_scan=2, train_times=1,
                exchange_wire_dtype="float32")


@pytest.fixture(scope="module")
def host_runs(tmp_path_factory):
    """The port's single-device host-sampler run of each model, and each
    case's grid run, all from the same padded tables."""
    from openkeonspark_tpu_torch.train.loop import train
    tmp = tmp_path_factory.mktemp("host_grid")
    ds = random_kg(**KG)
    single, tasks = {}, []
    for model_name in sorted({c[2] for c in HOST_CASES}):
        kw = host_cfg_kw(model_name)
        cfg = Config(**kw)
        model = get_model(model_name)
        st = init_state(model, cfg, ds.n_ent, ds.n_rel,
                        torch.Generator().manual_seed(1), CPU,
                        pad_to_multiple=PAD)
        path = tmp / f"{model_name}_params.npz"
        np.savez(path, **{k: v.numpy() for k, v in st.params.items()})
        res = train(cfg, ds, CPU, state=st, echo=lambda _: None)
        specs = model.tables(cfg, ds.n_ent, ds.n_rel)
        single[model_name] = (np.asarray([e.loss for e in res.history]),
                              strip_padding(res.state.params, specs))
        tasks += [{"kind": "host_train", "name": host_id(c), "grid": list(
            c[0]), "step": c[1], "cfg": kw, "kg": KG, "params": str(path)}
            for c in HOST_CASES if c[2] == model_name]
    got = W.launch(tmp, {2: tasks})
    return {c: (single[c[2]], got[host_id(c)]) for c in HOST_CASES}


def host_id(c):
    return f"host-{c[2]}-{c[1]}-{c[0][0]}x{c[0][1]}"


@pytest.mark.parametrize("case", HOST_CASES, ids=host_id)
def test_host_sampler_grid_matches_single_device_host_run(host_runs, case):
    """``train`` with the host sampler on a grid: every rank samples the
    global batch and its data row's psum or exchange step takes its slice,
    which together is the single-device host step on the whole batch (the
    JAX package's host path runs the whole batch through one step)."""
    (want_loss, want), got = host_runs[case]
    np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-6)
    assert_tables_match(want, got, msg=str(case))


@pytest.mark.parametrize("model_name", ["transe", "transr", "complex"])
def test_one_cell_grid_is_the_single_device_step(model_name):
    """A (1, 1) grid draws the single-device bits and runs its arithmetic:
    every table bit for bit after three steps (the JAX step's
    ``:95-97`` contract). The grid scores its slots on the generic step,
    which single-device TransR takes with ``grouped_transr=False`` (with
    relation negatives and fp32 tables it takes the grouped route)."""
    kw = cfg_kw("adam", model_name)
    cfg = Config(**kw, grouped_transr=False)
    ds = random_kg(**KG)
    model = get_model(model_name)
    sampler = DeviceSampler.build(ds, build_kg_index(ds, for_eval=False),
                                  CPU)
    grid = make_mesh((1, 1), CPU)
    assert grid.size == 1 and grid.backend is None
    fresh = lambda: init_state(model, cfg, ds.n_ent, ds.n_rel,  # noqa: E731
                               torch.Generator().manual_seed(0), CPU)
    single = build_train_step(model, cfg, BATCH)
    sharded = port_sharded_step(model, cfg, grid, BATCH, ds.n_train)
    assert sharded.bits_shape == single.bits_shape
    a, b = fresh(), shard_state(fresh(), grid)
    for i in range(STEPS):
        bits = sampler.draw_bits(single.bits_shape,
                                 group_generator(cfg, i, CPU))
        a, la = single(a, sampler, bits)
        b, lb = sharded(b, sampler, bits)
        assert torch.equal(la, lb)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        assert torch.equal(a.opt_state["m"][k], b.opt_state["m"][k]), k


def test_partitioned_sample_matches_jax():
    """``partition=(start, size)`` restricts the positives to the slice and
    draws what the JAX sampler draws from the same bits."""
    ds = jax_random_kg(**KG)
    jsampler = JSampler.build(ds, jax_index(ds, for_eval=False))
    tsampler = DeviceSampler.build(random_kg(**KG), build_kg_index(
        random_kg(**KG), for_eval=False), CPU)
    bits = np.random.default_rng(0).integers(0, 1 << 32, (500, 4),
                                             dtype=np.uint64)
    want = jsampler.sample(None, 500, 1, 1, True,
                           partition=(jnp.int32(300), jnp.int32(50)),
                           bits=jnp.asarray(bits.astype(np.uint32)))
    got = tsampler.sample(500, 1, 1, True, partition=(300, 50),
                          bits=torch.from_numpy(bits.astype(np.int64)))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    pos = set(zip(got.h.tolist(), got.t.tolist(), got.r.tolist()))
    assert pos <= {tuple(x) for x in ds.train[300:350][:, [0, 1, 2]].tolist()}


def test_data_rows_draw_distinct_bits():
    """Data rows fold their index into the group seed; one data row draws
    the single-device bits."""
    cfg = Config()
    draw = lambda *a: torch.randint(  # noqa: E731
        0, 1 << 32, (8,), generator=group_generator(cfg, 5, CPU, *a),
        dtype=torch.int64)
    assert torch.equal(draw(0, 1), draw())
    assert not torch.equal(draw(0, 2), draw(1, 2))
    assert not torch.equal(draw(0, 2), draw())
    assert torch.equal(draw(1, 2), draw(1, 2))
    assert data_partition(1000, Grid(3, 2, 5, CPU)) == (666, 334)
    assert data_partition(1000, Grid(3, 2, 1, CPU)) == (0, 333)
