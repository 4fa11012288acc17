"""The port's owner-directed exchange step (``parallel/exchange.py``) on
gloo process grids: with the fp32 wire it equals the port's psum step on
the same draws (rtol 1e-6 / atol 1e-7, ``tests/test_exchange.py:127-143``)
for SGD and Adam, on the routed path (entities past
``SMALL_TABLE_ROWS``) and the small-table path (every optimizer), for
TransR and ComplEx, in every dedup mode, through both exact overflow
fallbacks at a tiny ``exchange_slack``, and whatever the microbatches; the
bf16 wire stays within ``tests/test_exchange.py:202-231``'s bounds; an fp8
payload crosses gloo bit for bit. The step is also held to the JAX
package's exchange step on the JAX draws and tables, with the fp32 and
the bf16 wire, at the same rtol 1e-6 / atol 1e-7. The ranks run in
``tests/torch_dist_worker.py``, which imports no jax."""

import jax
import numpy as np
import pytest
import torch

from openkeonspark_tpu.config import Config as JConfig
from openkeonspark_tpu.data.index import build_kg_index as jax_index
from openkeonspark_tpu.data.synth import random_kg as jax_random_kg
from openkeonspark_tpu.models import get_model as jax_model
from openkeonspark_tpu.models import strip_padding as jax_strip
from openkeonspark_tpu.parallel import (build_exchange_train_step,
                                        make_mesh as jax_mesh,
                                        shard_sampler as jax_shard_sampler,
                                        shard_state as jax_shard_state)
from openkeonspark_tpu.sampling.device import DeviceSampler as JSampler
from openkeonspark_tpu.train.step import init_state as jax_init
from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.data import random_kg
from openkeonspark_tpu_torch.models import get_model
from openkeonspark_tpu_torch.parallel.exchange import (capacity_for,
                                                       dedup_ids,
                                                       expected_unique)
from openkeonspark_tpu_torch.train.step import init_state

import torch_dist_worker as W
from torch_parity import assert_tables_match, jax_row_draws

# entities past SMALL_TABLE_ROWS take the routed path; relations the
# small-table path
KG_BIG = dict(n_ent=2000, n_rel=6, n_triples=4000, n_valid=30, n_test=30,
              seed=3)
# every table small: the dense all_gather + all_reduce path
KG_SMALL = dict(n_ent=100, n_rel=6, n_triples=1000, n_valid=30, n_test=30,
                seed=2)
LR, STEPS, PAD = 0.05, 3, 8


def cfg_kw(model="transe", opt="sgd", **kw):
    out = dict(model=model, alpha=LR, negative_ent=2, negative_rel=1,
               opt_method=opt, exchange_wire_dtype="float32")
    out.update(ent_size=16, rel_size=8) if model == "transr" \
        else out.update(hidden_size=16)
    out.update(kw)
    return out


# name -> (grid, cfg, kg, batch, steps); each runs the psum step
# ("<name>/psum") and the exchange step ("<name>/exchange") from one state
PAIRS = {
    "sgd-1x2": ((1, 2), cfg_kw(), KG_BIG, 64, STEPS),
    "sgd-2x1": ((2, 1), cfg_kw(), KG_BIG, 64, STEPS),
    "sgd-2x2": ((2, 2), cfg_kw(), KG_BIG, 64, STEPS),
    # Adam one step: a cancelled cell's sign compounds over steps
    "adam-2x2": ((2, 2), cfg_kw(opt="adam"), KG_BIG, 64, 1),
    "small-sgd": ((2, 2), cfg_kw(), KG_SMALL, 64, STEPS),
    "small-adam": ((2, 2), cfg_kw(opt="adam"), KG_SMALL, 64, 1),
    "small-adagrad": ((2, 2), cfg_kw(opt="adagrad"), KG_SMALL, 64, 1),
    "small-adadelta": ((2, 2), cfg_kw(opt="adadelta"), KG_SMALL, 64, 1),
    "transr": ((2, 2), cfg_kw("transr"), KG_BIG, 64, STEPS),
    "complex": ((2, 2), cfg_kw("complex"), KG_BIG, 64, STEPS),
    "dedup-off": ((2, 2), cfg_kw(exchange_dedup="off"), KG_BIG, 64, STEPS),
    "dedup-both": ((2, 2), cfg_kw(exchange_dedup="both"), KG_BIG, 64,
                   STEPS),
    "overflow": ((2, 2), cfg_kw(opt="adam", exchange_slack=0.01), KG_BIG,
                 512, 1),
}
# exchange-only runs: name -> (grid, cfg, kg, batch, steps)
SINGLES = {
    "mb1": ((1, 2), cfg_kw(exchange_microbatches=1), KG_BIG, 64, STEPS),
    "mb4": ((1, 2), cfg_kw(exchange_microbatches=4), KG_BIG, 64, STEPS),
}


def _params(tmp, kw, kg):
    """The padded initial tables of a configuration, as an npz path."""
    cfg = Config(**kw)
    ds = random_kg(**kg)
    st = init_state(get_model(cfg.model), cfg, ds.n_ent, ds.n_rel,
                    torch.Generator().manual_seed(0), torch.device("cpu"),
                    pad_to_multiple=PAD)
    path = tmp / f"init_{abs(hash((str(sorted(kw.items())), str(kg))))}.npz"
    np.savez(path, **{k: v.numpy() for k, v in st.params.items()})
    return str(path)


def _task(tmp, name, step, grid, kw, kg, batch, steps, batches=None):
    return {"kind": "steps", "name": name, "grid": list(grid), "cfg": kw,
            "kg": kg, "params": _params(tmp, kw, kg), "step": step,
            "batch": batch, "steps": steps, "batches": batches}


WIRES = {"f32": "float32", "bf16": "bfloat16", "fp8": "float8_e4m3fn"}


def jax_exchange(tmp):
    """The JAX package's exchange step on (2, 2) with the fp32 and bf16
    wires (``tests/test_exchange.py``'s draws: keys 0, 1, 2, batch 64),
    and the port tasks that run the same draws from the same tables with
    each wire."""
    grid = (2, 2)
    ds = jax_random_kg(**KG_BIG)
    model = jax_model("transe")
    sampler = JSampler.build(ds, jax_index(ds, for_eval=False))
    mesh = jax_mesh(grid)
    ss = jax_shard_sampler(sampler, mesh)
    want, tasks = {}, []
    for short, wire in WIRES.items():
        kw = cfg_kw(exchange_wire_dtype=wire)
        cfg = JConfig(**kw)
        for steps in (STEPS, 1) if short == "bf16" else (STEPS,):
            tasks.append({"kind": "steps", "grid": list(grid), "cfg": kw,
                          "name": f"jax-{short}-{steps}/exchange",
                          "kg": KG_BIG, "params": str(tmp / "jax_init.npz"),
                          "step": "exchange", "batch": 64, "steps": steps,
                          "batches": str(tmp / "jax_batches.npz")})
        if short == "fp8":
            continue
        # the bf16 wire is held to the JAX step over one step: from then
        # on, float-reassociation noise in the fp32 tables can flip a bf16
        # rounding, and with it a hinge, in either package
        steps = 1 if short == "bf16" else STEPS
        state = jax_init(model, cfg, ds.n_ent, ds.n_rel, jax.random.key(0),
                         pad_to_multiple=PAD)
        step = jax.jit(build_exchange_train_step(model, cfg, ss, 64, mesh))
        draws = jax_row_draws(sampler, cfg, grid[0], ds.n_train,
                              64 // grid[0])
        st = jax_shard_state(state, mesh, flat=True)
        batches, losses = {}, []
        for i in range(steps):
            key = jax.random.key(i)
            for d, b in enumerate(draws(key)):
                batches.update({f"s{i}_d{d}_{f}": v for f, v in b.items()})
            st, loss = step(st, ss, key)
            losses.append(float(loss))
        if short == "f32":
            np.savez(tmp / "jax_init.npz",
                     **{k: np.asarray(v) for k, v in state.params.items()})
            np.savez(tmp / "jax_batches.npz", **batches)
        want[short] = {"loss": np.asarray(losses), "params": jax_strip(
            st.params, model.tables(cfg, ds.n_ent, ds.n_rel))}
    return want, tasks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("exchange")
    worlds = {2: [], 4: []}
    for name, (grid, kw, kg, batch, steps) in PAIRS.items():
        for step in ("psum", "exchange"):
            worlds[grid[0] * grid[1]].append(_task(
                tmp, f"{name}/{step}", step, grid, kw, kg, batch, steps))
    for name, (grid, kw, kg, batch, steps) in SINGLES.items():
        worlds[grid[0] * grid[1]].append(_task(
            tmp, f"{name}/exchange", "exchange", grid, kw, kg, batch, steps))
    for dtype in ("float8_e4m3fn", "bfloat16"):
        worlds[4].append({"kind": "a2a", "name": f"a2a-{dtype}",
                          "grid": [2, 2], "dtype": dtype})
    jax_out, tasks = jax_exchange(tmp)
    worlds[4] += tasks
    for ts in worlds.values():
        for t in ts:
            t["name"] = t["name"].replace("/", "__")
    got = W.launch(tmp, worlds)
    got = {k.replace("__", "/"): v for k, v in got.items()}
    got["jax"] = jax_out
    return got


def _tables(out):
    return {k[2:]: v for k, v in out.items() if k.startswith("p_")}


def _noise_proxy(out, opt):
    """A proxy ∝ each cell's aggregated |G|, for the cancelled-gradient
    exemption of the sign-scaled optimizers (``tests/test_exchange.py``'s
    ``run_pair``): Adam's m = 0.1·G; Adagrad's and Adadelta's 0.1·|G|
    from their accumulators; None for SGD."""
    slot = {"adam": "m", "adagrad": "accum", "adadelta": "accum"}.get(opt)
    if slot is None:
        return None
    acc = {k[len(slot) + 3:]: v for k, v in out.items()
           if k.startswith(f"s_{slot}_")}
    if opt == "adagrad":
        return {k: 0.1 * np.sqrt(np.maximum(v - 1e-20, 0.0))
                for k, v in acc.items()}
    if opt == "adadelta":
        return {k: 0.1 * np.sqrt(v / 0.05) for k, v in acc.items()}
    return acc


@pytest.mark.parametrize("name", list(PAIRS))
def test_exchange_matches_psum(runs, name):
    """Same draws: gathered rows and per-row gradients are exact; only the
    order in which duplicate ids are summed differs."""
    a, b = runs[f"{name}/psum"], runs[f"{name}/exchange"]
    np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-6)
    assert_tables_match(_tables(a), b,
                        _noise_proxy(a, PAIRS[name][1]["opt_method"]),
                        msg=name)


def test_overflow_fallbacks_ran(runs):
    """At slack 0.01 both exact fallbacks run, and the result above still
    equals the psum step's."""
    gather, update = runs["overflow/exchange"]["fallbacks"]
    assert gather > 0 and update > 0


def test_microbatch_invariance(runs):
    """Every microbatch takes its gradients at the same tables: one and
    four microbatches give the same tables."""
    assert_tables_match(_tables(runs["mb1/exchange"]), runs["mb4/exchange"],
                        msg="mb")


def test_bf16_wire_close_to_f32(runs):
    """The bf16 wire quantizes rows and gradients in transit; after three
    SGD steps the tables track the f32-wire run to bf16 resolution, with a
    few hinge-toggled rows allowed: ``tests/test_exchange.py:202-231``'s
    bounds, on that test's draws and tables."""
    pf = _tables(runs[f"jax-f32-{STEPS}/exchange"])
    out = runs[f"jax-bf16-{STEPS}/exchange"]
    assert np.isfinite(out["loss"]).all()
    for k, f in pf.items():
        diff = np.abs(f - out[f"p_{k}"])
        rows, dim = f.shape[0], f.size // f.shape[0]
        row_cap = max(2, int(0.01 * rows))
        tol = 0.02 * np.abs(f) + 0.01
        assert float(np.mean(diff > tol)) <= row_cap * dim / diff.size \
            + 0.01, k
        assert float(diff.max()) <= 2.0 * STEPS * LR, k
        rms = float(np.sqrt(np.mean(diff ** 2)))
        scale = float(np.sqrt(np.mean(f ** 2)))
        assert rms < 0.02 * scale + LR * np.sqrt(row_cap * dim / diff.size)


def test_fp8_wire_trains(runs):
    """The fp8 wire runs end to end: finite losses, within 6% of the f32
    wire's (``tests/test_exchange.py``'s fp8 bound on the loss curve)."""
    q = runs[f"jax-fp8-{STEPS}/exchange"]["loss"]
    f = runs[f"jax-f32-{STEPS}/exchange"]["loss"]
    assert np.isfinite(q).all()
    np.testing.assert_allclose(q, f, rtol=0.06)


@pytest.mark.parametrize("dtype", ["float8_e4m3fn", "bfloat16"])
def test_payload_crosses_gloo_bit_for_bit(runs, dtype):
    """An fp8 (bf16) payload crosses gloo as raw bytes: rank 0 receives
    block 0 of every rank's payload unchanged."""
    out = runs[f"a2a-{dtype}"]
    n = 4
    blocks = []
    for rank in range(n):
        g = torch.Generator().manual_seed(rank)
        x = (torch.randn(n * 4, 3, generator=g) * 4).to(
            getattr(torch, dtype))
        blocks.append(x[:4].view(torch.uint8).numpy())
    np.testing.assert_array_equal(out["got"], np.concatenate(blocks))


@pytest.mark.parametrize("wire,steps", [("f32", STEPS), ("bf16", 1)])
def test_exchange_matches_jax(runs, wire, steps):
    """The port's exchange step on the JAX draws and tables against the
    JAX package's exchange step, with the same wire: the port quantizes
    where the JAX step does."""
    want, got = runs["jax"][wire], runs[f"jax-{wire}-{steps}/exchange"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    assert_tables_match(want["params"], got, msg=wire)


def test_dedup_and_capacity_helpers():
    """``dedup_ids`` compacts the distinct ids first and maps every id to
    its slot; the capacity rules are the JAX package's."""
    ids = torch.tensor([5, 3, 5, 9, 3, 3])
    uniq, u_idx = dedup_ids(ids, sentinel=99)
    assert uniq.tolist() == [3, 5, 9, 99, 99, 99]
    assert torch.equal(uniq[u_idx], ids)
    from openkeonspark_tpu.parallel import exchange as jx
    for args in ((100, 4, 1.5), (1000, 8, 0.01), (64, 2, 1.5, 50.0, 20)):
        assert capacity_for(*args) == jx.capacity_for(*args)
    assert expected_unique(300, 1000) == jx.expected_unique(300, 1000)
