"""The port's collective-byte accounting (``parallel/comm.py``) against the
JAX package's (``openkeonspark_tpu/parallel/comm.py``):

- ``wire_bytes_estimate``, the cross-host share and ``predict_scaling``
  equal the JAX functions on the same inputs (``predict_scaling`` given
  the JAX link constants, within 1e-12 relative);
- the counter's dict of one step on gloo ranks equals the JAX
  ``collective_bytes`` of the JAX step at the same configuration, seed and
  geometry, every kind and ``wire``, ``wire_ici`` and ``wire_dcn``
  exactly: the exchange step on (2, 2) and (1, 2) at one and two
  microbatches, the psum step on (2, 1) and (2, 2), the hierarchical step
  on (2, 2, 2) with 4 chips a host, with and without hot rows and
  ``'stats'`` capacities. Three differences are itemised, each computed
  and required to the byte: JAX counts the payload of an op over
  one-device groups (an axis of size 1), which moves no byte, where the
  port issues no collective over a one-rank axis (``mesh.py``; the test
  finds those ops in the JAX program); and the JAX psum step reduces
  every slot's rows over 'model' where the port's gathers each distinct
  id stream once (:func:`psum_gather_saving`); at the bf16 wire the
  port's hierarchical step reduces its dense gradients in fp32
  (:func:`hier_dense_extra`). The exact fallbacks' bytes are kept apart by
  both (JAX skips ``lax.cond`` branches);
- the JAX package's two comm-volume claims hold on the port's counter:
  the exchange step's payload at least 3× below the psum step's on (2,
  4), (1, 8) and (4, 2) (``tests/test_exchange.py:296-330``), and
  weak-scaling wire bytes within 1.3× across (1, 2), (2, 2) and (2, 4)
  after the (N − 1)/N normalisation (``:332-355``);
- the counter itself: every rank gets the same dict, fallbacks are kept
  apart, size-1 axes record nothing, and nothing records with no counter
  on.

The ranks run ``torch_dist_worker.py`` (no jax in them)."""

import jax
import numpy as np
import pytest
import torch

from openkeonspark_tpu.config import Config as JConfig
from openkeonspark_tpu.data.index import build_kg_index as jax_index
from openkeonspark_tpu.data.synth import random_kg as jax_random_kg
from openkeonspark_tpu.models import get_model as jax_model
from openkeonspark_tpu.parallel import comm as jcomm
from openkeonspark_tpu.parallel import (build_exchange_train_step as
                                        jax_exchange_step,
                                        build_hier_train_step as
                                        jax_hier_step,
                                        build_sharded_train_step as
                                        jax_psum_step,
                                        make_mesh as jax_mesh,
                                        shard_sampler as jax_shard_sampler,
                                        shard_state as jax_shard_state)
from openkeonspark_tpu.sampling.device import DeviceSampler as JSampler
from openkeonspark_tpu.train.step import init_state as jax_init
from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.models import get_model
from openkeonspark_tpu_torch.models.base import padded_rows
from openkeonspark_tpu_torch.parallel import comm
from openkeonspark_tpu_torch.parallel.hot import entity_table_names, hot_k
from openkeonspark_tpu_torch.parallel import mesh as port_mesh
from openkeonspark_tpu_torch.parallel.mesh import (Grid, all_gather,
                                                   all_reduce, all_to_all,
                                                   fallback)
from openkeonspark_tpu_torch.train.optim import SMALL_TABLE_ROWS

import torch_dist_worker as W
from test_torch_exchange import KG_BIG, _params, cfg_kw

CPU = torch.device("cpu")
KEYS = ("wire", "wire_ici", "wire_dcn")
HOT = dict(exchange_hot_rows=64, exchange_capacity="stats")

# name -> (step, grid, cfg, chips_per_host): the geometries held to JAX,
# one step at batch 64 on KG_BIG
VS_JAX = {
    "exchange-2x2-mb1": ("exchange", (2, 2),
                         cfg_kw(exchange_microbatches=1), 2),
    "exchange-2x2-mb2": ("exchange", (2, 2),
                         cfg_kw(exchange_microbatches=2), 2),
    "exchange-1x2-mb1": ("exchange", (1, 2),
                         cfg_kw(exchange_microbatches=1), 2),
    "exchange-1x2-mb2": ("exchange", (1, 2),
                         cfg_kw(exchange_microbatches=2), 2),
    "psum-2x1": ("psum", (2, 1), cfg_kw(), 2),
    "psum-2x2": ("psum", (2, 2), cfg_kw(), 2),
    "hier-2x2x2": ("hier", (2, 2, 2), cfg_kw(), 4),
    "hier-2x2x2-hot": ("hier", (2, 2, 2), cfg_kw(**HOT), 4),
    "hier-2x2x2-hot-bf16": ("hier", (2, 2, 2), cfg_kw(
        exchange_wire_dtype="bfloat16", **HOT), 4),
}
BATCH = 64
# the JAX comm-volume claims (tests/test_exchange.py:296-355, on its
# kg_big, which is KG_BIG): hidden 64, two entity negatives, one
# microbatch
CLAIM_KW = dict(model="transe", hidden_size=64, alpha=0.05, negative_ent=2,
                negative_rel=1, exchange_microbatches=1,
                exchange_wire_dtype="float32")
WEAK_KW = dict(model="transe", hidden_size=64, negative_ent=2,
               exchange_microbatches=1)
CLAIM_GRIDS = ((2, 4), (1, 8), (4, 2))
WEAK_GRIDS = ((1, 2), (2, 2), (2, 4))


def _one_rank(line: str) -> bool:
    """Whether an HLO line is a collective over one-device groups."""
    if not jcomm._OP_RE.search(line) or "-done(" in line:
        return False
    groups = jcomm._parse_groups(line)
    return groups is not None and all(len(g) == 1 for g in groups)


def jax_bytes(step, args, cph):
    """The JAX ``collective_bytes`` of ``step`` and, per kind, the payload
    it counts of ops over one-device groups."""
    full = jcomm.collective_bytes(step, *args, chips_per_host=cph)
    text = step.lower(*args).compiler_ir(dialect="hlo").as_hlo_text()
    multi = jcomm.hlo_collective_bytes(
        "\n".join(ln for ln in text.splitlines() if not _one_rank(ln)),
        chips_per_host=cph)
    return full, {k: full[k] - multi[k] for k in jcomm._KINDS}


def jax_runs():
    ds = jax_random_kg(**KG_BIG)
    sampler = JSampler.build(ds, jax_index(ds, for_eval=False))
    out = {}
    for name, (kind, grid, kw, cph) in VS_JAX.items():
        cfg = JConfig(**kw)
        model = jax_model(cfg.model)
        mesh = jax_mesh(grid)
        ss = jax_shard_sampler(sampler, mesh)
        build = {"exchange": jax_exchange_step, "psum": jax_psum_step,
                 "hier": jax_hier_step}[kind]
        step = jax.jit(build(model, cfg, ss, BATCH, mesh))
        state = jax_init(model, cfg, ds.n_ent, ds.n_rel, jax.random.key(0),
                         pad_to_multiple=8)
        st = jax_shard_state(state, mesh, flat=kind != "psum")
        out[name] = jax_bytes(step, (st, ss, jax.random.key(0)), cph)
    return out


def _task(tmp, name, step, grid, kw, kg, batch, cph):
    return {"kind": "steps", "name": name, "grid": list(grid), "cfg": kw,
            "kg": kg, "params": _params(tmp, kw, kg), "step": step,
            "batch": batch, "steps": 1, "count_bytes": cph}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("comm")
    worlds = {2: [], 4: [], 8: []}
    for name, (kind, grid, kw, cph) in VS_JAX.items():
        worlds[int(np.prod(grid))].append(
            _task(tmp, name, kind, grid, kw, KG_BIG, BATCH, cph))
    for grid in CLAIM_GRIDS:
        n = int(np.prod(grid))
        for kind in ("psum", "exchange"):
            worlds[n].append(_task(tmp, f"claim-{kind}-{grid[0]}x{grid[1]}",
                                   kind, grid, CLAIM_KW, KG_BIG, 256, n))
    for grid in WEAK_GRIDS:
        n = int(np.prod(grid))
        worlds[n].append(_task(tmp, f"weak-{grid[0]}x{grid[1]}", "exchange",
                               grid, WEAK_KW, KG_BIG, 64 * n, n))
    got = W.launch(tmp, worlds)
    got["jax"] = jax_runs()
    return got


def port_dict(run):
    return {k[len("comm_"):]: int(v) for k, v in run.items()
            if k.startswith("comm_")}


def psum_gather_saving(kw, grid, cph):
    """Bytes by which the JAX psum step's slot all_reduce over 'model'
    exceeds the port's: JAX reduces every slot's rows for every negative
    segment ((1 + nE + nR)·B a slot, ``sharded.py:115-123``); the port
    gathers each distinct id stream once (``train/step.py::
    gather_slots_structured``: 1 + nE rows of B for an entity slot, 1 +
    nR for a relation slot). Per key of the dict; none on a one-rank
    'model' axis, where neither issues the op."""
    d_rows, m = grid
    if m == 1:
        return {}
    cfg = JConfig(**kw)
    b = BATCH // d_rows
    n_e, n_r = cfg.negative_ent, cfg.negative_rel
    rows = sum((1 + n_e + n_r) - ((1 + n_r) if anchor == "r" else
                                  (1 + n_e))
               for _, _, anchor in jax_model(cfg.model).gathers())
    payload = rows * b * cfg.hidden_size * 4
    wire = 2 * (m - 1) / m * payload
    groups = [[r * m + c for c in range(m)] for r in range(d_rows)]
    dcn = min(wire, jcomm._dcn_share("all-reduce", payload, groups, cph))
    return {"all-reduce": payload, "total": payload, "wire": wire,
            "wire_dcn": dcn, "wire_ici": wire - dcn}


def hier_dense_extra(kw, grid, n_ent, n_rel, cph):
    """Bytes by which the port's hierarchical step exceeds the JAX step's
    at a wire dtype narrower than fp32: the JAX step ``psum``s its dense
    gradients (the small tables', the hot rows') in the wire dtype
    (``hier.py:459``); the port's ``wire_sum`` rounds each to the wire
    dtype once and reduces it in fp32 (``parallel/hier.py``), so its
    all_reduce carries 4 bytes a value where JAX's carries the wire
    dtype's. Per key of the dict; none at the fp32 wire."""
    cfg = Config(**kw)
    wire_b = torch.empty((), dtype=getattr(
        torch, cfg.exchange_wire_dtype)).element_size()
    if len(grid) != 3 or wire_b == 4:
        return {}
    n = int(np.prod(grid))
    model = get_model(cfg.model)
    specs = model.tables(cfg, n_ent, n_rel)
    values = 0
    for t in sorted({tb for _, tb, _ in model.gathers()}):
        rows = padded_rows(specs[t].rows, n)
        if rows <= SMALL_TABLE_ROWS:
            values += rows * (specs[t].dim + 1)
        elif cfg.exchange_hot_rows and t in entity_table_names(model):
            values += hot_k(cfg, n_ent) * (specs[t].dim + 1)
    extra = values * (4 - wire_b)
    got = comm.bytes_of([("all-reduce", extra, (tuple(range(n)),), False)],
                        cph)
    return {k: v for k, v in got.items() if k != "fallback"}


@pytest.mark.parametrize("name", list(VS_JAX))
def test_counter_matches_jax(runs, name):
    """Every kind and the wire split equal the JAX count but for the
    itemised differences: the JAX count's payload over one-device groups,
    the psum step's slot rows the port does not reduce, and the fp32 of
    the hierarchical step's dense gradients at the bf16 wire."""
    kind, grid, kw, cph = VS_JAX[name]
    port = port_dict(runs[name])
    want, one_rank = runs["jax"][name]
    saving = psum_gather_saving(kw, grid, cph) if kind == "psum" else {}
    extra = hier_dense_extra(kw, grid, KG_BIG["n_ent"], KG_BIG["n_rel"], cph)
    for k in jcomm._KINDS:
        assert port[k] + one_rank[k] + saving.get(k, 0) - extra.get(k, 0) \
            == want[k], (
            f"{name} {k}: port {port[k]} B, JAX {want[k]} B; itemised: "
            f"{one_rank[k]} B JAX counts over one-device groups (the port "
            f"issues no collective over a one-rank axis), "
            f"{saving.get(k, 0)} B of slot rows the port's psum step "
            f"gathers once, {extra.get(k, 0)} B the port's hierarchical "
            "step's dense gradients carry in fp32")
    assert port["total"] + sum(one_rank.values()) + saving.get(
        "total", 0) - extra.get("total", 0) == want["total"]
    for k in KEYS:
        assert port[k] == want[k] - saving.get(k, 0) + extra.get(k, 0), (
            name, k, port, want)
    assert port["chips_per_host"] == want["chips_per_host"]
    if kind == "hier" or grid == (2, 2):
        assert port["wire_dcn"] > 0 and port["wire_ici"] > 0
    if kind == "psum" and grid[1] > 1:
        assert saving["all-reduce"] > 0
    if name.endswith("-bf16"):
        assert extra["all-reduce"] > 0


@pytest.mark.parametrize("grid", CLAIM_GRIDS,
                         ids=[f"{d}x{m}" for d, m in CLAIM_GRIDS])
def test_exchange_comm_bytes_drop(runs, grid):
    """``tests/test_exchange.py:296-330`` on the port's counter: the
    exchange step's payload at least 3× below the psum step's, and it
    lowers to all_to_all."""
    tag = f"{grid[0]}x{grid[1]}"
    psum = port_dict(runs[f"claim-psum-{tag}"])
    exch = port_dict(runs[f"claim-exchange-{tag}"])
    heavy_psum = psum["all-reduce"] + psum["all-gather"]
    heavy_exch = exch["all-to-all"] + exch["all-gather"] + exch["all-reduce"]
    assert heavy_exch * 3.0 <= heavy_psum, (psum, exch)
    assert exch["all-to-all"] > 0


def test_exchange_wire_bytes_scale_free(runs):
    """``tests/test_exchange.py:332-355`` on the port's counter: at a fixed
    per-device batch the wire bytes, the (N − 1)/N locality factor
    normalised out, stay within 1.3× across (1, 2), (2, 2) and (2, 4)."""
    wires = {}
    for d, m in WEAK_GRIDS:
        n = d * m
        wires[(d, m)] = port_dict(runs[f"weak-{d}x{m}"])["wire"] * n / (n - 1)
    assert wires[(2, 4)] <= 1.3 * wires[(1, 2)], wires
    assert wires[(2, 2)] <= 1.3 * wires[(1, 2)], wires


# ---- the model, against the JAX functions --------------------------------

# tests/test_comm.py:73-120's payloads and groups, and more
PAYLOADS = [
    {"all-reduce": 64 * 4, "all-gather": 0, "all-to-all": 0},
    {"all-reduce": 1000, "all-gather": 2048, "all-to-all": 4096,
     "reduce-scatter": 512, "collective-permute": 256},
    {"all-reduce": 123456, "all-to-all": 7890},
]
GROUPS = [[list(range(16))], [[0, 1, 2, 3]], [[0, 1], [2, 3]],
          [[0, 4], [1, 5], [2, 6], [3, 7]], [[0, 2, 4, 6], [1, 3, 5, 7]],
          [[0], [1]], [list(range(8))]]


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("payload", PAYLOADS)
def test_wire_bytes_estimate_matches_jax(payload, n):
    assert comm.wire_bytes_estimate(payload, n) == \
        jcomm.wire_bytes_estimate(payload, n)
    with_wire = dict(payload, wire=777)
    assert comm.wire_bytes_estimate(with_wire, n) == 777


@pytest.mark.parametrize("kind", jcomm._KINDS)
@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("cph", [1, 2, 4])
def test_dcn_share_matches_jax(kind, groups, cph):
    tup = tuple(tuple(g) for g in groups)
    assert comm.dcn_share(kind, 16000, tup, cph) == \
        jcomm._dcn_share(kind, 16000, groups, cph)


def test_all_gather_dcn_share_is_hierarchical():
    """``tests/test_comm.py:111-120`` on the port's function."""
    d = comm.dcn_share("all-gather", 16000, (tuple(range(16)),), 4)
    assert abs(d - 16000 * (4 - 1) / 4 / 4) < 1e-6
    assert comm.dcn_share("all-gather", 16000, ((0, 1, 2, 3),), 4) == 0.0


def _split_payloads():
    """Payload dicts with the wire split, as both counters make them."""
    out = {}
    for shape, groups, cph in (((1, 1), [[0]], 4),
                               ((2, 2), [[0, 1, 2, 3]], 2),
                               ((2, 4), [list(range(8))], 4),
                               ((2, 2, 2), [[0, 4], [1, 5], [2, 6], [3, 7]],
                                4),
                               ((4, 2, 2), [list(range(16))], 4)):
        ev = [("all-to-all", 40000, tuple(map(tuple, groups)), False),
              ("all-reduce", 8000, tuple(map(tuple, groups)), False),
              ("all-gather", 4096, tuple(map(tuple, groups)), False)]
        out[shape] = comm.bytes_of(ev, cph)
    return out


@pytest.mark.parametrize("link_model", ["pipelined", "serial"])
@pytest.mark.parametrize("overlap", jcomm.OVERLAP_BRACKETS)
@pytest.mark.parametrize("bw", jcomm.BW_BRACKETS)
@pytest.mark.parametrize("split", [True, False], ids=["split", "legacy"])
def test_predict_scaling_matches_jax(split, bw, overlap, link_model):
    """Given the JAX link constants (and one NIC to a host's chips), the
    port's model is the JAX model, within 1e-12 relative."""
    payloads = _split_payloads() if split else {
        s: {k: v for k, v in p.items() if k not in ("wire_ici", "wire_dcn")}
        for s, p in _split_payloads().items()}
    for cph in (2, 4):
        want = jcomm.predict_scaling(0.24e-3, payloads, chips_per_host=cph,
                                     bw_scale=bw, overlap=overlap,
                                     link_model=link_model)
        got = comm.predict_scaling(0.24e-3, payloads, gpus_per_host=cph,
                                   bw_scale=bw, overlap=overlap,
                                   link_model=link_model,
                                   nvlink_bw=jcomm.ICI_BW,
                                   net_bw=jcomm.DCN_BW, gpus_per_nic=cph)
        assert got.keys() == want.keys()
        for shape in want:
            a, b = want[shape], got[shape]
            assert a.keys() == b.keys()
            for k in ("devices", "wire_bytes_per_device",
                      "wire_dcn_per_device"):
                assert a[k] == b[k], (shape, k)
            for k in ("comm_s", "predicted_step_s", "scaling_efficiency"):
                assert b[k] == pytest.approx(a[k], rel=1e-12, abs=0), (
                    shape, k)
            # the links are named for the card: ICI is NVLink, DCN the
            # network
            assert b["link"] == a["link"].replace("ICI", "NVLink").replace(
                "DCN", "network")


def test_h100_defaults_are_no_tpu_figure():
    """No TPU figure remains a default: the links are H100's, the optimistic
    bracket stays within their line rates, and nothing overlaps by
    default."""
    assert comm.NVLINK_BW * max(comm.BW_BRACKETS) <= comm.NVLINK_LINE_BW
    assert comm.NET_BW * max(comm.BW_BRACKETS) <= comm.NET_LINE_BW
    assert (comm.NVLINK_LINE_BW, comm.NET_LINE_BW) == (450e9, 50e9)
    assert comm.NVLINK_BW not in (jcomm.ICI_BW, jcomm.DCN_BW)
    assert comm.NET_BW not in (jcomm.ICI_BW, jcomm.DCN_BW)
    assert comm.GPUS_PER_HOST == 8 and comm.GPUS_PER_NIC == 1
    import inspect
    sig = inspect.signature(comm.predict_scaling).parameters
    assert sig["overlap"].default == 0.0
    assert sig["gpus_per_host"].default == 8


# ---- the counter on one process ------------------------------------------

def test_counter_records_kinds_payloads_and_fallbacks(monkeypatch):
    """The recorder's conventions: all_gather's payload is its output (n ×
    the input), all_reduce's and all_to_all's the tensor; a one-rank axis
    records nothing; a fallback's bytes stay apart; no counter, no
    record."""
    import torch.distributed as dist
    grid = Grid(2, 2, 1, CPU, backend="gloo", hosts=2)
    monkeypatch.setattr(dist, "all_reduce", lambda t, **kw: None)
    monkeypatch.setattr(dist, "all_to_all_single", lambda o, i, **kw: None)
    monkeypatch.setattr(dist, "all_gather", lambda parts, t, **kw: None)
    x = torch.zeros(8, 3)                     # 96 bytes
    with comm.CollectiveCounter(chips_per_host=2) as c:
        all_reduce(x, grid, "grid")
        all_gather(x, grid, "model")          # 2 × 96
        all_to_all(x, grid, "host")
        all_to_all(x, grid, "local")
        all_reduce(x, Grid(1, 1, 0, CPU), "grid")   # one rank: nothing
        with fallback():
            all_gather(x, grid, "grid")       # 4 × 96, apart
    assert port_mesh.recorder is None
    b = c.bytes
    assert (c.count, c.fallback_count) == (4, 1)
    assert (b["all-reduce"], b["all-gather"], b["all-to-all"]) == \
        (96, 192, 192)
    assert b["total"] == 480
    assert b["fallback"]["all-gather"] == 384
    assert b["fallback"]["total"] == 384
    # wire: all_reduce 2·(3/4)·96, all_gather (1/2)·192, a2a 2 × (1/2)·96
    assert b["wire"] == int(144 + 96 + 48 + 48)
    # across hosts (ranks 0-1 | 2-3): the grid all_reduce 2·96·(1/2)/2 a
    # device, the 'host' a2a half its block; 'model' and 'local' stay in
    assert b["wire_dcn"] == int(48 + 48)
    assert b["wire_ici"] == b["wire"] - b["wire_dcn"]
    all_reduce(x, grid, "grid")               # no counter on: no record
    assert len(c.events) == 5


def test_counters_nest():
    grid = Grid(1, 2, 0, CPU, backend="gloo")
    with comm.CollectiveCounter() as outer:
        with comm.CollectiveCounter() as inner:
            outer.record("all-reduce", 4, grid, "grid")
            assert port_mesh.recorder is inner
        assert port_mesh.recorder is outer
    assert port_mesh.recorder is None
    assert inner.count == 0 and outer.count == 1


def test_grid_members_are_make_mesh_groups():
    """``Grid.members`` lists every group of an axis, host-major."""
    g = Grid(4, 2, 0, CPU, hosts=2)           # (2, 2, 2)
    assert g.members("model") == ((0, 1), (2, 3), (4, 5), (6, 7))
    assert g.members("data") == ((0, 2, 4, 6), (1, 3, 5, 7))
    assert g.members("local") == ((0, 1, 2, 3), (4, 5, 6, 7))
    assert g.members("host") == ((0, 4), (1, 5), (2, 6), (3, 7))
    assert g.members("grid") == (tuple(range(8)),)
