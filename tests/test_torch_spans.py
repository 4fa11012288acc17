"""The port's stage spans (``openkeonspark_tpu_torch/obs.py``) on the CPU,
through the plain paths: under ``torch.profiler`` every traced path opens
its ``okst.*`` spans in the documented nesting and order; with no profiler
running no ``record_function`` is entered; and the losses, tables, ranks
and top-k answers are bit for bit the same with the profiler on and off.
The epoch trace of ``--trace_dir`` holds the spans too, with the host
sampler's wait on the host path."""

import importlib
import json
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from openkeonspark_tpu_torch import obs
from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.data import build_kg_index, random_kg
from openkeonspark_tpu_torch.eval.predict import (predict_head_entity,
                                                  predict_tail_entity)
from openkeonspark_tpu_torch.models import get_model
from openkeonspark_tpu_torch.runtime import eval_chunk_size
from openkeonspark_tpu_torch.sampling import DeviceSampler, SampledBatch
from openkeonspark_tpu_torch.train import loop
from openkeonspark_tpu_torch.train import step as tstep

lp = importlib.import_module("openkeonspark_tpu_torch.eval.link_prediction")
CPU = torch.device("cpu")
KG = dict(n_ent=120, n_rel=5, n_triples=1500, n_valid=40, n_test=90, seed=3)
S = 3                                         # steps a group
STAGES = ["okst.train.gather", ("okst.train.score", ["okst.train.loss"]),
          "okst.train.grad", "okst.train.update",
          ("okst.train.update", ["okst.train.optim"])]


@pytest.fixture(scope="module")
def kg():
    ds = random_kg(**KG)
    return ds, build_kg_index(ds, for_eval=True)


def _cfg(model):
    if model == "transr":
        return Config(model="transr", ent_size=8, rel_size=6, negative_ent=2,
                      nbatches=10, alpha=0.01, loss_mode="pairwise", seed=5)
    return Config(model=model, hidden_size=8, negative_ent=2, nbatches=10,
                  alpha=0.01, eval_chunk=16, eval_group_elems=2048, seed=5)


def _state(cfg, ds):
    return tstep.init_state(get_model(cfg.model), cfg, ds.n_ent, ds.n_rel,
                            torch.Generator().manual_seed(cfg.seed), CPU)


def _group(model):
    """One runner group of S steps from the device sampler."""
    def run(ds, index):
        cfg = _cfg(model)
        B = cfg.resolve_batch_size(ds.n_train)
        runner = tstep.build_group_runner(
            tstep.build_train_step(get_model(model), cfg, B), S)
        st, loss = runner(_state(cfg, ds), DeviceSampler.build(ds, index, CPU),
                          torch.Generator().manual_seed(11))
        return [loss, *st.params.values()]
    return run


def _host_scan(ds, index):
    """The host path's group: S stacked batches through the batch step."""
    cfg = _cfg("transe")
    B = cfg.resolve_batch_size(ds.n_train)
    sampler = DeviceSampler.build(ds, index, CPU)
    gen = torch.Generator().manual_seed(11)
    batches = [sampler.sample(B, cfg.negative_ent, 0, cfg.bern, gen=gen)
               for _ in range(S)]
    stacked = SampledBatch(**{
        f: None if getattr(batches[0], f) is None else
        torch.stack([getattr(b, f) for b in batches])
        for f in SampledBatch.FIELDS})
    st, loss = tstep.build_host_scan_steps(get_model("transe"), cfg)(
        _state(cfg, ds), stacked)
    return [loss, *st.params.values()]


def _evaluation(model):
    def run(ds, index):
        cfg = _cfg(model)
        st = _state(cfg, ds)
        res = lp.link_prediction(st.params, cfg, ds, index)
        return [torch.from_numpy(res.ranks[k]) for k in sorted(res.ranks)]
    return run


def _chunked_spans(ds):
    cfg = _cfg("transe")
    chunk = eval_chunk_size(cfg)
    idx = build_kg_index(ds, for_eval=True)
    _, k_max, _, _ = lp.known_windows(idx, ds.test, CPU)
    group_q = max(chunk, cfg.eval_group_elems // k_max // chunk * chunk)
    inner = ["okst.eval.prepare"]
    for s in range(0, len(ds.test), group_q):
        n = min(group_q, len(ds.test) - s)
        inner += ["okst.eval.chunk"] * math.ceil(n / chunk) \
            + ["okst.eval.fetch"]
    assert inner.count("okst.eval.fetch") >= 2       # more than one group
    assert inner.count("okst.eval.chunk") == math.ceil(len(ds.test) / chunk)
    return [("okst.eval.evaluation", inner)]


def _grouped_spans(ds):
    chunk = min(eval_chunk_size(_cfg("transr")), 64)
    rel, _ = lp._single_relation_chunks(ds.test[:, 2], chunk)
    return [("okst.eval.evaluation", ["okst.eval.prepare"]
             + ["okst.eval.chunk"] * len(rel) + ["okst.eval.fetch"])]


def _topk(fn):
    def run(ds, index):
        cfg = _cfg("transe")
        ids, scores = fn(_state(cfg, ds).params, cfg, ds.n_ent, ds.n_rel,
                         7, 2, k=10)
        return [torch.from_numpy(ids), torch.from_numpy(scores)]
    return run


GROUP = [("okst.train.group",
          [("okst.train.step", ["okst.train.sampling", *STAGES])] * S)]
TOPK = [("okst.topk.query", ["okst.topk.build", "okst.topk.score",
                             "okst.topk.select", "okst.topk.fetch"])]

# path → (run(ds, index) → tensors of its result, its spans(ds))
PATHS = {
    "transe_group": (_group("transe"), lambda ds: GROUP),
    "transr_grouped_group": (_group("transr"), lambda ds: GROUP),
    "host_scan": (_host_scan, lambda ds: [
        ("okst.train.group", [("okst.train.step", STAGES)] * S)]),
    "linkpred_chunked": (_evaluation("transe"), _chunked_spans),
    "linkpred_grouped": (_evaluation("transr"), _grouped_spans),
    "topk_tail": (_topk(predict_tail_entity), lambda ds: TOPK),
    "topk_head": (_topk(predict_head_entity), lambda ds: TOPK),
}


def _tree(prof):
    """The ``okst.*`` spans of a profile as nested (name, children) lists,
    children in order of start; a span without children is its name."""
    evs = [e for e in prof.events() if e.name.startswith("okst.")]
    kids = {id(e): [] for e in evs}
    roots = []

    def okst_parent(e):
        p = e.cpu_parent
        while p is not None and not p.name.startswith("okst."):
            p = p.cpu_parent
        return p

    for e in sorted(evs, key=lambda e: e.time_range.start):
        p = okst_parent(e)
        (kids[id(p)] if p is not None else roots).append(e)

    def node(e):
        return (e.name, [node(c) for c in kids[id(e)]]) if kids[id(e)] \
            else e.name
    return [node(e) for e in roots]


def test_the_grouped_transr_route_is_taken():
    assert tstep.use_grouped_transr(_cfg("transr"))
    assert lp.eval_route(_cfg("transr")) == "grouped"
    assert lp.eval_route(_cfg("transe")) == "kernel"


@pytest.mark.parametrize("path", sorted(PATHS))
def test_each_path_opens_its_spans_in_order(kg, path):
    run, want = PATHS[path]
    ds, index = kg
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(ds, index)
    assert _tree(prof) == want(ds)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_spans_cost_nothing_and_change_nothing_when_off(kg, path,
                                                        monkeypatch):
    """Without a profiler no ``record_function`` is entered (patched to
    raise); the results are bitwise equal to a profiled run's."""
    run, _ = PATHS[path]
    ds, index = kg
    with profile(activities=[ProfilerActivity.CPU]):
        on = run(ds, index)

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert obs.span("okst.x") is obs.span("okst.y")
    off = run(ds, index)
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("sampler", ["device", "host"])
def test_trace_dir_trace_holds_the_spans(tmp_path, kg, sampler):
    """``--trace_dir``'s epoch trace (``train.loop.train``): a group span
    a group, a step span a batch, its stages, and on the host path one
    ``okst.train.host_wait`` a group and no sampling span."""
    ds, _ = kg
    cfg = _cfg("transe").replace(train_times=2, valid_every=0,
                                 steps_per_scan=4, sampler=sampler,
                                 trace_dir=str(tmp_path / "tr"))
    loop.train(cfg, ds, CPU, echo=lambda s: None)
    events = json.loads((tmp_path / "tr" / loop.TRACE_NAME).read_text())[
        "traceEvents"]
    names = [e["name"] for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e["name"].startswith("okst.")]
    groups = math.ceil(cfg.nbatches / 4)
    want = {"okst.train.group": groups, "okst.train.step": cfg.nbatches,
            "okst.train.gather": cfg.nbatches,
            "okst.train.score": cfg.nbatches,
            "okst.train.loss": cfg.nbatches,
            "okst.train.grad": cfg.nbatches,
            "okst.train.optim": cfg.nbatches,
            "okst.train.update": 2 * cfg.nbatches}
    if sampler == "host":
        want["okst.train.host_wait"] = groups
    else:
        want["okst.train.sampling"] = cfg.nbatches
    assert {n: names.count(n) for n in set(names)} == want
