"""The yardstick's frozen parts: the bound arithmetic reproduces
PERF.md §6's bounds, the KG generator a recorded checksum, and the trace
readers hand-worked answers on a small synthetic trace."""

import hashlib
import importlib.util
from types import SimpleNamespace

import pytest

from kgbench_tiny import ROOT

from kgbench import bounds, trace
from kgbench.kg import random_kg


def test_b1_bound_matches_perf_md():
    # C = 256, D = 200 over 14,541 entities: 0.0444 ms, fp32 issue
    t, by = bounds.b1_count(256, 14541, 200)
    assert round(t * 1e3, 4) == 0.0444 and by == "operations"


def test_b4_bounds_match_perf_md():
    # 19,252 rows, 200 -> 100, 1,346 relation rows, 1,305 present
    fwd, by_f = bounds.b4_fwd(19252, 1305, 200, 100)
    bwd, by_b = bounds.b4_bwd(19252, 1305, 1346, 200, 100)
    assert round(fwd * 1e3, 4) == 0.0381 and by_f == "bytes"
    assert round(bwd * 1e3, 4) == 0.0748 and by_b == "bytes"


def test_evaluation_bound_is_about_7_ms():
    t, by = bounds.evaluation_bound({"n_test": 20466, "chunk": 256,
                                "n_ent": 14541, "width": 200})
    assert t == pytest.approx(2 * 20466 * 14541 * 200 * 2 / 33.5e12,
                              rel=1e-3)
    assert by == "operations"


def test_random_kg_checksum():
    kg = random_kg(n_ent=60, n_rel=5, n_triples=500, n_valid=20, n_test=30,
                   seed=7)
    h = hashlib.sha256()
    for a in (kg.train, kg.valid, kg.test):
        h.update(a.tobytes())
    assert h.hexdigest() == ("588cdf9404425398cb9157cc89a6409e"
                             "e0ca36dc3869200ceae63d0a764b8706")


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid}


SYNTH = {"traceEvents": [
    _x(trace.MARK, "user_annotation", 1000, 100),
    _x("aten::add", "cpu_op", 1002, 6),
    _x("cudaLaunchKernel", "cuda_runtime", 1006, 1),
    _x("aten::sort", "cpu_op", 1030, 25),
    _x("cudaStreamSynchronize", "cuda_runtime", 1065, 30),
    _x("other thread", "cpu_op", 1000, 100, tid=2),
    _x("k1", "kernel", 1010, 10, tid=7),
    _x("k2", "kernel", 1015, 15, tid=7),
    _x("copy", "gpu_memcpy", 1050, 10, tid=7),
    _x("before the slice", "kernel", 900, 50, tid=7),
    {"ph": "i", "name": "instant", "ts": 1001},
]}


def test_slice_readers_on_a_synthetic_trace():
    sl = trace.parse(SYNTH, {"steps": 2, "chunks": 4, "queries": 3})
    assert sl.window_s == pytest.approx(100e-6)
    # device busy on [10, 30) and [50, 60) of the 100 µs window
    assert sl.busy_s() == pytest.approx(30e-6)
    assert sl.idle_pct() == pytest.approx(70.0)
    assert sl.launches() == 3
    ctx = SimpleNamespace(slice=sl)
    for name, want in (("train.launches_per_step", 1.5),
                       ("eval.launches_per_chunk", 0.75),
                       ("topk.launches_per_query", 1.0),
                       ("device_idle_pct.train", 70.0)):
        spec = importlib.util.spec_from_file_location(
            "m", ROOT / f"kgbench/metrics/{name}.py")
        m = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(m)
        assert m.read(ctx) == pytest.approx(want), name


def test_breakdown_names_each_gap_by_its_host_event():
    bd = trace.breakdown(trace.parse(SYNTH, {}))
    ops = dict(bd["device_ops"])
    assert ops == pytest.approx({"k1": 10e-6, "k2": 15e-6, "copy": 10e-6})
    gaps = dict(bd["idle_gaps"])
    # [0, 10): middle 5 in aten::add; [30, 50): middle 40 in aten::sort;
    # [60, 100): middle 80 in cudaStreamSynchronize
    assert gaps == pytest.approx({"aten::add": 10e-6, "aten::sort": 20e-6,
                                  "cudaStreamSynchronize": 40e-6})
    assert bd["device_ops"][0][0] == "k2"


def test_a_slice_without_device_events_reads_nothing():
    sl = trace.parse({"traceEvents": [
        _x(trace.MARK, "user_annotation", 0, 10)]}, {"steps": 1})
    assert sl.idle_pct() is None and sl.launches() == 0
