"""The readers of the port's stage spans (``kgbench/spans.py``,
``metrics/<name>.py`` with ``"source": "program_span"``): hand-worked
answers on a synthetic slice, None without their unit's span, and a tiny
traced run of every cell on the CPU that reports each such metric its cell
lists, with no sync (the CPU has no device to wait for)."""

from types import SimpleNamespace

import pytest

from kgbench_tiny import CELLS, run_tiny

from kgbench import harness
from kgbench.trace import Slice

MS = 1e-3


def _spans(*rows):
    return [(name, s * MS, e * MS) for name, s, e in rows]


# times in ms; two steps of one group, two evaluations, two queries, and
# runtime calls inside and outside each unit
HOST = _spans(
    ("okst.train.group", 0, 100),
    ("okst.train.step", 1, 40),
    ("okst.train.sampling", 2, 6), ("okst.train.gather", 6, 16),
    ("okst.train.score", 16, 20), ("okst.train.grad", 20, 30),
    ("okst.train.update", 30, 33), ("okst.train.update", 34, 36),
    ("cudaStreamSynchronize", 35, 35.5),
    ("okst.train.step", 50, 90),
    ("okst.train.sampling", 51, 53), ("okst.train.gather", 53, 63),
    ("okst.train.score", 63, 69), ("okst.train.grad", 69, 79),
    ("okst.train.update", 79, 85),
    ("cudaMemcpyAsync", 86, 87), ("cudaMemcpy", 95, 96),
    ("cudaStreamSynchronize", 150, 151),
    ("okst.eval.evaluation", 200, 400),
    ("okst.eval.prepare", 200, 210), ("cudaDeviceSynchronize", 205, 206),
    ("okst.eval.chunk", 210, 250), ("okst.eval.chunk", 250, 270),
    ("okst.eval.fetch", 270, 280), ("cudaEventSynchronize", 275, 276),
    ("cudaStreamSynchronize", 450, 451),
    ("okst.eval.evaluation", 500, 600),
    ("okst.eval.prepare", 500, 520), ("okst.eval.chunk", 520, 580),
    ("okst.eval.fetch", 580, 600),
    ("okst.topk.query", 700, 710),
    ("okst.topk.score", 701, 705), ("okst.topk.fetch", 706, 709),
    ("cudaStreamSynchronize", 707, 708),
    ("cudaStreamSynchronize", 715, 716),
    ("okst.topk.query", 720, 730),
    ("okst.topk.score", 721, 723), ("okst.topk.fetch", 725, 726),
    ("cudaStreamSynchronize", 725.5, 725.9),
)

# metric → (its hand-worked value, the unit span it divides by)
WANT = {
    "train.sampling_ms": (3.0, "okst.train.step"),       # (4 + 2) / 2
    "train.gather_ms": (10.0, "okst.train.step"),
    "train.score_ms": (5.0, "okst.train.step"),
    "train.grad_ms": (10.0, "okst.train.step"),
    "train.update_ms": (5.5, "okst.train.step"),         # (3 + 2 + 6) / 2
    "train.syncs_per_step": (1.0, "okst.train.step"),    # 35 and 95 of 2
    "eval.prepare_ms": (15.0, "okst.eval.evaluation"),
    "eval.chunk_ms": (40.0, "okst.eval.chunk"),          # (40 + 20 + 60) / 3
    "eval.fetch_ms": (15.0, "okst.eval.evaluation"),
    "eval.syncs_per_evaluation": (1.0, "okst.eval.evaluation"),
    "topk.score_ms": (3.0, "okst.topk.query"),
    "topk.fetch_ms": (2.0, "okst.topk.query"),
    "topk.syncs_per_query": (1.0, "okst.topk.query"),
}


def _slice(host):
    return Slice(start=0.0, end=1.0, host=list(host))


def _read(name, sl):
    return harness.metric_reader(name)(SimpleNamespace(slice=sl))


def test_every_program_span_metric_is_here():
    bench = harness.benchmark()
    assert {m["name"] for m in bench["per_layer"]
            if m["source"] == "program_span"} == set(WANT)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_synthetic_slice(name):
    assert _read(name, _slice(HOST)) == pytest.approx(WANT[name][0])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_none_without_its_unit_span(name):
    unit = WANT[name][1]
    assert _read(name, _slice(h for h in HOST if h[0] != unit)) is None
    assert _read(name, _slice([])) is None


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_traced_run_reports_its_span_metrics(cell):
    _, layer = harness.cell_metrics(harness.benchmark(), cell)
    names = {m["name"] for m in layer if m["source"] == "program_span"}
    assert names
    rec = run_tiny(cell, trace=True)
    got = rec["metrics"]
    assert names <= set(got), names - set(got)
    for n in names:
        v = got[n]["value"]
        assert v == 0 if n.split(".")[1].startswith("syncs") else v > 0, n
