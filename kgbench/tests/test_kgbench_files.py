"""The benchmark's files: ``BENCHMARK.json`` keeps to its contract, every
cell, configuration, traffic mix and metric it names is found by name,
and a cell added as files alone runs without an edit to a file that was
there."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from kgbench_tiny import MIX, ROOT, SEED

from kgbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CHECKS = {"train": {"batch_mismatch", "loss_gap", "grad_gap", "change_gap",
                   "group_loss_gap"},
          "linkpred": {"ranks_outside"}, "topk": {"topk_outside"}}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return harness.benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "kgbench/run.py"]
    assert bench["paths"] == ["kgbench"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names)
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"] == f"kgbench/configs/{c['name']}.json"
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["source"] == c["source"]
        assert 1 <= len(c["source"]) <= 200 and "\n" not in c["source"]
        # every key changed from the source is named, and none is a width
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and k in data["assumed"], k
            assert not re.search(r"(size|dim|rank|width|heads)$", k), k


def test_workloads_match_their_files(bench):
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = harness.load_cell(w["name"])
        for k in ("config", "traffic", "chips", "why"):
            assert cell["workload"][k] == w[k]
        assert set(cell["workload"]["limits"]) == CHECKS[cell["mix"]["kind"]]
        assert cell["workload"]["control"]["side"] in ("program",
                                                       "reference")


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = list(e2e) + [m["name"] for m in bench["per_layer"]]
    assert len(set(names)) == len(names)
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        for c in m["workloads"]:
            assert c in cells
            assert c in e2e[m["moves"]].get("workloads", cells)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        assert harness.metric_reader(m["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for c in cells:
        got_e2e, got_layer = harness.cell_metrics(bench, c)
        assert "setup_s" in {m["name"] for m in got_e2e}
        assert len(got_e2e) >= 2 and got_layer


def test_paths_hold_only_names(bench):
    for p in (ROOT / "kgbench").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel


ADDED = {
    # a new mix of an existing kind, and one that sets a configuration key
    "transe_d200_fb15k237.topk_k5": (
        "transe_d200_fb15k237.topk", "topk_k5", {"k": 5},
        {"topk_p95_ms", "setup_s"}),
    "transe_d200_fb15k237.train_neg2": (
        "transe_d200_fb15k237.train", "train_neg2",
        {"config": {"negative_ent": 2}}, {"train_triples_per_s", "setup_s"}),
}


@pytest.mark.parametrize("cell", sorted(ADDED))
def test_an_added_cell_runs_without_an_edit(tmp_path, bench, cell):
    """A copy of the benchmark with one more cell, added as a traffic mix
    file, a workload file and a ``BENCHMARK.json`` entry, runs it."""
    like, mix_name, mix_keys, want = ADDED[cell]
    shutil.copytree(ROOT / "kgbench", tmp_path / "kgbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    w = json.loads((ROOT / f"kgbench/workloads/{like}.json").read_text())
    mix = json.loads((ROOT / f"kgbench/traffic/{w['traffic']}.json")
                     .read_text())
    (tmp_path / f"kgbench/traffic/{mix_name}.json").write_text(
        json.dumps({**mix, **mix_keys}))
    w.update(traffic=mix_name, why="a cell added as files")
    (tmp_path / f"kgbench/workloads/{cell}.json").write_text(json.dumps(w))
    b = json.loads(json.dumps(bench))
    b["workloads"].append({"name": cell, "config": w["config"],
                           "traffic": mix_name, "chips": 1, "why": w["why"]})
    for m in b["end_to_end"] + b["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
        "from kgbench.harness import execute, HERE\n"
        f"assert str(HERE).startswith({str(tmp_path)!r}), HERE\n"
        "from kgbench.tests.kgbench_tiny import CONFIG\n"
        f"r = execute({cell!r}, {SEED}, 0.2, False, 'cpu',\n"
        f"            overrides={{'config': CONFIG, 'mix': {MIX!r}}})\n"
        "print(json.dumps({k: r[k] for k in ('correct', 'metrics')}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    assert set(got["metrics"]) == want
