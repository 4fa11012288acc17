"""The generic-step training cells (``rotate_d1000_fb15k237.train_adv``,
``transr_d200_fb15k237.train_relneg``) on the CPU at a small size,
through ``kgbench_tiny.run_tiny`` with sizes of their own (RotatE's batch
of 1,024 and 256 negatives cut, relation negatives kept): the reference
agrees with the port (``correct``), its control (the port on bf16 tables)
does not, and neither does a run with a fault planted under the timed
path. Their files keep to the contract the other cells keep, and a traced
run reports the metrics each cell lists."""

from types import SimpleNamespace

import pytest

import kgbench_tiny

from kgbench import harness

CELLS = ("rotate_d1000_fb15k237.train_adv",
         "transr_d200_fb15k237.train_relneg")
CHECKS = {"batch_mismatch", "loss_gap", "grad_gap", "change_gap",
          "group_loss_gap"}
# the generic step's cells at a size the CPU takes in seconds
SMALL = {"batch_size": 48, "negative_ent": 6}


def _run(monkeypatch, cell, **kw):
    over = {"config": {**kgbench_tiny.CONFIG,
                       **(SMALL if "rotate" in cell else {})},
            "mix": dict(kgbench_tiny.MIX)}
    monkeypatch.setattr(kgbench_tiny, "OVERRIDES", over)
    return kgbench_tiny.run_tiny(cell, **kw)


FAULTS = [(c, f) for c in CELLS for f in sorted(
    harness.traffic_module(harness.load_cell(c)["mix"]["kind"]).FAULTS)]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_port_agrees_with_the_reference(monkeypatch, cell, trace):
    rec = _run(monkeypatch, cell, trace=trace)
    assert rec["correct"], rec["checks"]
    assert rec["attempted"] > 0 and rec["failed"] == 0
    assert rec["checks"]["batch_mismatch"]["value"] == 0
    e2e, layer = harness.cell_metrics(harness.benchmark(), cell)
    if trace:
        # the CPU has no device events: the device and launch counts and
        # the untraced window's share are silent, every span reads
        want = {m["name"] for m in layer
                if m["source"] == "program_span"}
        assert want <= set(rec["metrics"]), want - set(rec["metrics"])
        assert {"train.loss_ms", "train.optim_ms"} <= want
        for n in want:
            v = rec["metrics"][n]["value"]
            assert v == 0 if "syncs" in n else v > 0, n
    else:
        assert set(rec["metrics"]) == {m["name"] for m in e2e}
        assert all(v["value"] > 0 for v in rec["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(monkeypatch, cell):
    rec = _run(monkeypatch, cell, control=True)
    assert not rec["correct"], rec["checks"]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_is_not_correct(monkeypatch, cell, fault):
    rec = _run(monkeypatch, cell, faults=(fault,))
    assert not rec["correct"], rec["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_files_keep_the_contract(cell):
    files = harness.load_cell(cell)
    w = files["workload"]
    assert w["chips"] == 1 and set(w["limits"]) == CHECKS
    assert w["control"] == {"side": "program", "dtype": "bfloat16"}
    assert set(w["limits_why"]) == CHECKS
    mod = harness.traffic_module(files["mix"]["kind"])
    assert set(mod.FAULTS) == {"unchanged", "half_batch", "token"}
    entry = {x["name"]: x for x in harness.benchmark()["workloads"]}[cell]
    assert {k: entry[k] for k in ("config", "traffic", "chips", "why")} \
        == {k: w[k] for k in ("config", "traffic", "chips", "why")}


def test_rotate_runs_at_its_published_widths():
    c = harness.load_cell(CELLS[0])["config"]
    assert (c["model"], c["hidden_size"], c["negative_ent"],
            c["batch_size"], c["opt_method"], c["loss_mode"]) == (
        "rotate", 1000, 256, 1024, "adam", "self_adv")
    cfg = {x["name"]: x for x in harness.benchmark()["configs"]}[
        "rotate_d1000_fb15k237"]
    assert set(cfg["reduced"]) <= set(c["assumed"])
    assert c["source"] == cfg["source"]


def test_rotate_step_mfu_counts_its_work():
    """The RotatE step's work at the cell's shapes, every row touched:
    24 B an element of 14,542 x 2,000 and 238 x 1,000 rows, and 40 FLOPs
    a lane of 263,168 scored triples, so bytes bound it."""
    read = harness.metric_reader("rotate.step_mfu")
    sh = {"model": "rotate", "batch": 1024, "negative_ent": 256,
          "widths": {"ent_embeddings": 2000, "rel_embeddings": 1000},
          "distinct_ent_rows": 14542, "distinct_rel_rows": 238}
    touched = 14542 * 2000 + 238 * 1000
    nbytes = 24 * touched + 1024 * 259 * 4 + 1024 * 513 * 4
    flops = 1024 * 257 * 1000 * 40 + 12 * touched
    step_s = nbytes / 3.35e12 * 100           # a step at 1% of the bound
    share, bound = read(SimpleNamespace(shapes=sh, window_s=10 * step_s,
                                        window={"steps": 10}))
    assert bound == "bytes" and flops / 67e12 < nbytes / 3.35e12
    assert share == pytest.approx(1.0)
    assert read(SimpleNamespace(shapes={**sh, "model": "transe"},
                                window_s=1.0, window={"steps": 1})) is None
