"""Every cell on the CPU at a small size, through the port's plain
PyTorch paths: the reference agrees with the port (``correct``), its
control (the lower precision the workload file names) does not, and
neither does a run with a fault planted under the timed path: a step that
leaves the state unchanged, half of the batch left out, an id or an
answer altered where it is produced. (No cell spans chips, so none can
leave out an exchange between them.)"""

import pytest

from kgbench_tiny import CELLS, run_tiny

from kgbench import harness

FAULTS = [(c, f) for c in CELLS for f in sorted(
    harness.traffic_module(harness.load_cell(c)["mix"]["kind"]).FAULTS)]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_port_agrees_with_the_reference(cell, trace):
    rec = run_tiny(cell, trace=trace)
    assert rec["correct"], rec["checks"]
    assert rec["attempted"] > 0 and rec["failed"] == 0
    assert all(v["value"] == 0 for k, v in rec["checks"].items()
               if v["limit"] == 0)
    if trace:
        assert rec["device"]["window_s"] > 0
        assert set(rec["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        e2e, _ = harness.cell_metrics(harness.benchmark(), cell)
        assert set(rec["metrics"]) == {m["name"] for m in e2e}
        assert all(v["value"] > 0 for v in rec["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    rec = run_tiny(cell, control=True)
    assert not rec["correct"], rec["checks"]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_is_not_correct(cell, fault):
    rec = run_tiny(cell, faults=(fault,))
    assert not rec["correct"], rec["checks"]


def test_every_cell_has_its_faults():
    kinds = {c: harness.load_cell(c)["mix"]["kind"] for c in CELLS}
    for c, kind in kinds.items():
        want = {"unchanged", "half_batch", "token"} if kind == "train" \
            else {"half_batch", "answer"}
        assert set(harness.traffic_module(kind).FAULTS) == want
