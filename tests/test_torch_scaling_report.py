"""The port's scaling and overlap reports
(``openkeonspark_tpu_torch/tools/scaling_report.py``, ``overlap_report.py``)
against their JAX twins (``tools/scaling_report.py``,
``tools/overlap_report.py``), each run once at a small size: the twin as a
subprocess on its virtual CPU devices, the port through ``main(argv)`` with
gloo ranks on the CPU.

- Flags and JSON keys: every flag and key of the twin, and the port's
  additions by name (``--device`` and ``"device"`` as every ported tool;
  the measured step's ``"step_ms_source"``; ``"efficiency"``, the
  per-kind ``"payload"``).
- Per mesh, ``payload_bytes``, ``wire_ici`` and ``wire_dcn`` equal the
  twin's, but for the itemised differences of ``test_torch_comm.py``:
  the (1, 1) mesh, whose JAX payload is all over one-device groups (its
  wire 0) where the port issues no collective, and the hierarchical
  step's dense gradients, reduced in fp32 by the port at the bf16 wire.
- ``overlap_report``'s ``collectives`` and ``wire_bytes_per_device``
  equal the twin's; its def-use pair counts are ``null``.
- Without ``--step-ms`` the single-device step is measured."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from openkeonspark_tpu_torch.tools import overlap_report, scaling_report

from test_torch_comm import hier_dense_extra

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALING = ["--meshes", "1x1,2x1,1x2,2x2,2x1x2", "--chips-per-host", "2",
           "--batch", "64", "--d", "16", "--n-ent", "2000", "--n-triples",
           "4000", "--step-ms", "0.5"]
OVERLAP = ["--mesh", "2,2", "--mbs", "1,2", "--steps", "1"]


def _twin(name, argv):
    return subprocess.Popen([sys.executable, os.path.join(REPO, "tools",
                                                          name), *argv],
                            cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith("{")]


@pytest.fixture(scope="module")
def reports():
    twins = {"scaling": _twin("scaling_report.py", SCALING),
             "overlap": _twin("overlap_report.py", OVERLAP)}
    try:
        port = {"scaling": scaling_report.main([*SCALING, "--device",
                                                "cpu"]),
                "overlap": overlap_report.main([*OVERLAP, "--device",
                                                "cpu"])}
        jax_out = {}
        for k, p in twins.items():
            out = p.communicate(timeout=600)[0]
            assert p.returncode == 0, out[-3000:]
            jax_out[k] = _json_lines(out)
    finally:
        for p in twins.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return port, {"scaling": jax_out["scaling"][-1],
                  "overlap": jax_out["overlap"]}


@pytest.mark.parametrize("tool,extra", [
    (scaling_report, {"--device"}),
    (overlap_report, {"--device"})], ids=["scaling", "overlap"])
def test_flags_are_the_twins(tool, extra):
    name = tool.__name__.rsplit(".", 1)[1]
    with open(os.path.join(REPO, "tools", name + ".py")) as f:
        jax_flags = set(re.findall(r'add_argument\(\s*"(--[\w-]+)"',
                                   f.read()))
    port_flags = {o for a in tool.build_parser()._actions
                  for o in a.option_strings if o.startswith("--")} - {
                      "--help"}
    assert port_flags - jax_flags == extra
    assert jax_flags <= port_flags


def test_scaling_keys_are_the_twins(reports):
    port, want = reports[0]["scaling"], reports[1]["scaling"]
    assert set(port) - set(want) == {"device", "step_ms_source",
                                     "efficiency"}
    assert set(want) <= set(port)
    assert port["meshes"].keys() == want["meshes"].keys()
    for k, row in want["meshes"].items():
        assert set(port["meshes"][k]) - set(row) == {"payload"}
        assert set(row) <= set(port["meshes"][k])
    assert port["efficiency"].startswith("predicted")
    assert port["device"] == "cpu"
    assert port["step_ms"] == 0.5 and port["step_ms_source"].startswith(
        "given")


def test_scaling_bytes_equal_the_twins(reports):
    port, want = reports[0]["scaling"], reports[1]["scaling"]
    kw = dict(model="transe", hidden_size=16, negative_ent=1)
    for k, row in want["meshes"].items():
        got = port["meshes"][k]
        shape = tuple(json.loads(k.replace("(", "[").replace(")", "]")))
        if shape == (1, 1):
            # one device: every JAX op is over a one-device group (wire
            # 0); the port issues none
            assert row["wire_bytes_per_device"] == 0 < row["payload_bytes"]
            assert got["payload_bytes"] == got["wire_ici"] == \
                got["wire_dcn"] == 0
            continue
        extra = hier_dense_extra(kw, shape, 2000, 237, 2)
        assert got["payload_bytes"] - extra.get("total", 0) == \
            row["payload_bytes"], (k, got, row, extra)
        for key in ("wire_ici", "wire_dcn"):
            assert got[key] - extra.get(key, 0) == row[key], (k, key)
        assert got["payload"]["all-to-all"] > 0
        if len(shape) == 3:
            assert extra["all-reduce"] > 0      # the bf16 wire's itemised
        assert 0 < got["scaling_efficiency"] <= 1
        assert got["predicted_step_s"] >= port["step_ms"] / 1e3


def test_overlap_equals_the_twin(reports):
    port, want = reports[0]["overlap"], reports[1]["overlap"]
    assert [r["microbatches"] for r in port] == [1, 2]
    for got, row in zip(port, want):
        assert set(got) - set(row) == {"device"}
        assert set(row) <= set(got)
        for k in ("microbatches", "mesh", "collectives",
                  "wire_bytes_per_device"):
            assert got[k] == row[k], (k, got, row)
        assert got["dependent_pairs"] is None
        assert got["independent_pairs"] is None
        assert got["cpu_mesh_ms_per_step"] > 0
    # a second microbatch adds collectives and bytes (its own exchanges)
    assert port[1]["collectives"] > port[0]["collectives"]


def test_single_device_step_is_measured():
    """Without ``--step-ms`` the tool times the configuration's
    single-device step through ``bench_all`` (here the CPU's at d=8; a
    batch past 2,621 keeps the group at its 50-step floor)."""
    args = {"d": 8, "step": "exchange", "wire_dtype": "bfloat16",
            "ici_dtype": "float32", "hot_rows": 0, "capacity": "uniform",
            "n_ent": 500, "n_triples": 1000, "batch": 2700,
            "chips_per_host": 2}
    ms = scaling_report.single_device_step_ms(args, torch.device("cpu"),
                                              steps=2, repeats=1)
    assert 0 < ms < 1e3
