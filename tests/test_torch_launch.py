"""The port's launcher end to end on the CPU: gloo process groups over
``localhost`` train on a grid through ``cli.launch`` (the pattern of
``tests/test_launch.py:23-84``), the checkpoint a grid writes resumes on
one device and the other way round, ``cli.evaluate`` ranks on a grid as
on one device, and a world of one forms its group. Every process is
killed at its timeout."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist

from openkeonspark_tpu_torch.ckpt import latest_step, read_parameters
from openkeonspark_tpu_torch.cli import launch
from openkeonspark_tpu_torch.cli import train as train_cli
from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.data import (build_kg_index, load_dataset,
                                          random_kg, save_dataset)
from openkeonspark_tpu_torch.eval import link_prediction
from openkeonspark_tpu_torch.models import get_model
from openkeonspark_tpu_torch.ckpt import params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
TRAIN = ["--model", "transe", "--hidden_size", "8", "--alpha", "0.1",
         "--margin", "1.0", "--nbatches", "7", "--negative_ent", "1",
         "--device", "cpu"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ranks(module, n, argv):
    """Start ``n`` ranks of ``python -m module`` joined at a free port."""
    port = _free_port()
    # one thread a rank: the ranks share the host's cores
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen(
        [sys.executable, "-m", module, "--coordinator", f"localhost:{port}",
         "--num_processes", str(n), "--process_id", str(pid), *argv],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(n)]


def _wait(groups):
    """Every rank's output, rank 0 first per group; raises if one fails."""
    outs = []
    try:
        for procs in groups:
            outs.append([p.communicate(timeout=TIMEOUT)[0] for p in procs])
    finally:
        for procs in groups:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    for procs, out in zip(groups, outs):
        for p, o in zip(procs, out):
            assert p.returncode == 0, o[-3000:]
    return outs


@pytest.fixture(scope="module")
def kg(tmp_path_factory):
    """947 triples: no divisor of the grid or of nbatches, so the batch is
    rounded down to a grid multiple (``tests/test_launch.py:87-127``)."""
    root = tmp_path_factory.mktemp("launch")
    save_dataset(random_kg(n_ent=90, n_rel=6, n_triples=947, n_valid=25,
                           n_test=25, seed=9), str(root / "kg"))
    return root


def test_grid_training_resumes_across_grids_and_one_device(kg):
    """Two ranks train two epochs on a (1, 2) grid (the exchange step,
    sharded validation and link prediction; only rank 0 echoes); one
    device resumes the grid's checkpoint for two more epochs; a (2, 1)
    grid resumes that one for two more."""
    data, out = str(kg / "kg"), str(kg / "out")
    (o0, o1), = _wait([_ranks("openkeonspark_tpu_torch.cli.launch", 2, [
        "--input", data, "--output", out, "--mesh_data", "-1",
        "--mesh_model", "2", "--train_times", "2", "--valid_every", "1",
        "--test_link_prediction", "--test_triple_classification", *TRAIN])])
    assert "2 process(es), gloo on cpu, mesh=(1,2)" in o0, o0[-2000:]
    assert "step=exchange" in o0 and "epoch=1" in o0, o0[-2000:]
    assert "valid_accuracy" in o0, o0[-2000:]
    assert "sharded link-pred tail done" in o0, o0[-2000:]
    assert "averaged(filter)" in o0 and "triple classification" in o0
    assert "epoch=" not in o1 and "averaged(filter)" not in o1, o1[-2000:]
    steps = latest_step(out)
    assert steps == 14

    summary = train_cli.main(["--input", data, "--output", out,
                              "--train_times", "4", *TRAIN])
    assert summary["steps"] == 28

    (o0, _), = _wait([_ranks("openkeonspark_tpu_torch.cli.launch", 2, [
        "--input", data, "--output", out, "--mesh_data", "2",
        "--mesh_model", "1", "--train_times", "6", *TRAIN])])
    assert "mesh=(2,1)" in o0 and "4 epochs done, 2 remaining" in o0, \
        o0[-2000:]
    assert latest_step(out) == 42
    tables, _ = read_parameters(os.path.join(out, "embedding.vec.json"))
    assert all(np.isfinite(v).all() for v in tables.values())


def test_grid_evaluation_prints_the_single_device_table(kg, tmp_path):
    """``cli.evaluate`` on a (1, 2) grid of two ranks prints the table of
    the single-device generic route on the same export, and a
    classification dict."""
    data = str(kg / "kg")
    out = str(tmp_path / "o")
    train_cli.main(["--input", data, "--output", out, "--train_times", "1",
                    *TRAIN])
    (o0, o1), = _wait([_ranks("openkeonspark_tpu_torch.cli.evaluate", 2, [
        "--input", data, "--checkpoint", out, "--model", "transe",
        "--hidden_size", "8", "--device", "cpu", "--mesh_model", "2",
        "--link_prediction", "--triple_classification"])])
    ds = load_dataset(data)
    cfg = Config(model="transe", hidden_size=8, use_pallas_eval=False)
    tables, _ = read_parameters(out)
    params = params_from_numpy(tables, get_model("transe"), cfg, ds.n_ent,
                               ds.n_rel, launch.torch.device("cpu"))
    want = link_prediction(params, cfg, ds, build_kg_index(ds, True))
    assert "eval mesh: (1, 2) (2 devices, gloo)" in o0, o0[-2000:]
    assert want.format_table() in o0, o0[-2000:]
    assert "triple classification: {'accuracy':" in o0
    assert "averaged(filter)" not in o1


def test_hier_grid_with_hot_rows(tmp_path):
    """Four ranks as two hosts of two (``--chips_per_host 2``) train
    through the hierarchical step with hot rows and degree-table
    capacities, validate and rank on the grid (the companions dropped);
    rank 0's checkpoint holds its replica of the ``#hot`` companions,
    equal to the tables' rows at the hot ids, and the export equals the
    checkpoint's tables."""
    import torch
    from openkeonspark_tpu_torch.parallel.hot import (choose_hot_ids,
                                                      degree_stats)
    data, out = str(tmp_path / "kg"), tmp_path / "o"
    save_dataset(random_kg(n_ent=600, n_rel=6, n_triples=3000, n_valid=25,
                           n_test=25, seed=4), data)
    (o0, *_), = _wait([_ranks("openkeonspark_tpu_torch.cli.launch", 4, [
        "--input", data, "--output", str(out), "--mesh_data", "2",
        "--mesh_model", "2", "--chips_per_host", "2", "--exchange_hot_rows",
        "64", "--exchange_capacity", "stats", "--train_times", "2",
        "--valid_every", "1", "--test_link_prediction", "--opt_method",
        "adagrad", *TRAIN])])
    assert "(4 devices, gloo, 2 hosts) step=hier" in o0, o0[-2000:]
    assert "valid_accuracy" in o0 and "averaged(filter)" in o0, o0[-2000:]
    step = latest_step(str(out))
    assert step == 14
    raw = torch.load(str(out / f"step_{step}" / "state.pt"),
                     weights_only=True)
    ids = torch.from_numpy(choose_hot_ids(*degree_stats(
        load_dataset(data))[:2], 64)).long()
    for tree in (raw["params"], raw["opt_state"]["accum"]):
        assert tree["ent_embeddings#hot"].shape == (64, 8)
        assert torch.equal(tree["ent_embeddings#hot"],
                           tree["ent_embeddings"][ids])
    tables, _ = read_parameters(str(out))
    assert sorted(tables) == ["ent_embeddings", "rel_embeddings"]
    for k, v in tables.items():
        np.testing.assert_array_equal(v, raw["params"][k][:len(v)].numpy())


def test_world_of_one(kg, tmp_path, capsys):
    """``--num_processes 1`` forms a gloo group of one (NCCL on a card),
    checks it with an all_reduce, trains and tears it down."""
    summary = launch.main(["--input", str(kg / "kg"), "--output",
                           str(tmp_path / "o"), "--num_processes", "1",
                           "--train_times", "1", "--sampler", "host",
                           *TRAIN])
    assert summary["steps"] == 7
    assert "1 process(es), gloo on cpu, mesh=(1,1)" in capsys.readouterr().out
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        launch.main(["--input", str(kg / "kg"), "--output",
                     str(tmp_path / "p"), "--num_processes", "2", *TRAIN])
