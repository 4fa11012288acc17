"""The incremental warm start (``--batch_number``) and ``--trace_dir`` in
the port: ``warm_start_path`` against the JAX package's on the same
directories, ``warm_start_from`` into a grown vocabulary (old rows,
optimizer slots and step carried, new rows at their fresh init), from an
intermediate checkpoint, batch folders through ``cli.train`` (the random
stream goes on across batches; an interrupted and resumed batch equals an
uninterrupted one), and the second epoch's ``torch.profiler`` trace."""

import json
import os

import numpy as np
import pytest
import torch

from openkeonspark_tpu.ckpt import warm_start_path as jax_warm_start_path
from openkeonspark_tpu_torch.ckpt import (CheckpointManager,
                                          import_parameters, latest_step,
                                          warm_start_from, warm_start_path)
from openkeonspark_tpu_torch.cli import train as train_cli
from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.data import random_kg, save_dataset
from openkeonspark_tpu_torch.models import get_model
from openkeonspark_tpu_torch.runtime import NotPortedError
from openkeonspark_tpu_torch.tools.split_incremental import \
    split_incremental
from openkeonspark_tpu_torch.train.loop import TRACE_NAME, train
from openkeonspark_tpu_torch.train.step import (check_train_supported,
                                                init_state)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Training here is many tiny ops; torch's intra-op threads only
    contend with the other test workers for the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _argv(root, out, *extra):
    return ["--input", str(root), "--output", str(out), "--device", "cpu",
            "--model", "transe", "--hidden_size", "8", "--alpha", "0.05",
            "--margin", "1.0", "--negative_ent", "1", "--nbatches", "5",
            "--log_every", "100", *extra]


def test_warm_start_path_matches_jax(tmp_path):
    """Same answer as the JAX package's function on the same directories:
    none for batch 0 or no batch, the previous folder when it holds a
    step_N/, none when it holds none."""
    for sub in ("0/step_10", "1", "2/step_5", "2/step_15", "4/other"):
        os.makedirs(tmp_path / sub)
    for n in (None, 0, 1, 2, 3, 4, 5):
        assert warm_start_path(str(tmp_path), n) == \
            jax_warm_start_path(str(tmp_path), n), n
    assert warm_start_path(str(tmp_path), 1) == str(tmp_path / "0")
    assert warm_start_path(str(tmp_path), 2) is None


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam"])
def test_warm_start_into_a_grown_vocabulary(tmp_path, opt):
    """Batch 1 has 12 more entities and 2 more relations: the old logical
    rows of every table and optimizer slot are batch 0's, the new rows
    (and the pad row) the fresh state's, and the step is batch 0's."""
    cfg = Config(model="transd", hidden_size=6, opt_method=opt)
    model = get_model("transd")
    old = init_state(model, cfg, 40, 4, torch.Generator().manual_seed(1), CPU)
    g = torch.Generator().manual_seed(2)
    for slots in old.opt_state.values():
        for v in slots.values():
            v[:-1] = torch.rand(v[:-1].shape, generator=g)
    old.step = 37
    CheckpointManager(str(tmp_path)).save(old.step, old,
                                          extra={"n_ent": 40, "n_rel": 4})
    fresh = init_state(model, cfg, 52, 6, torch.Generator().manual_seed(3),
                       CPU)
    keep = {k: v.clone() for k, v in fresh.params.items()}
    warm, manifest = warm_start_from(fresh, str(tmp_path), model, cfg)
    assert manifest["n_ent"] == 40 and warm.step == 37
    for name, spec in model.tables(cfg, 40, 4).items():
        n = spec.rows
        assert warm.params[name].shape == keep[name].shape
        assert torch.equal(warm.params[name][:n], old.params[name][:n])
        assert torch.equal(warm.params[name][n:], keep[name][n:])
        for s, slots in warm.opt_state.items():
            assert torch.equal(slots[name][:n], old.opt_state[s][name][:n])
            assert torch.equal(slots[name][n:],
                               fresh.opt_state[s][name][n:])
    assert set(warm.opt_state) == set(fresh.opt_state)


def test_warm_start_from_an_intermediate_checkpoint(tmp_path):
    """A batch whose latest step_N/ is a validation checkpoint of a run cut
    short (no final manifest from cli.train) still warm-starts: the loop
    records the vocabulary in every manifest, and without it the sizes
    come from the stored tables' rows."""
    ds = random_kg(n_ent=60, n_rel=4, n_triples=600, n_valid=30, n_test=20,
                   seed=4)
    cfg = Config(model="transe", hidden_size=8, alpha=0.05, nbatches=5,
                 train_times=3, valid_every=1, log_every=100)
    seen = {}

    def cut(epoch, state):
        seen["params"] = {k: v.clone() for k, v in state.params.items()}
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        train(cfg, ds, CPU, checkpoint_dir=str(tmp_path),
              epoch_callback=cut, echo=lambda *_: None)
    assert latest_step(str(tmp_path)) == 5
    path = tmp_path / "step_5" / "manifest.json"
    manifest = json.loads(path.read_text())
    assert "final" not in manifest
    assert (manifest["n_ent"], manifest["n_rel"]) == (60, 4)
    model = get_model("transe")
    for without_counts in (False, True):
        if without_counts:
            del manifest["n_ent"], manifest["n_rel"]
            path.write_text(json.dumps(manifest))
        fresh = init_state(model, cfg, 70, 5,
                           torch.Generator().manual_seed(9), CPU)
        warm, _ = warm_start_from(fresh, str(tmp_path), model, cfg)
        assert warm.step == 5
        for k, v in seen["params"].items():
            assert torch.equal(warm.params[k][:-11 if k.startswith("ent")
                                              else -2], v[:-1]), k


def test_batches_continue_the_random_stream(tmp_path):
    """The same data in batch folders 0 and 1, one epoch each: batch 1
    warm-starts at batch 0's last step, and since the step groups' random
    bits derive from the global step, the two batches end exactly where
    one two-epoch run does."""
    ds = random_kg(n_ent=70, n_rel=4, n_triples=700, n_valid=30, n_test=30,
                   seed=6)
    for d in ("kg/0", "kg/1", "flat"):
        save_dataset(ds, str(tmp_path / d))
    for bn in (0, 1):
        msgs = []
        out = train_cli.run(
            Config(**_cfg_kw(tmp_path / "kg", tmp_path / "inc", 1),
                   batch_number=bn), CPU, echo=msgs.append)
        assert out["steps"] == 5 * (bn + 1)
        assert any(f"warm start from {tmp_path / 'inc' / '0'} (step 5)"
                   in str(m) for m in msgs) == (bn == 1), msgs
    train_cli.run(Config(**_cfg_kw(tmp_path / "flat", tmp_path / "full", 2)),
                  CPU, echo=lambda *_: None)
    a = import_parameters(str(tmp_path / "full" / "embedding.vec.json"))
    b = import_parameters(str(tmp_path / "inc" / "1" / "embedding.vec.json"))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _cfg_kw(data, out, epochs):
    return dict(model="transe", hidden_size=8, alpha=0.05, margin=1.0,
                negative_ent=1, nbatches=5, log_every=100, in_path=str(data),
                out_path=str(out), train_times=epochs)


def test_resumed_batch_matches_uninterrupted(tmp_path):
    """Batch 1 of two cumulative folders, interrupted after one of its two
    epochs and launched again with the same flags, counts its done epochs
    from the warm-start step and ends exactly where an uninterrupted
    batch 1 ends (the analog of the JAX package's
    ``test_cli_auto_resume_matches_uninterrupted``)."""
    ds = random_kg(n_ent=80, n_rel=5, n_triples=900, n_valid=40, n_test=40,
                   seed=8)
    for i, snap in split_incremental(ds, 2, 3):
        save_dataset(snap, str(tmp_path / "kg" / str(i)))
    kg = tmp_path / "kg"
    for out in ("full", "re"):
        train_cli.main(_argv(kg, tmp_path / out, "--batch_number", "0",
                             "--train_times", "1"))
    s0 = latest_step(str(tmp_path / "full" / "0"))
    full = train_cli.main(_argv(kg, tmp_path / "full", "--batch_number", "1",
                                "--train_times", "2"))
    train_cli.main(_argv(kg, tmp_path / "re", "--batch_number", "1",
                         "--train_times", "1"))
    msgs = []
    again = train_cli.run(
        Config(**_cfg_kw(kg, tmp_path / "re", 2), batch_number=1), CPU,
        echo=msgs.append)
    assert any("(1 epochs done, 1 remaining)" in str(m) for m in msgs), msgs
    assert full["steps"] == again["steps"] == s0 + 2 * 5
    a = import_parameters(str(tmp_path / "full" / "1" / "embedding.vec.json"))
    b = import_parameters(str(tmp_path / "re" / "1" / "embedding.vec.json"))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_trace_dir_writes_the_second_epochs_trace(tmp_path, capsys):
    """``--trace_dir`` on the CPU: a Chrome trace of epoch 1 (CPU
    activities) in the directory, and a ``trace_written`` record, also in
    the JSON log."""
    ds = random_kg(n_ent=50, n_rel=3, n_triples=400, n_valid=20, n_test=20,
                   seed=2)
    save_dataset(ds, str(tmp_path / "kg"))
    log = tmp_path / "log.jsonl"
    train_cli.main(_argv(tmp_path / "kg", tmp_path / "out", "--train_times",
                         "2", "--log_every", "1", "--trace_dir",
                         str(tmp_path / "tr"), "--log_path", str(log)))
    assert "event=trace_written" in capsys.readouterr().out
    trace = tmp_path / "tr" / TRACE_NAME
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    written = [r for r in recs if r.get("event") == "trace_written"]
    assert written == [{"event": "trace_written", "dir": str(tmp_path / "tr"),
                        "file": str(trace)}]
    assert [r["epoch"] for r in recs if "epoch" in r] == [0, 1]


def test_refusals_follow_the_ported_options():
    """``batch_number``, ``trace_dir``, bfloat16 tables (``dtype``), the
    host sampler and the degree-table capacities train; a table dtype the
    port does not take stays refused."""
    check_train_supported(Config(model="distmult", batch_number=1,
                                 trace_dir="t"))
    check_train_supported(Config(model="complex", dtype="bfloat16"))
    check_train_supported(Config(model="complex", sampler="host"))
    check_train_supported(Config(model="complex", exchange_capacity="stats"))
    with pytest.raises(NotPortedError, match="ROADMAP"):
        check_train_supported(Config(model="complex", dtype="float16"))
