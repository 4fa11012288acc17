"""The port's benchmark and breakdown tools on the CPU at small sizes:
``bench_all`` and ``step_breakdown`` run a tiny config and print the JAX
tools' keys, the step's stages attributed so that they sum to the full
step; ``eval_bench``'s ``filt_mr`` on tables carried across from the JAX
``init_state`` equals the JAX evaluator's for TransE and TransR (ranks
equal but for near-ties); ``eval_breakdown``, ``scatter_probe`` and
``sampler_bench`` run end to end; and every tool's entry point defaults
to the card and raises without one."""

import jax
import numpy as np
import pytest
import torch

from openkeonspark_tpu.config import Config as JConfig
from openkeonspark_tpu.data.index import build_kg_index as jax_index
from openkeonspark_tpu.data.synth import random_kg as jax_random_kg
from openkeonspark_tpu.eval import link_prediction as jax_link_prediction
from openkeonspark_tpu.models import get_model as jax_get_model
from openkeonspark_tpu.train.step import init_state as jax_init_state
from openkeonspark_tpu_torch.ckpt import params_from_numpy
from openkeonspark_tpu_torch.data import build_kg_index, random_kg
from openkeonspark_tpu_torch.models import get_model
from openkeonspark_tpu_torch.tools import (acceptance, bench_all,
                                           eval_bench, eval_breakdown,
                                           eval_profile, gen_type_constrain,
                                           hbm_budget, quality_anchors,
                                           sampler_bench, scatter_probe,
                                           split_incremental,
                                           step_breakdown)

from torch_parity import (port_config, transe_near_tie_counts,
                          transr_near_tie_counts)

CPU = torch.device("cpu")
TINY = {
    "transe": dict(model="transe", d=8, n_ent=300, n_rel=10, n_train=5400,
                   nbatches=2),
    "transr": dict(model="transr", d=8, d_rel=4, n_ent=300, n_rel=10,
                   n_train=5400, nbatches=2),
}
JAX_BENCH_KEYS = {"config", "model", "d", "n_ent", "n_train", "batch",
                  "triples_per_sec", "spread"}
JAX_BREAKDOWN_KEYS = {"config", "model", "batch", "steps_per_call",
                      "ms_per_step_cumulative", "ms_per_step_attributed",
                      "triples_per_sec"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many tiny ops; torch's intra-op threads only contend with the other
    test workers for the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def tiny_configs(monkeypatch):
    for i, spec in enumerate(TINY.values(), start=90):
        monkeypatch.setitem(bench_all.CONFIGS, i, spec)
    return dict(zip(TINY, range(90, 90 + len(TINY))))


def test_bench_all_tiny_config(tiny_configs, capsys):
    out = bench_all.main(["--configs", str(tiny_configs["transe"]),
                          "--steps", "1", "--repeats", "1", "--device",
                          "cpu"])
    (rec,) = out
    assert JAX_BENCH_KEYS <= set(rec)
    assert rec["device"] == "cpu" and "peak_device_MB" not in rec
    assert rec["batch"] == 2700
    # at least the group depth training uses (scan_group_size)
    assert rec["steps_per_call"] == 50 and rec["calls"] == 3
    assert rec["triples_per_sec"] > 0 and np.isfinite(rec["final_loss"])
    assert capsys.readouterr().out.count('"config": ') == 1


@pytest.mark.parametrize("model", ["transe", "transr"])
def test_step_breakdown_attribution_sums_to_full_step(tiny_configs, model):
    lines = step_breakdown.main(["--config", str(tiny_configs[model]),
                                 "--steps", "3", "--device", "cpu"])
    stages = [r["stage"] for r in lines if "stage" in r]
    assert stages == list(step_breakdown.STAGES)
    summary = lines[-1]
    assert JAX_BREAKDOWN_KEYS <= set(summary)
    cum, attr = (summary["ms_per_step_cumulative"],
                 summary["ms_per_step_attributed"])
    assert set(attr) == set(step_breakdown.STAGES) | {"update"}
    assert abs(sum(attr.values()) - cum["full"]) <= 1e-3 * len(attr)
    assert summary["full_device_ms_per_step"] is None   # no card
    ops = {r["op"]: r for r in lines if "op" in r}
    if model == "transr":
        assert set(ops) == {"wide_scatter_B_rows", "m_r_gather_B_rows",
                            "proj_einsum_2seg"}
        # the plain version on the CPU: the kernel launches nothing here
        assert ops["wide_scatter_B_rows"]["b5_launches_per_call"] == 0
        assert "note" in summary
    else:
        assert not ops


def test_attribution_telescopes():
    cum = {"sampling": 1.0, "gather": 1.5, "score": 2.25, "grad": 4.0,
           "full": 5.5}
    assert step_breakdown.attribute(cum) == {
        "sampling": 1.0, "gather": 0.5, "score": 0.75, "grad": 1.75,
        "update": 1.5}


@pytest.mark.parametrize("model,p", [("transe", 1), ("transe", 2),
                                     ("transr", 1)])
def test_eval_bench_filt_mr_matches_jax(model, p):
    kw = dict(n_ent=120, n_rel=6, n_triples=1500, n_valid=40, n_test=90,
              seed=4)
    jds = jax_random_kg(**kw)
    ds = random_kg(**kw)
    jcfg = JConfig(model=model, hidden_size=16, p_norm=p, eval_chunk=32,
                   **({"ent_size": 16, "rel_size": 8}
                      if model == "transr" else {}))
    st = jax_init_state(jax_get_model(model), jcfg, ds.n_ent, ds.n_rel,
                        jax.random.key(3))
    jp = {k: np.asarray(v) for k, v in st.params.items()}
    want = jax_link_prediction(st.params, jcfg, jds,
                               jax_index(jds, for_eval=True),
                               triples=jds.test)
    cfg = port_config(jcfg)
    tp = params_from_numpy(jp, get_model(model), cfg, ds.n_ent, ds.n_rel,
                           CPU)
    rec, got = eval_bench.bench_eval(tp, cfg, ds,
                                     build_kg_index(ds, for_eval=True),
                                     CPU, repeats=1)
    n = ds.n_ent
    tables = {k: v[:n if k.startswith("ent") else ds.n_rel]
              for k, v in jp.items()}
    if model == "transr":
        ties = transr_near_tie_counts(tables["ent_embeddings"],
                                      tables["rel_embeddings"],
                                      tables["transfer_matrix"], ds.test, p)
    else:
        ties = transe_near_tie_counts(tables["ent_embeddings"],
                                      tables["rel_embeddings"], ds.test, p)
    for k in want.ranks:
        diff = np.abs(got.ranks[k] - np.asarray(want.ranks[k]))
        assert (diff <= ties[k.split("_")[1]]).all(), k
    if all((got.ranks[k] == np.asarray(want.ranks[k])).all()
           for k in want.ranks):
        assert rec["filt_mr"] == round(want.filt_avg.mr, 1)
    assert rec["launches_per_eval"] == {}      # plain versions on the CPU
    assert {"model", "eval_dtype", "n_test", "n_ent", "triples_per_sec",
            "spread", "repeats", "filt_mr"} <= set(rec)


def test_eval_bench_anchor_is_its_own(tmp_path):
    """The port's anchor keeps one device's medians: a merge from the same
    device keeps the other models', one from another device starts
    afresh."""
    path = str(tmp_path / "anchor.json")
    eval_bench.merge_anchor(path, "card A", 100, 5, {"transe/float32": 1.0})
    a = eval_bench.merge_anchor(path, "card A", 100, 5,
                                {"transd/float32": 2.0})
    assert a["medians"] == {"transe/float32": 1.0, "transd/float32": 2.0}
    b = eval_bench.merge_anchor(path, "card B", 100, 5,
                                {"rotate/float32": 3.0})
    assert b == {"device": "card B", "n_test": 100, "repeats": 5,
                 "medians": {"rotate/float32": 3.0}}
    assert eval_bench.ANCHOR_PATH.endswith("bench_eval_anchor_torch.json")


def test_eval_breakdown_runs_the_chunk_pipeline():
    lines = eval_breakdown.main(["--n-ent", "400", "--n-test", "64", "--d",
                                 "8", "--chunk", "32", "--device", "cpu"])
    stages = [r["stage"] for r in lines if "stage" in r]
    assert stages == list(eval_breakdown.STAGES) + [
        "isolated_kernel_same_shapes"]
    s = lines[-1]
    assert s["chunk"] == 32 and s["n_test"] == 64 and s["k_max"] % 64 == 0
    assert set(s["ms_attributed_per_direction"]) == set(
        eval_breakdown.STAGES)
    assert s["launches"] == {}
    assert s["end_to_end_device_ms"] is None       # no card, no profile


@pytest.mark.parametrize("skew", [0.8, 0.0])
def test_scatter_probe_variants_agree(skew):
    times, floor, errs, b5_equal, b5_launches = scatter_probe.probe(
        300, 16, 400, 4, skew, CPU, repeats=1)
    assert set(times) == set(scatter_probe.VARIANTS) and floor > 0
    assert set(errs) == {"xla_scatter", "sgd_sum", "b5"}
    assert all(e < 1e-5 for e in errs.values()), errs
    assert b5_equal and b5_launches == 0


def test_scatter_probe_main_keys(monkeypatch):
    monkeypatch.setitem(scatter_probe.SHAPES, "tiny", (200, 8, 300))
    rec = scatter_probe.main(["--shape", "tiny", "--scan", "2",
                              "--repeats", "1", "--device", "cpu"])
    assert {"shape", "rows", "d", "stream", "skew", "scan",
            "xla_scatter_us", "xla_ns_per_row", "sort_gather_us",
            "noop_floor_us", "max_rel_err", "b5_us", "sgd_sum_us",
            "b5_equals_plain", "b5_launches", "device"} <= set(rec)


def test_sampler_bench_runs():
    lines = sampler_bench.main(["--threads", "1,2", "--steps", "2",
                                "--n-ent", "300", "--n-train", "4000",
                                "--batch", "64", "--device", "cpu"])
    assert [r["threads"] for r in lines[:-1]] == [1, 2]
    assert lines[-1]["metric"] == "host_sampler_generation_rate"
    assert lines[-1]["best_positives_per_sec"] > 0


@pytest.mark.parametrize("tool,argv", [
    (bench_all, []), (step_breakdown, []), (eval_bench, []),
    (eval_breakdown, []), (quality_anchors, []),
    (acceptance, ["--stand-in"]), (sampler_bench, []),
    (hbm_budget, []), (scatter_probe, []), (eval_profile, [])])
def test_tools_need_the_card_by_default(tool, argv, monkeypatch):
    """No tool falls back to the CPU: without a card the default device
    raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, SystemExit)) as e:
        tool.main(argv)
    assert "cuda" in str(e.value).lower() or "CUDA" in str(e.value)


def test_file_tools_take_no_device():
    """The dataset tools touch no device and take no ``--device``."""
    for tool in (split_incremental, gen_type_constrain):
        with pytest.raises(SystemExit):
            tool.main(["--device", "cpu"])
