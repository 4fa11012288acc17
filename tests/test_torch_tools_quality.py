"""The port's quality tools on the CPU: ``quality_anchors``' ceiling (the
generator's hidden tables ranked by the port) equals the JAX evaluator's
ranks of the same tables but for near-ties, at ``--scale 0.02``; one
family trains through ``main``; and the acceptance runbook's stand-ins
PASS configs 1 and 2, and config 5 on two gloo ranks of ``cli.launch``,
which SKIPs on one."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openkeonspark_tpu.config import Config as JConfig
from openkeonspark_tpu.data.index import build_kg_index as jax_index
from openkeonspark_tpu.data.synth import planted_kg as jax_planted_kg
from openkeonspark_tpu.eval import link_prediction as jax_link_prediction
from openkeonspark_tpu_torch.data import build_kg_index
from openkeonspark_tpu_torch.tools import acceptance, quality_anchors

from torch_parity import MAX_NEAR_TIE_SHARE, model_near_tie_counts

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("family", ["transe", "transh", "transd", "rotate"])
def test_ceiling_matches_jax(family):
    ds, hidden, kg_model, dim = quality_anchors.planted(family, scale=0.02)
    assert (ds.n_ent, kg_model) == (200, family)
    got = quality_anchors.ceiling(kg_model, dim, ds, hidden,
                                  build_kg_index(ds, for_eval=True), CPU)

    # the JAX tool's ceiling (tools/quality_anchors.py:103-149) on the
    # same planted KG: its generator is the port's copy
    kg_kw = dict(quality_anchors.SPECS[family][0], n_ent=200,
                 n_triples=4000)
    n_test = min(5000, kg_kw["n_triples"] // 8)
    jds, jhidden = jax_planted_kg(n_valid=min(2000, n_test), n_test=n_test,
                                  noise=0.0, seed=1, model=family,
                                  head_frac=0.5, with_params=True, **kg_kw)
    np.testing.assert_array_equal(jds.test, ds.test)
    hs = dim // 2 if family == "rotate" else dim
    want = jax_link_prediction({k: jnp.asarray(v) for k, v in
                                jhidden.items()},
                               JConfig(model=family, hidden_size=hs,
                                       p_norm=2),
                               jds, jax_index(jds, for_eval=True),
                               triples=jds.test)

    ties = model_near_tie_counts(family, hidden, ds.test, 2)
    for k in want.ranks:
        diff = np.abs(got.ranks[k] - np.asarray(want.ranks[k]))
        assert (diff <= ties[k.split("_")[1]]).all(), k
    share = np.concatenate([ties["head"], ties["tail"]]) > 0
    assert share.mean() < MAX_NEAR_TIE_SHARE
    if all((got.ranks[k] == np.asarray(want.ranks[k])).all()
           for k in want.ranks):
        assert got.filt_avg.hits10 == pytest.approx(want.filt_avg.hits10,
                                                    abs=0)
        assert got.filt_avg.mrr == pytest.approx(want.filt_avg.mrr,
                                                 rel=1e-12)
    assert got.filt_avg.hits10 > 0.3      # the planted structure is there


def test_quality_anchors_main_trains_a_family(capsys):
    (rec,) = quality_anchors.main(["--models", "transe", "--scale", "0.02",
                                   "--epochs-scale", "0.05", "--device",
                                   "cpu"])
    assert rec["device"] == "cpu" and rec["n_ent"] == 200
    assert np.isfinite(rec["final_loss"])
    assert rec["recovery_hits10"] == pytest.approx(
        rec["filt_hits10"] / rec["ceiling_hits10"], abs=1e-3)
    assert json.loads(capsys.readouterr().out.strip()) == rec


def test_acceptance_stand_in_configs_1_2_pass(tmp_path):
    rows, summary = acceptance.main([
        "--stand-in", "--quick", "--configs", "1,2", "--data-root",
        str(tmp_path), "--device", "cpu"])
    assert summary["pass"] == 2 and summary["fail"] == 0
    assert [r["status"] for r in rows] == ["PASS", "PASS"]
    assert rows[0]["checks"] == {"loss_falls_3x": True}
    assert rows[1]["checks"] == {"filt_hits10_recovered": True}
    assert (tmp_path / "fb15k237" / "train2id.txt").exists()
    assert (tmp_path / "fb15k237" / "entity2id.txt").exists()


@pytest.mark.parametrize("ranks,status", [(2, "PASS"), (1, "SKIP")])
def test_acceptance_config_5_on_gloo_ranks(tmp_path, ranks, status):
    """Config 5's multi-device run: two ``cli.launch`` processes under
    gloo train the DBpedia stand-in on a (1, 2) grid; one rank SKIPs, as
    the JAX tool does on one device."""
    rows, summary = acceptance.main([
        "--stand-in", "--quick", "--configs", "5", "--ranks", str(ranks),
        "--data-root", str(tmp_path), "--device", "cpu"])
    (row,) = rows
    assert row["status"] == status, row
    if status == "PASS":
        assert row["checks"] == {"throughput": True}
        assert row["triples_per_sec"] > 0 and np.isfinite(row["final_loss"])
        assert row["epochs"] == 3
    else:
        assert "needs >=2 devices" in row["reason"]
