"""Type-constrained link prediction of the port
(``eval/type_constrained.py``) against the JAX package's for every model,
against a dense float64 oracle, and through both CLIs: the port's
``cli.evaluate`` and ``cli.train`` print the JAX CLI's constrained table.
Ranks are held to the JAX package's but for near-ties (two float orders,
``tests/torch_parity.py``)."""

import jax
import numpy as np
import pytest
import torch

from openkeonspark_tpu.cli import train as jax_train_cli
from openkeonspark_tpu.cli.args import build_parser as jax_parser
from openkeonspark_tpu.cli.args import config_from_args as jax_cfg_from_args
from openkeonspark_tpu.config import Config
from openkeonspark_tpu.data.dataset import save_dataset
from openkeonspark_tpu.data.index import build_kg_index
from openkeonspark_tpu.data.synth import planted_kg, random_kg
from openkeonspark_tpu.data.type_constrain import (build_type_constraints,
                                                   save_type_constraints)
from openkeonspark_tpu.eval import \
    type_constrained_link_prediction as jax_tc_lp
from openkeonspark_tpu.models import get_model as jax_get_model
from openkeonspark_tpu.train.step import init_state
from openkeonspark_tpu_torch.ckpt import (import_parameters,
                                          params_from_numpy)
from openkeonspark_tpu_torch.cli import evaluate
from openkeonspark_tpu_torch.cli import train as train_cli
from openkeonspark_tpu_torch.data import \
    build_type_constraints as port_build_tc
from openkeonspark_tpu_torch.eval import (link_prediction,
                                          type_constrained_link_prediction)
from openkeonspark_tpu_torch.models import get_model

from torch_parity import (model_near_tie_counts, model_scores64,
                          port_config, transr_near_tie_counts)

CPU = torch.device("cpu")
MODELS = ["transe", "transh", "transr", "transd", "rotate", "distmult",
          "complex"]


@pytest.fixture(scope="module")
def kg():
    ds = random_kg(n_ent=71, n_rel=6, n_triples=700, n_valid=30, n_test=40,
                   seed=5)
    return ds, build_kg_index(ds, for_eval=True)


def _setup(kg, model):
    ds, idx = kg
    dims = ({"ent_size": 12, "rel_size": 8} if model == "transr" else
            {"hidden_size": 12})
    cfg = Config(model=model, p_norm=1, eval_chunk=16, eval_block=32,
                 **dims)
    st = init_state(jax_get_model(model), cfg, ds.n_ent, ds.n_rel,
                    jax.random.key(4))
    jp = {k: np.asarray(v) for k, v in st.params.items()}
    tcfg = port_config(cfg)
    tp = params_from_numpy(jp, get_model(model), tcfg, ds.n_ent, ds.n_rel,
                           CPU)
    return ds, idx, cfg, jp, tp, tcfg


@pytest.mark.parametrize("model", MODELS)
def test_ranks_match_jax(kg, model):
    """Every model's constrained ranks equal the JAX package's but for
    near-ties, and never exceed the port's unconstrained ranks."""
    ds, idx, cfg, jp, tp, tcfg = _setup(kg, model)
    tc = build_type_constraints(ds)
    want = jax_tc_lp(jp, cfg, ds, idx, tc)
    got = type_constrained_link_prediction(tp, tcfg, ds, idx,
                                           port_build_tc(ds))
    tables = {k: v[:-1].numpy() for k, v in tp.items()}
    ties = (transr_near_tie_counts(tables["ent_embeddings"],
                                   tables["rel_embeddings"],
                                   tables["transfer_matrix"], ds.test, 1)
            if model == "transr"
            else model_near_tie_counts(model, tables, ds.test, 1))
    for k in want.ranks:
        diff = np.abs(got.ranks[k] - want.ranks[k])
        assert (diff <= ties[k.split("_")[1]]).all(), k
    unc = link_prediction(tp, tcfg, ds, idx)
    for k in got.ranks:
        assert (got.ranks[k] <= unc.ranks[k] + ties[k.split("_")[1]]).all()


def test_ranks_match_oracle(kg):
    """TransE's constrained raw and filtered ranks against a dense float64
    oracle: candidates allowed for the relation that score strictly
    better, less the known-true ones; exact where no candidate is a
    near-tie."""
    ds, idx, _, _, tp, tcfg = _setup(kg, "transe")
    tc = port_build_tc(ds)
    res = type_constrained_link_prediction(tp, tcfg, ds, idx, tc)
    tables = {k: v[:-1].numpy() for k, v in tp.items()}
    ties = model_near_tie_counts("transe", tables, ds.test, 1)
    all_trip = {tuple(x) for x in ds.all_triples().tolist()}
    masks = {"tail": tc.tail_mask(ds.n_ent), "head": tc.head_mask(ds.n_ent)}
    cand = np.arange(ds.n_ent)
    checked = 0
    for i, (h, t, r) in enumerate(ds.test.tolist()):
        for d, hh, tt, gold in (("tail", np.full(ds.n_ent, h), cand, t),
                                ("head", cand, np.full(ds.n_ent, t), h)):
            if ties[d][i]:
                continue
            s = model_scores64("transe", tables, hh, tt,
                               np.full(ds.n_ent, r), 1)
            better = (s < s[gold]) & masks[d][r].astype(bool)
            known = np.array([(a, b, r) in all_trip for a, b in zip(hh, tt)])
            known[gold] = False
            assert res.ranks[f"raw_{d}"][i] == better.sum(), (i, d)
            assert res.ranks[f"filt_{d}"][i] == (better & ~known).sum()
            checked += 1
    assert checked > 0.9 * 2 * len(ds.test)


@pytest.fixture(scope="module")
def trained_jax(tmp_path_factory):
    """The JAX CLI trained on a planted KG with ``type_constrain.txt``; its
    printout (with the constrained table) and export."""
    root = tmp_path_factory.mktemp("tc_cli")
    ds = planted_kg(n_ent=120, n_rel=5, n_triples=1500, n_valid=60,
                    n_test=60, dim=8, noise=0.0, seed=1)
    save_dataset(ds, str(root / "kg"))
    save_type_constraints(build_type_constraints(ds),
                          str(root / "kg" / "type_constrain.txt"))
    lines = []
    jax_train_cli.run(jax_cfg_from_args(jax_parser("x").parse_args(
        _train_argv(root, "jax"))), echo=lines.append)
    return root, ds, "\n".join(str(x) for x in lines)


def _port_cfg(argv):
    return train_cli.config_from_args(train_cli.build_parser("x")
                                      .parse_args(argv))


def _train_argv(root, out):
    return ["--input", str(root / "kg"), "--output", str(root / out),
            "--model", "transe", "--hidden_size", "12", "--alpha", "0.05",
            "--margin", "2.0", "--train_times", "3", "--nbatches", "10",
            "--eval_chunk", "32", "--test_link_prediction",
            "--type_constrain"]


def _tables_after(text, marker):
    """The six-row table that follows ``marker`` in a printout."""
    lines = text.splitlines()
    i = lines.index(marker)
    return "\n".join(lines[i + 1:i + 8])


def test_cli_evaluate_prints_the_jax_clis_constrained_table(trained_jax,
                                                             capsys):
    """``cli.evaluate --type_constrain`` on the JAX CLI's export prints the
    unconstrained table and, after ``type-constrained:``, the JAX CLI's
    constrained table; without ``type_constrain.txt`` it says so."""
    root, ds, jax_out = trained_jax
    assert "type-constrained:" in jax_out
    argv = ["--input", str(root / "kg"), "--checkpoint", str(root / "jax"),
            "--model", "transe", "--hidden_size", "12", "--eval_chunk", "32",
            "--device", "cpu", "--link_prediction", "--type_constrain"]
    evaluate.main(argv)
    out = capsys.readouterr().out
    assert (_tables_after(out, "type-constrained:")
            == _tables_after(jax_out, "type-constrained:"))
    save_dataset(ds, str(root / "kg_no_tc"))
    evaluate.main(["--input", str(root / "kg_no_tc")] + argv[2:])
    assert ("type_constrain.txt not found in dataset dir"
            in capsys.readouterr().out)


def test_cli_train_prints_the_constrained_table(trained_jax, tmp_path):
    """``cli.train --type_constrain --test_link_prediction`` prints, after
    ``type-constrained:``, the table the JAX package's type-constrained
    link prediction gives on the exported tables, returns it in the
    summary, and says so when ``type_constrain.txt`` is missing."""
    root, ds, _ = trained_jax
    lines = []
    summary = train_cli.run(_port_cfg(_train_argv(root, "port")), CPU,
                            echo=lines.append)
    table = _tables_after("\n".join(lines), "type-constrained:")
    jp = {k: np.concatenate([v, np.zeros((1, v.shape[1]), v.dtype)])
          for k, v in import_parameters(
              str(root / "port" / "embedding.vec.json")).items()}
    cfg = Config(model="transe", hidden_size=12, eval_chunk=32)
    want = jax_tc_lp(jp, cfg, ds, build_kg_index(ds, for_eval=True),
                     build_type_constraints(ds))
    assert table == want.format_table()
    tc = summary["type_constrained"]
    assert tc["filtered_mrr"] >= summary["link_prediction"]["filtered_mrr"]
    assert 0.0 < tc["filtered_hits10"] <= 1.0
    save_dataset(ds, str(tmp_path / "kg"))
    missing = []
    train_cli.run(_port_cfg(["--input", str(tmp_path / "kg")]
                            + _train_argv(root, "port2")[2:]), CPU,
                  echo=missing.append)
    assert any("type_constrain.txt not found" in str(x) for x in missing)
