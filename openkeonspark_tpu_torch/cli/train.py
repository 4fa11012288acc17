"""Training CLI of the PyTorch port: load the data, train (resuming from
the output directory's latest checkpoint), export the tables, and
optionally evaluate.

Same flags and printout as ``openkeonspark_tpu.cli.train``, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).
Models: transe, transh, transd and rotate (generic step) and transr (the
relation-grouped step with entity negatives only, the generic step with
``--negative_rel > 0``; CUDA kernels on the card). Optimizers: sgd and
the lazy adam, adagrad and adadelta. Options the port does not cover yet
(meshes and coordinators, ``--sampler host``, ``--batch_number``,
``--type_constrain``, ``--trace_dir``, ``--exchange_hot_rows``) raise
``NotPortedError``.

Usage:
    python -m openkeonspark_tpu_torch.cli.train --input data/FB15K \\
        --model transr --ent_size 200 --rel_size 100 --alpha 0.01 \\
        --nbatches 100 --train_times 50 --valid_every 5 \\
        --test_link_prediction --device cuda
"""

from __future__ import annotations

import os
import sys

import torch

from openkeonspark_tpu.cli.args import build_parser, config_from_args
from openkeonspark_tpu.config import Config
from openkeonspark_tpu.data.dataset import load_dataset
from openkeonspark_tpu.data.index import build_kg_index
from openkeonspark_tpu_torch.ckpt import (CheckpointManager,
                                          export_parameters, latest_step)
from openkeonspark_tpu_torch.models.base import get_model
from openkeonspark_tpu_torch.runtime import check_supported, resolve_device
from openkeonspark_tpu_torch.train.loop import train
from openkeonspark_tpu_torch.train.step import (check_train_supported,
                                                init_state)


def run(cfg: Config, device: torch.device, export_format: str = "json",
        echo=print) -> dict:
    """Programmatic entry (the CLI is a thin wrapper); returns a summary
    dict with the final metrics."""
    check_train_supported(cfg)
    if cfg.test_link_prediction or cfg.test_triple_classification:
        check_supported(cfg)
    out_dir = cfg.out_path
    ds = load_dataset(cfg.in_path)
    echo(f"dataset: {ds.n_ent} entities, {ds.n_rel} relations, "
         f"{ds.n_train} train / {ds.n_valid} valid / {ds.n_test} test")
    model = get_model(cfg.model)
    index = build_kg_index(ds, for_eval=(cfg.test_link_prediction or
                                         cfg.test_triple_classification))
    state = init_state(model, cfg, ds.n_ent, ds.n_rel,
                       torch.Generator().manual_seed(cfg.seed), device)

    # crash recovery: a checkpoint in this run's output dir is resumed,
    # and only the remaining epochs run; the data order replays exactly
    # (group generators derive from the restored global step)
    ls = latest_step(out_dir) if out_dir else None
    if ls is not None:
        logical = {n: s.rows for n, s in
                   model.tables(cfg, ds.n_ent, ds.n_rel).items()}
        state, _ = CheckpointManager(out_dir).restore(
            state, step=ls, logical_rows=logical)
        done = state.step // max(cfg.nbatches, 1)
        cfg = cfg.replace(train_times=max(0, cfg.train_times - done))
        echo(f"resumed from {out_dir} step {state.step} "
             f"({done} epochs done, {cfg.train_times} remaining)")

    result = train(cfg, ds, device, index=index, state=state,
                   checkpoint_dir=out_dir, echo=echo)
    state = result.state

    export_name = ("embedding.vec.json" if export_format == "json"
                   else "embedding.npz")
    export_parameters(state.params, model, cfg, ds.n_ent, ds.n_rel,
                      os.path.join(out_dir, export_name), fmt=export_format)
    # the final manifest records the vocabulary sizes
    CheckpointManager(out_dir).save(
        state.step, state,
        extra={"n_ent": ds.n_ent, "n_rel": ds.n_rel, "model": cfg.model,
               "hidden_size": cfg.hidden_size,
               "final_loss": result.final_loss})

    summary = {"final_loss": result.final_loss,
               "stopped_early": result.stopped_early,
               "best_valid_accuracy": result.best_valid_accuracy,
               "steps": state.step,
               "epoch_loss": [h.loss for h in result.history],
               "epoch_triples_per_sec": [h.triples_per_sec
                                         for h in result.history]}
    with torch.inference_mode():
        if cfg.test_link_prediction and ds.n_test:
            from openkeonspark_tpu_torch.eval import link_prediction
            res = link_prediction(state.params, cfg, ds, index, log=echo)
            echo(res.format_table())
            summary["link_prediction"] = {
                "filtered_mrr": res.filt_avg.mrr,
                "filtered_hits10": res.filt_avg.hits10,
                "raw_mrr": res.raw_avg.mrr,
            }
        if cfg.test_triple_classification and ds.n_valid and ds.n_test:
            from openkeonspark_tpu_torch.eval import triple_classification
            out = triple_classification(state.params, cfg, ds, index)
            echo(f"triple classification: {out}")
            summary["triple_classification"] = out
    return summary


def main(argv=None) -> dict:
    p = build_parser(__doc__)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda or cpu)")
    args = p.parse_args(argv)
    return run(config_from_args(args), resolve_device(args.device),
               args.export_format)


if __name__ == "__main__":
    main(sys.argv[1:])
