"""Training CLI of the PyTorch port: load the data, train (resuming from
the output directory's latest checkpoint), export the tables, and
optionally evaluate.

Same flags and printout as ``openkeonspark_tpu.cli.train``, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).
Models: transe, transh, transd, rotate, distmult and complex (generic
step) and transr (the relation-grouped step; with ``--negative_rel > 0``
its relation negatives are a second relation-sorted stream, and bf16
tables take the generic step; CUDA kernels on the card).
Optimizers: sgd and the lazy adam, adagrad and adadelta. ``--trace_dir``
writes a ``torch.profiler`` Chrome trace of the second epoch
(``train/loop.py``). ``--type_constrain`` adds the type-constrained table
to the closing link prediction when the dataset directory holds
``type_constrain.txt``. The table dtype is the ``Config`` field ``dtype``
(float32 or bfloat16; no flag sets it, in either package), reached through
``run`` and ``train.loop.train``. ``--sampler host`` feeds the steps from
the native host sampler (``sampling/host.py``). ``--mesh_data`` /
``--mesh_model`` train on a grid of processes, one device each, through
``cli/launch.py`` (which forms the process group; the flat grid's psum or
exchange step, ``parallel/``); only rank 0 echoes and writes files. With
``--chips_per_host`` a grid that spans hosts of that many devices runs the
hierarchical step (a (host, data, model) grid, ``parallel/hier.py``);
``--exchange_hot_rows`` replicates the hottest entity rows and
``--exchange_capacity stats`` sizes the exchange buckets from the degree
tables (``parallel/hot.py``).

Usage:
    python -m openkeonspark_tpu_torch.cli.train --input data/FB15K \\
        --model transr --ent_size 200 --rel_size 100 --alpha 0.01 \\
        --nbatches 100 --train_times 50 --valid_every 5 \\
        --test_link_prediction --device cuda

Incremental mode (the reference's batch folders ``<input>/0/ 1/ …``):
    python -m openkeonspark_tpu_torch.cli.train --input data/KG \\
        --output out/KG --batch_number 2 …
    trains on data/KG/2/, writes out/KG/2/ and warm-starts from
    out/KG/1/'s latest checkpoint (new entities and relations keep their
    fresh init; the global step, and with it the random stream, goes on
    from batch 1's).
"""

from __future__ import annotations

import os
import sys

import torch

from openkeonspark_tpu_torch.cli.args import build_parser, config_from_args
from openkeonspark_tpu_torch.cli.launch import (join_process_group,
                                                rank_device)
from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.data.dataset import load_dataset
from openkeonspark_tpu_torch.data.index import build_kg_index
from openkeonspark_tpu_torch.ckpt import (CheckpointManager,
                                          export_parameters, latest_step,
                                          warm_start_from, warm_start_path)
from openkeonspark_tpu_torch.eval import (link_prediction,
                                          triple_classification,
                                          type_constrained_link_prediction)
from openkeonspark_tpu_torch.models.base import get_model
from openkeonspark_tpu_torch.parallel import (Sharding, build_train_step_for,
                                              hier_shape, make_mesh,
                                              plan_sharded_step, shard_state)
from openkeonspark_tpu_torch.parallel.hot import degree_stats
from openkeonspark_tpu_torch.parallel.eval import (
    ShardedTripleScorer, sharded_link_prediction,
    sharded_type_constrained_link_prediction)
from openkeonspark_tpu_torch.runtime import check_supported, resolve_device
from openkeonspark_tpu_torch.train.loop import train
from openkeonspark_tpu_torch.train.step import (check_train_supported,
                                                init_state)


def run(cfg: Config, device: torch.device, export_format: str = "json",
        echo=print) -> dict:
    """Programmatic entry (the CLI is a thin wrapper); returns a summary
    dict with the final metrics. A ``cfg.mesh_shape`` of more than one
    device trains on the grid of the initialised process group
    (``cli/launch.py`` forms it; ``cfg.coordinator`` lets this function
    form it): every rank calls ``run`` alike."""
    check_train_supported(cfg)
    if cfg.test_link_prediction or cfg.test_triple_classification:
        check_supported(cfg)
    data_dir, out_dir = cfg.in_path, cfg.out_path
    if cfg.batch_number is not None:
        data_dir = os.path.join(cfg.in_path, str(cfg.batch_number))
        out_dir = os.path.join(cfg.out_path, str(cfg.batch_number))
    join_process_group(cfg, device)
    ds = load_dataset(data_dir)
    echo(f"dataset: {ds.n_ent} entities, {ds.n_rel} relations, "
         f"{ds.n_train} train / {ds.n_valid} valid / {ds.n_test} test")
    model = get_model(cfg.model)
    index = build_kg_index(ds, for_eval=(cfg.test_link_prediction or
                                         cfg.test_triple_classification))
    grid = None
    if cfg.mesh_shape[0] * cfg.mesh_shape[1] != 1:
        d, m = cfg.mesh_shape
        if d == -1 and m > 0 and torch.distributed.is_initialized():
            d = max(1, torch.distributed.get_world_size() // m)
        # a grid spanning hosts of chips_per_host devices runs the
        # hierarchical step (cli/train.py:99-131)
        hshape = (hier_shape((d, m), cfg.chips_per_host)
                  if cfg.sharded_step == "exchange" and d > 0 else None)
        grid = make_mesh(hshape or (d, m), device)
        cfg = cfg.replace(mesh_shape=(grid.data, grid.model))
    # pad to the grid size: both layouts divide it (flat needs rows %
    # (D·M) == 0, the psum layout rows % M == 0)
    state = init_state(model, cfg, ds.n_ent, ds.n_rel,
                       torch.Generator().manual_seed(cfg.seed), device,
                       pad_to_multiple=grid.size if grid else 1)

    # crash recovery: a checkpoint in this run's output dir is resumed,
    # and only the remaining epochs run; the data order replays exactly
    # (group generators derive from the restored global step). An
    # incremental batch counts its epochs from the step it warm-started
    # at, since the global step carries across batches. A grid restores
    # the full tables, then keeps its rows.
    prev = warm_start_path(cfg.out_path, cfg.batch_number)
    ls = latest_step(out_dir) if out_dir else None
    if ls is not None:
        logical = {n: s.rows for n, s in
                   model.tables(cfg, ds.n_ent, ds.n_rel).items()}
        state, _ = CheckpointManager(out_dir).restore(
            state, step=ls, logical_rows=logical)
        base = (latest_step(prev) or 0) if prev else 0
        done = max(0, state.step - base) // max(cfg.nbatches, 1)
        cfg = cfg.replace(train_times=max(0, cfg.train_times - done))
        echo(f"resumed from {out_dir} step {state.step} "
             f"({done} epochs done, {cfg.train_times} remaining)")
    elif prev:
        state, _ = warm_start_from(state, prev, model, cfg)
        echo(f"warm start from {prev} (step {state.step})")

    sharding = step_builder = None
    if grid is not None and grid.size > 1:
        # round the batch down to a grid multiple, so the exchange step's
        # geometry (B/D divisible by M) holds (the reference's batch is a
        # rounding too)
        bs = cfg.resolve_batch_size(ds.n_train)
        if bs % grid.size:
            cfg = cfg.replace(batch_size=max(grid.size,
                                             bs - bs % grid.size))
        bs = cfg.resolve_batch_size(ds.n_train)
        kind = plan_sharded_step(cfg, bs, grid)
        sharding = Sharding(grid, flat=(kind != "psum"))
        state = shard_state(state, grid, flat=sharding.flat)
        step_fn = build_train_step_for(model, cfg, grid, bs, ds.n_train,
                                       degrees=degree_stats(ds))
        step_builder = lambda *_: step_fn  # noqa: E731
        mb = getattr(step_fn, "microbatches", cfg.exchange_microbatches)
        echo(f"mesh: data={grid.data} model={grid.model} ({grid.size} "
             f"devices, {grid.backend}"
             + (f", {grid.hosts} hosts" if grid.hosts else "")
             + f") step={kind}"
             + (f" microbatches={mb} (of {cfg.exchange_microbatches}: "
                "the per-rank batch does not divide)"
                if mb < cfg.exchange_microbatches else ""))

    result = train(cfg, ds, device, index=index, state=state,
                   checkpoint_dir=out_dir, echo=echo,
                   step_builder=step_builder, sharding=sharding)
    state = result.state

    full = (sharding.gather(state.params) if sharding is not None
            else state.params)
    if grid is None or grid.rank == 0:
        export_name = ("embedding.vec.json" if export_format == "json"
                       else "embedding.npz")
        export_parameters(full, model, cfg, ds.n_ent, ds.n_rel,
                          os.path.join(out_dir, export_name),
                          fmt=export_format)
    # the final manifest records the vocabulary sizes
    CheckpointManager(out_dir, sharding=sharding).save(
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
            if sharding is not None:
                res = sharded_link_prediction(state.params, cfg, ds, index,
                                              sharding, log=echo)
            else:
                res = link_prediction(state.params, cfg, ds, index, log=echo)
            echo(res.format_table())
            summary["link_prediction"] = {
                "filtered_mrr": res.filt_avg.mrr,
                "filtered_hits10": res.filt_avg.hits10,
                "raw_mrr": res.raw_avg.mrr,
            }
            if cfg.type_constrain:
                from openkeonspark_tpu_torch.data import maybe_load
                tc = maybe_load(data_dir)
                if tc is None:
                    echo("type_constrain.txt not found; skipping "
                         "constrained eval (generate with "
                         "tools/gen_type_constrain.py)")
                else:
                    if sharding is not None:
                        rc = sharded_type_constrained_link_prediction(
                            state.params, cfg, ds, index, tc, sharding,
                            log=echo)
                    else:
                        rc = type_constrained_link_prediction(
                            state.params, cfg, ds, index, tc, log=echo)
                    echo("type-constrained:")
                    echo(rc.format_table())
                    summary["type_constrained"] = {
                        "filtered_mrr": rc.filt_avg.mrr,
                        "filtered_hits10": rc.filt_avg.hits10,
                    }
        if cfg.test_triple_classification and ds.n_valid and ds.n_test:
            score_fn = (ShardedTripleScorer(cfg, sharding)
                        if sharding is not None else None)
            out = triple_classification(state.params, cfg, ds, index,
                                        score_fn=score_fn)
            echo(f"triple classification: {out}")
            summary["triple_classification"] = out
    return summary


def main(argv=None) -> dict:
    p = build_parser(__doc__)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda or cpu)")
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    return run(cfg, rank_device(cfg, resolve_device(args.device)),
               args.export_format)


if __name__ == "__main__":
    main(sys.argv[1:])
