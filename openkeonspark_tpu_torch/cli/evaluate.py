"""Evaluation CLI of the PyTorch port — link prediction, triple
classification and top-k prediction from saved tables.

Same flags and printout as ``openkeonspark_tpu.cli.evaluate``, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).
``--checkpoint`` names an export (``embedding.npz`` / ``embedding.vec.json``,
which ``cli.train`` writes every run), the port's own ``params.pt``, or a
directory holding one of them.

Usage:
    python -m openkeonspark_tpu_torch.cli.evaluate --input data/FB15K237 \
        --checkpoint out/ --model transe --hidden_size 200 \
        --link_prediction --triple_classification
    python -m openkeonspark_tpu_torch.cli.evaluate ... --predict_tail 123,7

Models: transe, transh, transd, rotate, distmult, complex, and transr
(``--ent_size`` / ``--rel_size``), each with the ``--predict_*``
queries. TransH ranks relation by relation through the TransE count
kernel, or, with ``OKST_EVAL_TRANSH_KERNEL=1`` and
``OKST_EVAL_FORCE_GENERIC=1``, chunk by chunk through its own kernel;
DistMult and ComplEx rank through one matrix product per query chunk.
``--type_constrain`` adds the type-constrained table when the dataset
directory holds ``type_constrain.txt``; ``--eval_dtype bfloat16`` scores
the generic, bilinear and top-k paths in bf16 (the kernel routes rank in
fp32 whatever it says, as the reference's do). Run as one copy per rank
with ``--coordinator host:port --num_processes N --process_id p``
(``cli/launch.py``'s flags, NCCL on a card, gloo on the CPU) and
``--mesh_data`` / ``--mesh_model``, it evaluates on the grid
(``parallel/eval.py``: candidate rows over 'model', query chunks over
'data'; classification through the sharded triple scorer); rank 0
prints and answers the top-k queries.
"""

from __future__ import annotations

import sys

import torch

from openkeonspark_tpu_torch.cli.args import build_parser, config_from_args
from openkeonspark_tpu_torch.cli.launch import (join_process_group,
                                                rank_device)
from openkeonspark_tpu_torch.data.dataset import load_dataset
from openkeonspark_tpu_torch.data.index import build_kg_index
from openkeonspark_tpu_torch.ckpt import params_from_numpy, read_parameters
from openkeonspark_tpu_torch.models.base import get_model, padded_rows
from openkeonspark_tpu_torch.runtime import check_supported, resolve_device


def main(argv=None):
    p = build_parser(__doc__)
    p.add_argument("--checkpoint", required=True,
                   help="export file or directory (embedding.npz, "
                        "embedding.vec.json or params.pt)")
    p.add_argument("--link_prediction", action="store_true")
    p.add_argument("--triple_classification", action="store_true")
    p.add_argument("--predict_tail", default=None, metavar="H,R",
                   help="top-k tails for (h, r, ?)")
    p.add_argument("--predict_head", default=None, metavar="T,R")
    p.add_argument("--predict_rel", default=None, metavar="H,T")
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (cuda or cpu)")
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    check_supported(cfg)
    device = rank_device(cfg, resolve_device(args.device))
    join_process_group(cfg, device)

    ds = load_dataset(cfg.in_path)
    model = get_model(cfg.model)
    index = build_kg_index(ds, for_eval=True)
    tables, path = read_parameters(args.checkpoint)
    params = params_from_numpy(tables, model, cfg, ds.n_ent, ds.n_rel,
                               device)
    # a grid (cli/launch.py's process group) evaluates sharded: tables
    # padded to the grid size, rows over 'model', queries over 'data'
    sharding = None
    if cfg.mesh_shape[0] * cfg.mesh_shape[1] != 1:
        from openkeonspark_tpu_torch.parallel import Sharding, make_mesh
        grid = make_mesh(cfg.mesh_shape, device)
        if grid.size > 1:
            sharding = Sharding(grid, flat=False)
            specs = model.tables(cfg, ds.n_ent, ds.n_rel)
            sharded = sharding.shard({k: torch.cat([v, v.new_zeros(
                padded_rows(specs[k].rows, grid.size) - v.shape[0],
                v.shape[1])]) for k, v in params.items()})
    echo = print if sharding is None or sharding.grid.rank == 0 \
        else (lambda *_: None)
    echo(f"restored {path} on {device}")
    if sharding is not None:
        echo(f"eval mesh: ({grid.data}, {grid.model}) ({grid.size} "
             f"devices, {grid.backend})")

    with torch.inference_mode():
        if args.link_prediction:
            if sharding is not None:
                from openkeonspark_tpu_torch.parallel.eval import \
                    sharded_link_prediction
                res = sharded_link_prediction(sharded, cfg, ds, index,
                                              sharding)
            else:
                from openkeonspark_tpu_torch.eval import link_prediction
                res = link_prediction(params, cfg, ds, index)
            echo(res.format_table())
            if cfg.type_constrain:
                from openkeonspark_tpu_torch.data import maybe_load
                tc = maybe_load(cfg.in_path)
                if tc is None:
                    echo("type_constrain.txt not found in dataset dir")
                elif sharding is not None:
                    from openkeonspark_tpu_torch.parallel.eval import \
                        sharded_type_constrained_link_prediction
                    rc = sharded_type_constrained_link_prediction(
                        sharded, cfg, ds, index, tc, sharding)
                    echo("type-constrained (sharded):")
                    echo(rc.format_table())
                else:
                    from openkeonspark_tpu_torch.eval import (
                        type_constrained_link_prediction)
                    rc = type_constrained_link_prediction(params, cfg, ds,
                                                          index, tc)
                    echo("type-constrained:")
                    echo(rc.format_table())
        if args.triple_classification:
            from openkeonspark_tpu_torch.eval import triple_classification
            if sharding is not None:
                from openkeonspark_tpu_torch.parallel.eval import \
                    ShardedTripleScorer
                out = triple_classification(
                    sharded, cfg, ds, index,
                    score_fn=ShardedTripleScorer(cfg, sharding))
            else:
                out = triple_classification(params, cfg, ds, index)
            echo("triple classification:", out)
        if sharding is not None and sharding.grid.rank != 0:
            return   # the top-k queries run on rank 0's full tables
        if args.predict_tail:
            from openkeonspark_tpu_torch.eval import predict_tail_entity
            h, r = map(int, args.predict_tail.split(","))
            ids, scores = predict_tail_entity(params, cfg, ds.n_ent,
                                              ds.n_rel, h, r, k=args.topk)
            print(f"top-{args.topk} tails for ({h}, r={r}, ?):")
            for i, s in zip(ids, scores):
                print(f"  {i}\t{s:.4f}")
        if args.predict_head:
            from openkeonspark_tpu_torch.eval import predict_head_entity
            t, r = map(int, args.predict_head.split(","))
            ids, scores = predict_head_entity(params, cfg, ds.n_ent,
                                              ds.n_rel, t, r, k=args.topk)
            print(f"top-{args.topk} heads for (?, r={r}, {t}):")
            for i, s in zip(ids, scores):
                print(f"  {i}\t{s:.4f}")
        if args.predict_rel:
            from openkeonspark_tpu_torch.eval import predict_relation
            h, t = map(int, args.predict_rel.split(","))
            ids, scores = predict_relation(params, cfg, ds.n_ent, ds.n_rel,
                                           h, t, k=args.topk)
            print(f"top-{args.topk} relations for ({h}, ?, {t}):")
            for i, s in zip(ids, scores):
                print(f"  {i}\t{s:.4f}")


if __name__ == "__main__":
    main(sys.argv[1:])
