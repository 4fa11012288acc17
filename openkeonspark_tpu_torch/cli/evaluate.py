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

Models: transe, transh, transd, rotate, and transr (``--ent_size`` /
``--rel_size``); the ``--predict_*`` queries cover all but transr. TransH
ranks relation by relation through the TransE count kernel, or, with
``OKST_EVAL_TRANSH_KERNEL=1``, chunk by chunk through its own kernel.
"""

from __future__ import annotations

import sys

import torch

from openkeonspark_tpu.cli.args import build_parser, config_from_args
from openkeonspark_tpu.data.dataset import load_dataset
from openkeonspark_tpu.data.index import build_kg_index
from openkeonspark_tpu_torch.ckpt import params_from_numpy, read_parameters
from openkeonspark_tpu_torch.models.base import get_model
from openkeonspark_tpu_torch.runtime import (check_predict_supported,
                                             check_supported, resolve_device)


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
    if args.predict_tail or args.predict_head or args.predict_rel:
        check_predict_supported(cfg)
    device = resolve_device(args.device)

    ds = load_dataset(cfg.in_path)
    model = get_model(cfg.model)
    index = build_kg_index(ds, for_eval=True)
    tables, path = read_parameters(args.checkpoint)
    params = params_from_numpy(tables, model, cfg, ds.n_ent, ds.n_rel,
                               device)
    print(f"restored {path} on {device}")

    with torch.inference_mode():
        if args.link_prediction:
            from openkeonspark_tpu_torch.eval import link_prediction
            print(link_prediction(params, cfg, ds, index).format_table())
        if args.triple_classification:
            from openkeonspark_tpu_torch.eval import triple_classification
            print("triple classification:",
                  triple_classification(params, cfg, ds, index))
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
