"""Shared argparse surface.

Replaces the reference CLI (``main_spark.py:~20–90`` reconstructed per
SURVEY.md §2.1): flag names follow the reference where an equivalent
exists (``--alpha``, ``--margin``, ``--hidden_size``/``--ent_size``/
``--rel_size``, ``--nbatches``, ``--train_times``, ``--negative_ent``/
``--negative_rel``, ``--bern``, ``--opt_method``, ``--input``/``--output``,
``--num_batches`` incremental count); Spark-cluster flags (cluster_size,
num_ps, tensorboard) are replaced by the mesh/coordinator flags.

The port's own copy of ``openkeonspark_tpu/cli/args.py`` (numpy and the standard library only; the port imports nothing of the JAX package). ``tests/test_torch_copies.py`` holds the two equal.
"""

from __future__ import annotations

import argparse

from openkeonspark_tpu_torch.config import Config


def build_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    # data
    p.add_argument("--input", "--in_path", dest="in_path", required=True,
                   help="dataset dir (entity2id.txt, train2id.txt, ...)")
    p.add_argument("--output", "--out_path", dest="out_path", default="./out",
                   help="checkpoints + exports dir")
    p.add_argument("--batch_number", type=int, default=None,
                   help="incremental mode: train on <input>/<n>/, "
                        "warm-starting from batch n-1's checkpoint")
    # model
    p.add_argument("--model", default="transe",
                   choices=["transe", "transh", "transr", "transd",
                            "distmult", "complex", "rotate"])
    p.add_argument("--hidden_size", type=int, default=200)
    p.add_argument("--ent_size", type=int, default=None)
    p.add_argument("--rel_size", type=int, default=None)
    p.add_argument("--p_norm", type=int, default=1, choices=[1, 2])
    p.add_argument("--margin", type=float, default=1.0)
    # optimization
    p.add_argument("--alpha", type=float, default=0.001, help="learning rate")
    p.add_argument("--opt_method", default="sgd",
                   choices=["sgd", "adam", "adagrad", "adadelta"])
    p.add_argument("--train_times", type=int, default=100, help="epochs")
    p.add_argument("--nbatches", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=None,
                   help="override nbatches-derived batch size")
    p.add_argument("--loss_mode", default="mean_neg",
                   choices=["mean_neg", "pairwise", "self_adv"])
    # negatives
    p.add_argument("--negative_ent", type=int, default=1)
    p.add_argument("--negative_rel", type=int, default=0)
    p.add_argument("--bern", type=int, default=1, choices=[0, 1])
    p.add_argument("--sampler", default="device", choices=["device", "host"],
                   help="device = on-TPU sampling fused into the step; "
                        "host = C++ threaded sampler + prefetch pipeline")
    p.add_argument("--work_threads", type=int, default=2,
                   help="host sampler threads (reference flag name)")
    # eval / early stopping
    p.add_argument("--test_link_prediction", action="store_true")
    p.add_argument("--test_triple_classification", action="store_true")
    p.add_argument("--valid_every", type=int, default=0,
                   help="epochs between early-stop validation checks (0=off)")
    p.add_argument("--early_stop_patience", type=int, default=5)
    p.add_argument("--early_stop_min_delta", type=float, default=0.0)
    p.add_argument("--eval_chunk", type=int, default=None,
                   help="test triples per ranking chunk (default: platform)")
    p.add_argument("--eval_block", type=int, default=1024)
    p.add_argument("--eval_dtype", default="float32")
    p.add_argument("--type_constrain", action="store_true",
                   help="also report type-constrained link prediction "
                        "(needs type_constrain.txt in the dataset dir)")
    # execution
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps_per_scan", type=int, default=None,
                   help="steps fused per dispatch (default: adaptive)")
    p.add_argument("--log_every", type=int, default=1)
    p.add_argument("--log_path", default="")
    p.add_argument("--trace_dir", default="",
                   help="write a torch.profiler Chrome trace of epoch 1")
    p.add_argument("--export_format", default="json",
                   choices=["json", "npz"],
                   help="embedding export format (json = reference "
                        "embedding.vec.json parity)")
    # parallelism (replaces --cluster_size/--num_ps)
    p.add_argument("--mesh_data", type=int, default=1,
                   help="data-parallel mesh axis (triple partitions)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="model-parallel mesh axis (table row shards)")
    p.add_argument("--chips_per_host", type=int, default=None,
                   help="devices per ICI domain; grids spanning multiple "
                        "hosts route the exchange hierarchically (ICI "
                        "aggregation, one DCN crossing per host)")
    p.add_argument("--coordinator", default="",
                   help="jax.distributed coordinator addr (multi-host)")
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--process_id", type=int, default=0)
    p.add_argument("--exchange_hot_rows", type=int, default=0,
                   help="replicate the top-K highest-degree entity rows "
                        "grid-wide (numerics-exact cross-host lever; "
                        "needs --exchange_capacity stats)")
    p.add_argument("--exchange_capacity", default="uniform",
                   choices=["uniform", "stats"],
                   help="owner-bucket capacity model: 'stats' sizes from "
                        "the dataset's measured degree tables")
    p.add_argument("--exchange_wire_dtype", default="bfloat16",
                   choices=["float32", "bfloat16", "float8_e4m3fn"],
                   help="a2a payload dtype (float32 = bit-parity with "
                        "the psum step; fp8 = DCN-bound escalation)")
    p.add_argument("--exchange_ici_wire_dtype", default="float32",
                   choices=["float32", "bfloat16", "float8_e4m3fn"],
                   help="hier stage-1 (intra-host) update wire dtype")
    p.add_argument("--exchange_dedup", default="gather",
                   choices=["gather", "both", "off"])
    p.add_argument("--exchange_microbatches", type=int, default=2)
    p.add_argument("--exchange_slack", type=float, default=1.5)
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    return Config(
        model=args.model, hidden_size=args.hidden_size,
        ent_size=args.ent_size, rel_size=args.rel_size, p_norm=args.p_norm,
        margin=args.margin, alpha=args.alpha, opt_method=args.opt_method,
        train_times=args.train_times, nbatches=args.nbatches,
        batch_size=args.batch_size, loss_mode=args.loss_mode,
        negative_ent=args.negative_ent, negative_rel=args.negative_rel,
        bern=bool(args.bern), sampler=args.sampler,
        work_threads=args.work_threads,
        in_path=args.in_path, out_path=args.out_path,
        batch_number=args.batch_number,
        test_link_prediction=args.test_link_prediction,
        test_triple_classification=args.test_triple_classification,
        valid_every=args.valid_every,
        early_stop_patience=args.early_stop_patience,
        early_stop_min_delta=args.early_stop_min_delta,
        eval_chunk=args.eval_chunk, eval_block=args.eval_block,
        eval_dtype=args.eval_dtype, type_constrain=args.type_constrain,
        seed=args.seed,
        steps_per_scan=args.steps_per_scan, log_every=args.log_every,
        log_path=args.log_path, trace_dir=args.trace_dir,
        mesh_shape=(args.mesh_data, args.mesh_model),
        chips_per_host=args.chips_per_host,
        coordinator=args.coordinator, num_processes=args.num_processes,
        process_id=args.process_id,
        exchange_hot_rows=args.exchange_hot_rows,
        exchange_capacity=args.exchange_capacity,
        exchange_wire_dtype=args.exchange_wire_dtype,
        exchange_ici_wire_dtype=args.exchange_ici_wire_dtype,
        exchange_dedup=args.exchange_dedup,
        exchange_microbatches=args.exchange_microbatches,
        exchange_slack=args.exchange_slack,
    )
