"""Central run configuration.

Replaces the reference's three-tier flag system (SURVEY.md §5 "Config /
flag system"): argparse flags in ``main_spark.py`` → ``Config`` attribute
setters (``Config.py:~10–140`` reconstructed) → C++ globals in
``base/Setting.h``. Here it is one frozen dataclass consumed by every layer;
the CLI (``cli/train.py``) populates it from argparse with flag names kept
compatible with the reference where they exist.

The port's own copy of ``openkeonspark_tpu/config.py``'s ``Config``: the
same fields, defaults, validation and helpers, so that both packages read
one flag set the same way (``tests/test_torch_copies.py`` holds them
equal). It leaves out the reference's ``eval_chunk_size`` property, which
asks jax for the backend; the port resolves the chunk with
:func:`openkeonspark_tpu_torch.runtime.eval_chunk_size`. Fields that only
the JAX package acts on (meshes, exchange, scan depth, Pallas switches)
are kept so that the flag set stays one; the port's CLIs refuse the ones it
has not ported.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class Config:
    # --- model ---------------------------------------------------------
    model: str = "transe"  # transe|transh|transr|transd|distmult|complex|rotate
    hidden_size: int = 200           # embedding dim d (ent_size == rel_size)
    ent_size: Optional[int] = None   # TransR: entity dim d_e (default hidden_size)
    rel_size: Optional[int] = None   # TransR: relation dim d_r (default hidden_size)
    p_norm: int = 1                  # score norm: 1 (reference default) or 2
    margin: float = 1.0              # γ in the margin-ranking loss

    # --- optimization --------------------------------------------------
    alpha: float = 0.001             # learning rate (reference name)
    opt_method: str = "sgd"          # sgd | adam | adagrad | adadelta
    #   (stateful ones are lazy/sparse: state updated at touched rows only,
    #   matching the reference's TF IndexedSlices applies)
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    adagrad_init_acc: float = 1e-20  # reference Config.py passes
    #   initial_accumulator_value=1e-20 to tf.train.AdagradOptimizer
    adadelta_rho: float = 0.95       # TF1 AdadeltaOptimizer defaults
    adadelta_eps: float = 1e-8
    train_times: int = 100           # epochs (reference name)
    nbatches: int = 100              # batches per epoch; batch_size = T // nbatches
    batch_size: Optional[int] = None  # set explicitly to override nbatches
    loss_mode: str = "mean_neg"      # "mean_neg": one hinge per positive against the
                                     # mean negative score (reference TransE.py loss_def
                                     # semantics); "pairwise": hinge per (pos, neg) pair;
                                     # "self_adv": RotatE-paper self-adversarial sigmoid
                                     # loss (beyond-parity; the route that makes rotation
                                     # models generalize — train/loss.py)

    # --- negative sampling --------------------------------------------
    negative_ent: int = 1            # corrupted-entity negatives per positive
    negative_rel: int = 0            # corrupted-relation negatives per positive
    bern: bool = True                # Bernoulli head/tail corruption choice
    sampler: str = "device"          # device (on-TPU, default) | host (C++ ctypes)
    work_threads: int = 2            # host sampler threads (reference name)

    # --- data / paths --------------------------------------------------
    in_path: str = ""                # dataset dir (entity2id.txt, train2id.txt, ...)
    out_path: str = ""               # checkpoints + exports
    batch_number: Optional[int] = None  # incremental mode: train on <in_path>/<n>/,
                                        # warm-starting from batch n-1's checkpoint

    # --- evaluation / early stopping -----------------------------------
    test_link_prediction: bool = False
    test_triple_classification: bool = False
    valid_every: int = 0             # epochs between validation accuracy checks (0=off)
    early_stop_patience: int = 5     # checks without improvement before stopping
    early_stop_min_delta: float = 0.0
    eval_chunk: Optional[int] = None  # test triples ranked per scanned
    #   chunk; None = platform/model default (TPU: 256 for the generic/
    #   kernel eval paths, 512 for the relation-grouped transh/transr;
    #   256 elsewhere — r4 pinned-protocol sweeps, BASELINE.md §5)
    eval_block: int = 1024           # candidate entities per scoring block
    eval_group_elems: int = 1 << 25  # known-matrix elements per dispatch
    #   group (queries × k_max); bounds host/device memory for huge splits
    type_constrain: bool = False     # type-constrained eval if type_constrain.txt exists

    # --- execution ------------------------------------------------------
    seed: int = 0
    steps_per_scan: Optional[int] = None  # train steps fused into one
    #   lax.scan host call; None = adaptive (see scan_group_size): small
    #   batches fuse deeper so per-dispatch latency (severe through
    #   remote-attached TPUs) amortizes — config #1 (B=400) measured
    #   0.69M t/s at 50 and >5M at 800
    dtype: str = "float32"           # table dtype
    eval_dtype: str = "float32"      # scoring dtype at eval ("bfloat16" for speed)
    use_pallas_eval: bool = True     # blocked Pallas rank kernel when available
    grouped_transr: bool = True      # TransR training via the relation-
    #   grouped projection kernel (ops/pallas_grouped.py): sort the batch
    #   by relation, stream each projection matrix once, dense MXU dM —
    #   replaces the per-row [dₑ×dᵣ] gather/einsum/wide-scatter path
    #   (2.2× measured: 15.75→7.19 ms/step at config #4, BASELINE.md).
    #   TPU-only; single-device step with entity negatives (falls back
    #   otherwise)

    # --- parallelism ----------------------------------------------------
    mesh_shape: Tuple[int, int] = (1, 1)   # (data, model) mesh axes
    chips_per_host: Optional[int] = None   # devices per ICI domain (host).
    #   When set and the grid spans multiple hosts, the exchange step runs
    #   the HIERARCHICAL two-stage route (parallel/hier.py): requests and
    #   updates aggregate within a host over ICI and cross DCN once per
    #   host — the ≥80%-at-2-hosts lever (BASELINE.md §6). None = flat
    #   single-stage routing (correct for any mesh inside one ICI domain)
    coordinator: str = ""            # jax.distributed coordinator addr (multi-host)
    num_processes: int = 1
    process_id: int = 0
    sharded_step: str = "exchange"   # exchange (owner-directed boundary
    #   exchange over the FLAT data×model grid, parallel/exchange.py) |
    #   psum (legacy full-row broadcast, tables sharded over 'model' only)
    exchange_slack: float = 1.5      # owner-bucket capacity = slack × the
    #   expected per-owner share (expected UNIQUE ids when dedup is on);
    #   overflow beyond it takes the exact cond-gated fallback
    exchange_microbatches: int = 2   # sub-batch chunks with independent
    #   exchange→score chains (comm/compute overlap); 1 disables
    exchange_wire_dtype: str = "bfloat16"  # dtype of rows/grads ON THE WIRE
    #   (a2a payloads); accumulation stays float32 at the receiver.
    #   bfloat16 halves exchange traffic (the scaling-efficiency lever,
    #   BASELINE.md); set "float32" for bit-parity with the psum step.
    #   "float8_e4m3fn" halves it AGAIN (~12.5% per-element resolution,
    #   ~1% on d=200 score sums) — an opt-in for DCN-bound meshes; its
    #   quality envelope is bounded by tests/test_exchange.py's fp8 test
    exchange_ici_wire_dtype: str = "float32"  # hierarchical step only:
    #   dtype of the stage-1 (intra-host ICI) update route. float32
    #   (default) keeps ONE quantization point (the DCN hop); bfloat16
    #   halves the hier step's ICI bytes — its predicted bottleneck at
    #   8 devices (BASELINE.md §6) — at the cost of double quantization
    #   of update rows (ICI bf16 → f32 relay aggregation → DCN bf16)
    exchange_hot_rows: int = 0       # replicate the top-K highest-degree
    #   entity rows grid-wide (parallel/hot.py): gathers of hot ids become
    #   local cache reads, their gradients one dense psum (ICI-reduced,
    #   one DCN crossing per host) — the numerics-exact cross-host lever
    #   that clears the 80% target at 4 DCN hosts (BASELINE.md §6).
    #   Requires exchange_capacity='stats'; 0 disables. Hierarchical
    #   (host,data,model) meshes only
    exchange_capacity: str = "uniform"  # owner-bucket capacity model:
    #   "uniform" (birthday estimate over uniform ids — the r2–r4
    #   behavior) | "stats" (sized from the dataset's measured degree
    #   tables: slack × max expected bucket load; honest about Zipf +
    #   placement skew, tighter where uniform was loose — parallel/hot.py)
    exchange_dedup: str = "gather"   # "gather" (default): route each
    #   DISTINCT row id once per gather exchange (sort+rank on device,
    #   cheap); "both": also pre-aggregate duplicate update rows before
    #   routing (adds a wide segment-sum scatter ≈ one extra update-stream
    #   scatter pass — pays off only when duplicates are heavy); "off"

    # --- logging --------------------------------------------------------
    log_every: int = 1               # epochs between loss prints
    log_path: str = ""               # jsonl structured log (empty = stdout only)
    trace_dir: str = ""              # torch.profiler trace of epoch 1 (empty = off)

    def __post_init__(self):
        if self.model not in ("transe", "transh", "transr", "transd",
                              "distmult", "complex", "rotate"):
            raise ValueError(f"unknown model {self.model!r}")
        if self.opt_method.lower() not in ("sgd", "adam", "adagrad",
                                           "adadelta"):
            raise ValueError(f"unknown opt_method {self.opt_method!r}")
        if self.p_norm not in (1, 2):
            raise ValueError("p_norm must be 1 or 2")
        if self.loss_mode not in ("mean_neg", "pairwise", "self_adv"):
            raise ValueError(f"unknown loss_mode {self.loss_mode!r}")
        if self.sampler not in ("device", "host"):
            raise ValueError(f"unknown sampler {self.sampler!r}")
        if self.sharded_step not in ("exchange", "psum"):
            raise ValueError(f"unknown sharded_step {self.sharded_step!r}")
        if self.exchange_microbatches < 1:
            raise ValueError("exchange_microbatches must be >= 1")
        wire_dts = ("float32", "bfloat16", "float8_e4m3fn")
        if self.exchange_wire_dtype not in wire_dts:
            raise ValueError(
                f"unknown exchange_wire_dtype {self.exchange_wire_dtype!r}")
        if self.exchange_ici_wire_dtype not in wire_dts:
            raise ValueError(
                f"unknown exchange_ici_wire_dtype "
                f"{self.exchange_ici_wire_dtype!r}")
        if self.exchange_dedup not in ("gather", "both", "off"):
            raise ValueError(
                f"unknown exchange_dedup {self.exchange_dedup!r}")
        if self.exchange_capacity not in ("uniform", "stats"):
            raise ValueError(
                f"unknown exchange_capacity {self.exchange_capacity!r}")
        if self.exchange_hot_rows < 0:
            raise ValueError("exchange_hot_rows must be >= 0")
        if self.exchange_hot_rows and self.exchange_capacity != "stats":
            raise ValueError("exchange_hot_rows requires "
                             "exchange_capacity='stats' (capacities must "
                             "account for the absorbed hot mass)")
        if self.chips_per_host is not None and self.chips_per_host < 1:
            raise ValueError("chips_per_host must be >= 1")

    def scan_group_size(self, batch_size: int) -> int:
        """Steps fused per device dispatch: explicit ``steps_per_scan`` or
        an adaptive target of ~128k positives per dispatch (≥50 steps),
        so per-call latency stays a rounding error at any batch size."""
        if self.steps_per_scan is not None:
            return max(1, self.steps_per_scan)
        return max(50, -(-131072 // max(1, batch_size)))

    @property
    def d_ent(self) -> int:
        return self.ent_size if self.ent_size is not None else self.hidden_size

    @property
    def d_rel(self) -> int:
        return self.rel_size if self.rel_size is not None else self.hidden_size

    @property
    def neg_total(self) -> int:
        return self.negative_ent + self.negative_rel

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def resolve_batch_size(self, train_total: int) -> int:
        """batch_size from nbatches as the reference does (Config.py:~90)."""
        if self.batch_size is not None:
            return self.batch_size
        return max(1, train_total // self.nbatches)
