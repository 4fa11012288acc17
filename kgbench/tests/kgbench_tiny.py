"""Small sizes at which the benchmark's tests run every cell on the CPU,
through the port's plain PyTorch paths."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CONFIG = {"n_ent": 300, "n_rel": 12, "n_train": 4000, "n_valid": 100,
          "n_test": 200, "hidden_size": 16, "ent_size": 16, "rel_size": 16,
          "nbatches": 20, "steps_per_scan": 5, "eval_chunk": 64}
MIX = {"queries": 256, "warm": 4, "trace_units": 3}
OVERRIDES = {"config": CONFIG, "mix": MIX}
CELLS = ("transe_d200_fb15k237.train", "transr_d200_fb15k237.train_grouped",
         "transe_d200_fb15k237.linkpred", "transe_d200_fb15k237.topk")
SEED = (1 << 31) + 12345


def run_tiny(cell, trace=False, seconds=0.3, **kw):
    from kgbench.harness import execute
    return execute(cell, SEED, seconds, trace, "cpu", overrides=OVERRIDES,
                   **kw)
