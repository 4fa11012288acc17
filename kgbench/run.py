"""Run one cell of the benchmark of ``openkeonspark_tpu_torch`` once.

    python3 kgbench/run.py --workload <cell> --seed <n> --seconds <s>
                           --trace <0|1>

from the root of a checkout. Prints the result as the last line of
standard output, and each compared number beside its limit as the last
lines of standard error. Exits with 2 and prints no result without the
CUDA devices the cell needs, and with 3 if the run loaded JAX or the JAX
package. The kernels' build and the CUDA and PyTorch kernel caches stay
under ``build/`` in the checkout."""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "kgbench-cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
sys.path[0] = str(ROOT)      # not kgbench/, whose names are not top level

from kgbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
