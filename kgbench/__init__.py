"""The benchmark of ``openkeonspark_tpu_torch``, the PyTorch and CUDA port:
``python3 kgbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. See ``harness.py`` for how a cell is found and run."""
