"""openkeonspark_tpu_torch — the PyTorch / CUDA port of openkeonspark_tpu.

The JAX package ``openkeonspark_tpu`` is the reference; this package mirrors
its module names (``models/``, ``eval/``, ``ops/``, ``ckpt/``, ``cli/``,
``compat.py``) and keeps its parameter layout at every public function: a
dict ``{table_name: [rows + pad, dim]}`` with one zero pad row. The
numpy-only parts of the reference (``data``, ``config.Config``,
``cli.args``) are copied, held equal by ``tests/test_torch_copies.py``.
The package imports ``torch`` and never ``jax`` nor the JAX package.

Ported: all seven models' serving (link prediction, also
type-constrained, triple classification, the top-k ``predict_*``
queries), through ``python -m openkeonspark_tpu_torch.cli.evaluate``, and
their training (sampler, losses, sparse SGD and lazy Adam / Adagrad /
Adadelta, epoch loop, checkpoints, the incremental mode), through
``python -m openkeonspark_tpu_torch.cli.train`` and the OpenKE-style
facade ``compat.Config``; fp32 or bf16 tables and eval dtype. The kernels
are hand-written CUDA: the rank counts of TransE, TransH, TransD and
RotatE with their id scorers (``ops/csrc/rank_count*.cu``,
``rank_ids.cuh``), TransR's relation-grouped projection, forward and
backward (``ops/csrc/grouped_project.cu``), and the sorted-run scatter-add
into wide rows, fp32 and bf16 (``ops/csrc/scatter_rows.cu``).
"""

__version__ = "0.1.0"
