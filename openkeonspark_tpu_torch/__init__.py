"""openkeonspark_tpu_torch — the PyTorch / CUDA port of openkeonspark_tpu.

The JAX package ``openkeonspark_tpu`` is the reference; this package mirrors
its module names (``models/``, ``eval/``, ``ops/``, ``ckpt/``, ``cli/``) and
keeps its parameter layout at every public function: a dict
``{table_name: [rows + pad, dim]}`` with one zero pad row. The numpy-only
parts of the reference (``data``, ``config.Config``, ``cli.args``) are
reused by import, never copied. The package imports ``torch`` and never
``jax``.

Ported so far: evaluation ("serving") for TransE, TransH, TransR, TransD
and RotatE — link prediction, triple classification and, for all but
TransR, the top-k ``predict_*`` queries — driven by
``python -m openkeonspark_tpu_torch.cli.evaluate``, and training for the
same five models (sampler, losses, sparse SGD and lazy Adam / Adagrad /
Adadelta, epoch loop, checkpoints) driven by
``python -m openkeonspark_tpu_torch.cli.train``. The kernels are
hand-written CUDA: the rank counts of TransE, TransH, TransD and RotatE
(``ops/csrc/rank_count*.cu``), TransR's relation-grouped projection,
forward and backward (``ops/csrc/grouped_project.cu``), and the sorted-run
scatter-add into wide rows (``ops/csrc/scatter_rows.cu``).
"""

__version__ = "0.1.0"
