"""Dataset IO, group indexes, synthetic KGs and type constraints: the
port's own copies of the reference package's numpy modules (``dataset``,
``index``, ``synth``, ``type_constrain``), re-exported here so the port's
callers name one package."""

from openkeonspark_tpu_torch.data.dataset import (  # noqa: F401
    H, R, T, Dataset, load_dataset, save_dataset)
from openkeonspark_tpu_torch.data.index import (  # noqa: F401
    GroupIndex, KGIndex, build_group_index, build_kg_index)
from openkeonspark_tpu_torch.data.synth import (  # noqa: F401
    fb15k237_like, fb15k_like, planted_kg, random_kg, wn18rr_like)
from openkeonspark_tpu_torch.data.type_constrain import (  # noqa: F401
    TypeConstraints, build_type_constraints, load_type_constraints,
    maybe_load, save_type_constraints)
