"""Dataset IO, group indexes and synthetic KGs: the reference package's
numpy-only ``openkeonspark_tpu.data`` modules, reused by import (they load
no jax) and re-exported here so the port's callers name one package."""

from openkeonspark_tpu.data.dataset import (H, R, T, Dataset,  # noqa: F401
                                            load_dataset, save_dataset)
from openkeonspark_tpu.data.index import (GroupIndex, KGIndex,  # noqa: F401
                                          build_kg_index)
from openkeonspark_tpu.data.synth import (fb15k237_like,  # noqa: F401
                                          fb15k_like, planted_kg, random_kg,
                                          wn18rr_like)
