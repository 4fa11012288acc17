from openkeonspark_tpu_torch.models.base import (KGEModel,  # noqa: F401
                                                 TableSpec, get_model,
                                                 init_tables, padded_rows,
                                                 strip_padding)
from openkeonspark_tpu_torch.models.rotate import RotatE  # noqa: F401
from openkeonspark_tpu_torch.models.transd import TransD  # noqa: F401
from openkeonspark_tpu_torch.models.transe import TransE  # noqa: F401
from openkeonspark_tpu_torch.models.transh import TransH  # noqa: F401
from openkeonspark_tpu_torch.models.transr import TransR  # noqa: F401
