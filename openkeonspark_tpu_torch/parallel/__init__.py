"""Multi-device training and evaluation on a flat (data, model) grid of
processes over ``torch.distributed`` (ROADMAP.md A12a). The hierarchical
route and hot-row replication are A12b."""

from openkeonspark_tpu_torch.parallel.mesh import (  # noqa: F401
    Grid, Sharding, hier_shape, make_mesh, shard_state, unshard_state)
from openkeonspark_tpu_torch.parallel.sharded import (  # noqa: F401
    build_sharded_train_step)
from openkeonspark_tpu_torch.parallel.exchange import (  # noqa: F401
    build_exchange_train_step, build_train_step_for, plan_sharded_step)
