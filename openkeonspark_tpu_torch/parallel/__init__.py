"""Multi-device training and evaluation over ``torch.distributed``: the
flat (data, model) grid (ROADMAP.md A12a) and the hierarchical (host,
data, model) grid with hot-row replication and degree-table capacities
(A12b)."""

from openkeonspark_tpu_torch.parallel.mesh import (  # noqa: F401
    Grid, Sharding, hier_shape, make_mesh, shard_state, unshard_state)
from openkeonspark_tpu_torch.parallel.sharded import (  # noqa: F401
    build_sharded_train_step)
from openkeonspark_tpu_torch.parallel.exchange import (  # noqa: F401
    build_exchange_train_step, build_train_step_for, plan_sharded_step)
from openkeonspark_tpu_torch.parallel.hier import (  # noqa: F401
    build_hier_train_step)
from openkeonspark_tpu_torch.parallel.hot import (  # noqa: F401
    HOT_SUFFIX, HotPlan, degree_stats, flat_stats_caps, init_hot_params,
    sync_hot_cache)
