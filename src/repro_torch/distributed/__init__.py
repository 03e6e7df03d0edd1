"""Distribution of the port on ``torch.distributed``, counterpart of
``repro/distributed``: the mesh context, the sharding rules, the
expert-parallel all-to-all routing (``a2a_routing``)."""
from .api import (  # noqa: F401
    constrain,
    current_mesh,
    logical_to_physical,
    set_mesh,
    spec,
    use_mesh,
)
from .sharding import (  # noqa: F401
    ShardingOptions,
    abstract_params,
    batch_sharding,
    distribute_tree,
    param_specs,
    tree_shardings,
)
