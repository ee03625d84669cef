from .mesh import (active_mesh, cycle_mesh, maybe_shard, shard_mle,
                   unshard_mle, use_mesh)
