from .mesh import make_mesh, cell_sharding, init_distributed  # noqa: F401
from .sharded import ShardedCounts, place_counts  # noqa: F401
