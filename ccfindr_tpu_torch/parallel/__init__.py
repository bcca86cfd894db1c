from .mesh import make_mesh, cell_sharding, init_distributed  # noqa: F401
from .schedule import (partition_items, rank_run_grid,  # noqa: F401
                       gather_results)
from .sharded import ShardedCounts, place_counts  # noqa: F401
