from .mesh import default_data_mesh, make_host_chip_mesh, make_mesh  # noqa: F401
from .serve import ShardServer  # noqa: F401
from .sharded import (  # noqa: F401
    ShardedFlatIndex,
    ShardedIVFIndex,
    ShardedIVFPQIndex,
    sharded_ivf_search_2level,
    sharded_ivf_search_program,
    sharded_ivf_sq8_search_program,
    sharded_kmeans_step,
    sharded_pq_search_program,
    sharded_search_2d,
    sharded_search_2level,
    sharded_search_kernels,
    sharded_search_program,
)
