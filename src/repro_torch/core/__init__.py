"""Block-pool IVF with online insertion (paper §3), in PyTorch."""

from repro_torch.core.block_pool import (  # noqa: F401
    IVFState,
    PoolConfig,
    check_invariants,
    dead_fraction,
    init_state,
    pool_stats,
    snapshot_ids,
    utilisation,
)
from repro_torch.core.insert import (  # noqa: F401
    assign_clusters,
    insert_payload,
    make_insert_fn,
)
from repro_torch.core.ivf import IVFIndex, IVFIndexConfig, build_ivf  # noqa: F401
from repro_torch.core.kmeans import kmeans  # noqa: F401
from repro_torch.core.search import (  # noqa: F401
    exact_search,
    make_search_fn,
    search_union_fused,
)
