"""Block-pool IVF (flat and PQ payloads) with online insertion (paper §3),
in PyTorch."""

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
from repro_torch.core.mutate import (  # noqa: F401
    REPLAY_KINDS,
    apply_delete,
    last_occurrence_mask,
    make_delete_fn,
    make_replay_fns,
    make_update_fn,
)
from repro_torch.core.pq import (  # noqa: F401
    PQParams,
    pq_from_host,
    pq_score_fn,
    train_pq,
)
from repro_torch.core.rearrange import (  # noqa: F401
    exceed,
    make_rearrange_fn,
    rearrange_cluster,
)
from repro_torch.core.search import (  # noqa: F401
    exact_search,
    make_search_fn,
    search_block_table,
    search_chain_walk,
    search_union_fused,
)
