from pytorch_distributed_tpu_torch.serving.engine import (
    ChunkJob,
    PagedEngine,
    PendingSwap,
    PrefixHit,
)
from pytorch_distributed_tpu_torch.serving.kv_pool import (
    KV_DTYPES,
    TRASH_BLOCK,
    BlockAllocator,
    HostBlockStore,
    HostChain,
    PrefixIndex,
    blocks_needed,
    blocks_needed_suffix,
    init_paged_cache,
    pool_block_bytes,
)
from pytorch_distributed_tpu_torch.serving.scheduler import Request, Scheduler

__all__ = ["BlockAllocator", "ChunkJob", "HostBlockStore", "HostChain", "KV_DTYPES",
           "PagedEngine", "PendingSwap", "PrefixHit", "PrefixIndex", "Request",
           "Scheduler", "TRASH_BLOCK", "blocks_needed", "blocks_needed_suffix",
           "init_paged_cache", "pool_block_bytes"]
