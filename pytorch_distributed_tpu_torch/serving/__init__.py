from pytorch_distributed_tpu_torch.serving.engine import ChunkJob, PagedEngine
from pytorch_distributed_tpu_torch.serving.kv_pool import (
    TRASH_BLOCK,
    BlockAllocator,
    blocks_needed,
    init_paged_cache,
)
from pytorch_distributed_tpu_torch.serving.scheduler import Request, Scheduler

__all__ = ["BlockAllocator", "ChunkJob", "PagedEngine", "Request", "Scheduler",
           "TRASH_BLOCK", "blocks_needed", "init_paged_cache"]
