from .engine import GenerationResult, ServeEngine
from .kv_cache import (BlockAllocator, CacheFullError, DeviceSlotState,
                       ROOT_DIGEST, chain_digest)
from .scheduler import LANES, SchedRequest, Scheduler
from .steps import greedy_sample, make_paged_burst, make_paged_mixed_step

__all__ = ["ServeEngine", "GenerationResult", "BlockAllocator",
           "CacheFullError", "DeviceSlotState", "ROOT_DIGEST",
           "chain_digest", "LANES", "SchedRequest", "Scheduler",
           "greedy_sample", "make_paged_burst", "make_paged_mixed_step"]
