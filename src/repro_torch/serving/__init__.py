from .engine import GenerationResult, ServeEngine
from .faults import Fault, FaultPlan
from .kv_cache import (BlockAllocator, CacheFullError, DeviceSlotState,
                       ROOT_DIGEST, StateStore, chain_digest)
from .net import QueryResult, TensorQueryClient, TensorQueryServer
from .scheduler import LANES, SchedRequest, Scheduler
from .steps import greedy_sample, make_paged_burst, make_paged_mixed_step

__all__ = ["ServeEngine", "GenerationResult", "Fault", "FaultPlan",
           "BlockAllocator", "CacheFullError", "DeviceSlotState",
           "ROOT_DIGEST", "StateStore", "chain_digest", "QueryResult",
           "TensorQueryClient", "TensorQueryServer", "LANES",
           "SchedRequest", "Scheduler", "greedy_sample", "make_paged_burst",
           "make_paged_mixed_step"]
