from .engine import GenerationResult, ServeEngine
from .faults import Fault, FaultPlan
from .kv_cache import (BlockAllocator, CacheFullError, DeviceSlotState,
                       ROOT_DIGEST, SPEC_STATE_KEYS, StateStore, chain_digest)
from .net import QueryResult, TensorQueryClient, TensorQueryServer
from .scheduler import LANES, SchedRequest, Scheduler
from .steps import (greedy_sample, logits_to_probs, make_dense_burst,
                    make_paged_burst, make_paged_mixed_step,
                    make_paged_spec_burst, make_paged_spec_mixed_step,
                    make_sampler_core, make_slot_sampler, sample_logits,
                    spec_accept)

__all__ = ["ServeEngine", "GenerationResult", "Fault", "FaultPlan",
           "BlockAllocator", "CacheFullError", "DeviceSlotState",
           "ROOT_DIGEST", "SPEC_STATE_KEYS", "StateStore", "chain_digest",
           "QueryResult", "TensorQueryClient", "TensorQueryServer", "LANES",
           "SchedRequest", "Scheduler", "greedy_sample", "logits_to_probs",
           "make_dense_burst", "make_paged_burst", "make_paged_mixed_step",
           "make_paged_spec_burst", "make_paged_spec_mixed_step",
           "make_sampler_core", "make_slot_sampler", "sample_logits",
           "spec_accept"]
