"""Multi-tenant serving on the paged pool or the dense slot cache, with
speculative decoding and the production lifecycle: metrics and tracing,
cancellation, deadlines, bounded intake, token buckets, DRR fairness,
seeded chaos and the SSE front end (port of ``repro.serve``)."""

from repro_torch.serve.adapters import AdapterStore
from repro_torch.serve.chaos import ChaosMonkey
from repro_torch.serve.draft import DRAFT_MODES, build_draft_params
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.frontend import ServeFrontend
from repro_torch.serve.kv_cache import KV_DTYPES, DraftKVCache, KVCache, PagedKVCache
from repro_torch.serve.sampler import Sampler
from repro_torch.serve.scheduler import (
    POLICIES,
    QueueFullError,
    RateLimitedError,
    Request,
    Scheduler,
)

__all__ = ["DRAFT_MODES", "KV_DTYPES", "POLICIES", "AdapterStore", "ChaosMonkey",
           "DraftKVCache", "KVCache", "PagedKVCache", "QueueFullError", "RateLimitedError",
           "Request", "Sampler", "Scheduler", "ServeEngine", "ServeFrontend",
           "build_draft_params"]
