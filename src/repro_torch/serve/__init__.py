"""Multi-tenant serving on the paged pool or the dense slot cache, with
speculative decoding (port of ``repro.serve``)."""

from repro_torch.serve.adapters import AdapterStore
from repro_torch.serve.draft import DRAFT_MODES, build_draft_params
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kv_cache import KV_DTYPES, DraftKVCache, KVCache, PagedKVCache
from repro_torch.serve.sampler import Sampler
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["DRAFT_MODES", "KV_DTYPES", "AdapterStore", "DraftKVCache", "KVCache", "PagedKVCache",
           "Request", "Sampler", "Scheduler", "ServeEngine", "build_draft_params"]
