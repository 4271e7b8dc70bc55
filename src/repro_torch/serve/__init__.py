"""Multi-tenant serving on the paged pool or the dense slot cache (port of
``repro.serve``)."""

from repro_torch.serve.adapters import AdapterStore
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kv_cache import KV_DTYPES, KVCache, PagedKVCache
from repro_torch.serve.sampler import Sampler
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["KV_DTYPES", "AdapterStore", "KVCache", "PagedKVCache", "Request", "Sampler", "Scheduler", "ServeEngine"]
