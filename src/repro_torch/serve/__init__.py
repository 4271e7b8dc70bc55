"""Paged multi-tenant serving (port of ``repro.serve``)."""

from repro_torch.serve.adapters import AdapterStore
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.serve.sampler import Sampler
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["AdapterStore", "PagedKVCache", "Request", "Sampler", "Scheduler", "ServeEngine"]
