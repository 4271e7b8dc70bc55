"""Port of ``repro.distributed``: fault tolerance (:mod:`.fault`) and
tensor-parallel serving — the process groups and collectives with the
int8 gradient compression hook (:mod:`.collectives`), the process-wide
serving state (:mod:`.context`) and the layout of params, tenant stacks
and KV caches (:mod:`.sharding`)."""

from repro_torch.distributed.fault import NanGuard, StragglerMonitor

__all__ = ["NanGuard", "StragglerMonitor"]
