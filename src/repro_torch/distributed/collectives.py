"""Collectives of tensor-parallel serving, and the int8 gradient
compression hook (port of ``repro.distributed.collectives``).

**Serving.** The port serves tensor-parallel as one process per rank, in
the Megatron style: each rank holds plain local tensors (its slice of the
base, of the tenants' stacks and of the KV pools) and calls the
hand-written kernels on its own kv-heads and columns, which is what a
``shard_map`` body does in the reference. The reference's ``tp_shard_map``
therefore has no counterpart here: under SPMD every rank already holds only
its own slice, and the kernel wrappers of :mod:`repro_torch.kernels` take
local tensors. Ranks meet only at the collectives the reference's
inventory names, per megastep: one :func:`tp_all_reduce` after ``wo`` and
one after ``wdown`` in each layer (the row-parallel partial sums), and one
:func:`tp_all_gather` of the vocab-sharded logits before the sampler.

A :class:`TPGroup` carries two process groups. The *device* group runs
those collectives: NCCL when each rank has its own GPU, gloo on the CPU
and when several ranks share one card (NCCL refuses two ranks on one
device). The *control* group is always gloo on the host: the leader
broadcasts each step's control record over it
(:mod:`repro_torch.serve.engine`). Every group has a timeout, so a dead
rank fails the run instead of hanging it.

Gloo takes CUDA tensors for ``all_reduce``, ``all_gather`` and
``broadcast`` in float32 and bf16 (checked on an H100 with PyTorch 2.11.0
for CUDA 12.8: PERF.md), so a gloo device group is given the card's
tensors as they are, as an NCCL group is.

**Training.** ``quantize``/``dequantize`` (symmetric per-tensor int8),
``EFState`` and ``ef_int8`` (error feedback: the residual of each
quantization is added to the next step's gradient) and
``collective_bytes_saved`` (the paper's dense : NeuroAda gradient traffic
ratio) are plain functions on tensors. ``ef_int8()`` returns ``(init,
apply)`` as in the reference; a :class:`~repro_torch.train.Trainer` takes
a one-argument ``grad_transform(grads) -> grads``.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.tree import map_leaves

#: seconds a collective may wait for its peers before it raises
DEFAULT_TIMEOUT = 120.0


@dataclass
class TPGroup:
    """One rank's view of a tensor-parallel group."""

    rank: int
    tp: int
    device: torch.device
    group: object  # the device collectives' process group
    control: object  # the host-side gloo group of the control records
    backend: str  # "nccl" or "gloo": the device group's backend

    @property
    def leader(self) -> bool:
        return self.rank == 0

    def describe(self) -> str:
        return f"rank {self.rank} of {self.tp} on {self.device}, {self.backend}"


def device_backend(device: torch.device, tp: int) -> str:
    """NCCL when each of the ``tp`` ranks has a GPU of its own, gloo on the
    CPU and when ranks must share a card."""
    if device.type == "cuda" and torch.cuda.device_count() >= tp:
        return "nccl"
    return "gloo"


def init_tp(rank: int, tp: int, device, init_method: str, *,
            timeout: float = DEFAULT_TIMEOUT) -> TPGroup:
    """Join the ``tp`` ranks at ``init_method`` (``file://`` or
    ``tcp://localhost:<port>``) as ``rank``; the device group's backend is
    :func:`device_backend`'s. Call :func:`close_tp` at the end."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = device_backend(device, tp)
    td = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method, world_size=tp, rank=rank,
                            timeout=td)
    control = dist.new_group(backend="gloo", timeout=td)
    return TPGroup(rank, tp, device, dist.group.WORLD, control, backend)


def close_tp() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def tp_all_reduce(x: torch.Tensor, group: TPGroup) -> torch.Tensor:
    """Sum ``x`` over the group's ranks, in place (the reference's
    ``tp_psum``); every rank gets the same bits. Returns ``x``."""
    dist.all_reduce(x, group=group.group)
    return x


def tp_all_gather(x: torch.Tensor, group: TPGroup, dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (the
    reference's tiled ``all_gather``)."""
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(group.tp)]
    dist.all_gather(parts, src, group=group.group)
    return torch.cat(parts, dim=dim)


def _rank_main(fn, rank: int, tp: int, init_method: str, results, args) -> None:
    try:
        # pickled here, by value: a queue would hand tensors over in shared
        # memory, which dies with this process
        results.put((rank, True, pickle.dumps(fn(rank, tp, init_method, *args))))
    except Exception:  # handed to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, tp: int, *args, timeout: float = 600.0) -> list:
    """Run ``fn(rank, tp, init_method, *args)`` in ``tp`` spawned processes
    that meet at a ``file://`` rendezvous in a temporary directory, and
    return their results in rank order. ``fn`` must be importable by name
    (a module's top-level function) and its result picklable; it calls
    :func:`init_tp` itself. A rank that raises or dies, or a run past
    ``timeout`` seconds, raises here, and every process is ended before
    this returns."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, args=(fn, r, tp, init_method, results, args))
                 for r in range(tp)]
        for p in procs:
            p.start()
        end = time.monotonic() + timeout
        gone = False  # a rank had exited at the last empty read
        try:
            while len(out) < tp:
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if r not in out and not p.is_alive()]
                    if dead and gone:  # one more read for a result already sent
                        raise RuntimeError(f"ranks {dead} exited without a result "
                                           f"(exit codes {[procs[r].exitcode for r in dead]})")
                    gone = bool(dead)
                    if time.monotonic() > end:
                        raise TimeoutError(f"{tp} ranks of {fn.__name__} ran past {timeout} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {fn.__name__} failed:\n{payload}")
                out[rank] = pickle.loads(payload)
        finally:
            for p in procs:
                p.join(10.0)
                if p.is_alive():
                    p.terminate()
                    p.join()
    return [out[r] for r in range(tp)]


def broadcast_record(record, group: TPGroup):
    """The leader's ``record`` (any picklable object) on every rank, over
    the host-side control group."""
    box = [record if group.leader else None]
    dist.broadcast_object_list(box, src=0, group=group.control)
    return box[0]


# ------------------------------------------------- gradient compression


class EFState(NamedTuple):
    residual: object  # error-feedback accumulator, same tree as the gradients


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: ``(q, scale)`` with ``scale = max(absmax,
    1e-12) / 127`` and ``q = round(x / scale)`` (half to even) clipped to
    ±127."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def ef_int8():
    """Error-feedback int8 gradient transform: ``(init, apply)`` with
    ``init(grads) -> EFState`` and ``apply(grads, state) -> (grads,
    state)``; ``None`` leaves stay ``None``."""

    def init(grads):
        return EFState(map_leaves(
            lambda g: None if g is None else torch.zeros(g.shape, dtype=torch.float32,
                                                         device=g.device), grads))

    def apply(grads, state: EFState):
        def one(g, r):
            if g is None:
                return None, None
            corrected = g.float() + r
            deq = dequantize(*quantize(corrected))
            return deq.to(g.dtype), corrected - deq

        pairs = map_leaves(one, grads, state.residual)
        out = map_leaves(lambda p: p[0], pairs)
        res = map_leaves(lambda p: p[1], pairs)
        return out, EFState(res)

    return init, apply


def collective_bytes_saved(k: int, d_in: int) -> float:
    """The paper's ratio applied to data-parallel traffic: dense vs NeuroAda
    gradients."""
    return d_in / k
