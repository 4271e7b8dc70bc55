"""The process-wide tensor-parallel serving state (port of the serving part
of ``repro.distributed.context``).

A sharded :class:`~repro_torch.serve.ServeEngine` sets it around each step
and restores what was there afterwards (the reference's ``_sharded_call``),
so a tp = 1 engine or a trainer in the same process sees none of it. The
model's serving forwards and the kernel dispatch of
:mod:`repro_torch.kernels.ops` read it: with a live group of tp > 1 they use
the local heads and columns, meet at the collectives, and launch the
kernels through their TP wrappers. ``heads`` holds the model's global
``(num_heads, num_kv_heads)``: the wrappers see only local tensors and
check the local head counts against them.

The reference's ``constrain``, ``constrain_moe``, ``constrain_inner``,
``constrain_kv`` and ``constrain_kv_scale`` are GSPMD layout hints and have
no counterpart: every rank here holds its own slice as a plain tensor.
"""

from __future__ import annotations

_SERVE = {"group": None, "tp": 1, "rank": 0, "heads": None}


def snapshot() -> dict:
    """A copy of the serving state, for :func:`restore`."""
    return dict(_SERVE)


def restore(state: dict) -> None:
    _SERVE.update({k: state[k] for k in _SERVE})


def set_serve_group(group, heads: tuple[int, int] | None = None) -> None:
    """Make ``group`` (a :class:`~repro_torch.distributed.collectives.TPGroup`,
    or None) the live serving group; ``heads`` is the model's global
    ``(num_heads, num_kv_heads)``."""
    if group is None:
        clear_serve_group()
        return
    _SERVE.update(group=group, tp=group.tp, rank=group.rank, heads=heads)


def clear_serve_group() -> None:
    _SERVE.update(group=None, tp=1, rank=0, heads=None)


def serve_group():
    return _SERVE["group"]


def serve_tp() -> int:
    return _SERVE["tp"]


def serve_rank() -> int:
    return _SERVE["rank"]


def serve_heads() -> tuple[int, int] | None:
    return _SERVE["heads"]
