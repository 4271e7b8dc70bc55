"""Tensor-parallel layout of params, tenant stacks and KV caches (port of
the model-axis part of ``repro.distributed.sharding``).

The reference gives each leaf a ``PartitionSpec`` and lets GSPMD place it.
Here every rank holds plain local tensors, so the rules become functions
that name each leaf's split dimension (or None: replicated), and
:func:`shard_params` / :func:`shard_adapters` cut one rank's slices.

Megatron-style rules, the reference's key sets: column-parallel ``wq``,
``wk``, ``wv``, ``wgate``, ``wup`` (and the other ``COL_KEYS``) and their
biases split ``d_out``; row-parallel ``wo``, ``wdown`` (``ROW_KEYS``) split
``d_in`` and replicate their bias; the embedding splits the vocabulary;
MoE experts split the expert axis, the SSM leaves their channels. A
dimension that does not divide by ``tp`` stays replicated (the reference's
``_put``). A NeuroAda delta inherits its host matrix's ``d_out`` split
(:func:`delta_split_dim`).

Deliberate differences from the reference, for SPMD serving:

* the embedding *lookup* stays replicated: :func:`shard_params` keeps the
  whole ``embed`` on every rank (one vocab × d table a rank) and the tied
  head reads its rank's vocab rows as a view, so no collective is needed
  before the first layer (the reference's inventory lists none);
* a packed (int8 / NF4) leaf splits its ``data`` and ``scales`` together,
  and a row-parallel split that would cut a scale block or an NF4 byte
  pair is refused (the reference replicates that child instead);
* a delta on a row-parallel matrix (whose ``d_in`` is split) keeps, on each
  rank, the entries whose index falls in the rank's ``d_in`` range, shifted
  to local indices, with value 0 for the rest (:func:`shard_adapters`):
  its partial sum rides in the same all-reduce as the base's.

Not ported: FSDP (``needs_fsdp``, the data axes of ``spec_for_param``),
``batch_specs`` and ``data_axes``, the training layouts for ``pjit``.
"""

from __future__ import annotations

import torch

from repro_torch.quant.qtensor import QuantizedTensor
from repro_torch.tree import flatten, path_str, unflatten

COL_KEYS = {
    "wq", "wk", "wv", "wgate", "wup", "in_proj", "dt_proj", "head",
    "self_wq", "self_wk", "self_wv", "cross_wq", "cross_wk", "cross_wv",
}
ROW_KEYS = {
    "wo", "wdown", "out_proj", "x_proj", "bc_proj", "self_wo", "cross_wo",
}
EXPERT_KEYS = {"wgate", "wup", "wdown"}


def split_dim(name: str, shape: tuple, family: str, tp: int) -> int | None:
    """The dimension (an index into ``shape``) that the ``model`` axis of
    ``tp`` ranks splits for the param at path ``name``, or None where the
    leaf is replicated: the reference's ``spec_for_param`` without FSDP."""
    parts = name.split("/")
    leaf = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""
    nd = len(shape)

    def fit(dim: int) -> int | None:
        d = dim % nd
        return d if shape[d] % tp == 0 else None

    if parent == "embed" and leaf == "w":
        return fit(0)  # vocab
    if parent == "router":
        return None
    if leaf in ("w", "b"):
        if family == "moe" and parent in EXPERT_KEYS and nd >= 3:
            return fit(-3 if leaf == "w" else -2)  # the expert axis
        if parent in COL_KEYS:
            return fit(-1)
        if parent in ROW_KEYS and leaf == "w":
            return fit(-2)
        return None  # a row-parallel bias and everything else: replicated
    if leaf in ("conv_w", "conv_b", "skip_D", "gate_norm"):
        return fit(-1)  # per channel
    if leaf == "A_log":
        return fit(-2 if family == "ssm" else -1)  # mamba1 (…, di, N); mamba2 per head
    return None


def delta_split_dim(host_dim: int | None, host_ndim: int, delta_ndim: int) -> int | None:
    """The split dimension of a delta ``(…, k, d_out)`` on a host matrix
    split along ``host_dim`` (the reference's ``delta_spec_from``): ``d_out``
    is inherited; ``d_in`` has no delta axis (None); a leading axis (MoE
    experts) maps right-aligned against the delta's leading axes, which
    carry one more (the tenants) in a serving stack."""
    if host_dim is None:
        return None
    if host_dim == host_ndim - 1:
        return delta_ndim - 1
    if host_dim == host_ndim - 2:
        return None
    lead, wlead = delta_ndim - 2, host_ndim - 2
    use = min(lead, wlead)
    j = host_dim - (wlead - use)
    return lead - use + j if j >= 0 else None


def kv_split_dim(shape: tuple, tp: int) -> int | None:
    """A KV cache leaf's kv-head axis (second to last: ``(…, KV, hd)``), when
    it divides by ``tp``."""
    return len(shape) - 2 if shape[-2] % tp == 0 else None


def kv_scale_split_dim(shape: tuple, tp: int) -> int | None:
    """An int8 cache's scale leaf, which keeps kv-heads last."""
    return len(shape) - 1 if shape[-1] % tp == 0 else None


def local_range(size: int, rank: int, tp: int) -> tuple[int, int]:
    """[lo, hi) of ``rank``'s slice of a dimension of ``size``."""
    n = size // tp
    return rank * n, rank * n + n


def _slice(t: torch.Tensor, dim: int, rank: int, tp: int) -> torch.Tensor:
    """``rank``'s slice of ``t`` along ``dim`` as a tensor of its own (the
    whole tensor's storage is not kept alive)."""
    lo, hi = local_range(t.shape[dim], rank, tp)
    return t.narrow(dim, lo, hi - lo).clone(memory_format=torch.contiguous_format)


def _slice_packed(name: str, qt: QuantizedTensor, dim: int, rank: int,
                  tp: int) -> QuantizedTensor:
    """A packed leaf's slice along logical ``dim``: ``data`` and ``scales``
    together. Along ``d_in`` every rank's rows must be whole scale blocks
    (and whole NF4 bytes)."""
    nd = len(qt.shape)
    if dim == nd - 2:
        d_in = qt.shape[-2]
        rows = d_in // tp
        if qt.qdtype == "nf4" and rows % 2:
            raise ValueError(f"{name}: tp={tp} splits d_in={d_in} into {rows} rows a rank, "
                             "which cuts an NF4 byte pair")
        if rows % qt.block:
            raise ValueError(f"{name}: tp={tp} splits d_in={d_in} into {rows} rows a rank, "
                             f"which cuts a scale block of {qt.block} rows")
    return QuantizedTensor(_slice(qt.data, dim, rank, tp), _slice(qt.scales, dim, rank, tp),
                           qt.qdtype, qt.block, qt.dtype_name)


def param_shapes(params) -> dict[str, tuple]:
    """``{path: logical shape}`` of every leaf (a packed leaf's logical
    shape): the host matrices :func:`shard_adapters` reads."""
    return {path_str(p): tuple(x.shape) for p, x in flatten(params) if x is not None}


def shard_params(params, family: str, rank: int, tp: int):
    """``rank``'s local params: every leaf cut along its :func:`split_dim`
    (a packed leaf's codes and scales together), the rest replicated. The
    embedding stays whole on every rank (see the module note)."""
    if tp <= 1:
        return params
    out = []
    for path, x in flatten(params):
        name = path_str(path)
        dim = None if x is None or name == "embed/w" else split_dim(name, tuple(x.shape),
                                                                    family, tp)
        if dim is not None:
            x = (_slice_packed(name, x, dim, rank, tp) if isinstance(x, QuantizedTensor)
                 else _slice(x, dim, rank, tp))
        out.append((path, x))
    return unflatten(out)


def shard_adapters(idx, val, shapes: dict, family: str, rank: int, tp: int):
    """``rank``'s local tenant stacks ``(idx, val)`` (trees of ``(L, N, k,
    d_out)`` block stacks and an ``(N, k, V)`` head stack) over host params
    of logical ``shapes`` (:func:`param_shapes` of the unsharded base). A
    stack on a split ``d_out`` (or expert axis) is sliced with its host; on
    a row-parallel host, whose ``d_in`` is split, each entry stays where its
    index falls in the rank's ``d_in`` range, shifted to a local index, and
    the rest get index 0 and value 0."""
    if tp <= 1:
        return idx, val
    flat_v = dict(flatten(val))
    out_i, out_v = [], []
    for path, i in flatten(idx):
        v = flat_v[path]
        name = path_str(path)
        if i is not None:
            host = shapes[name]
            hdim = split_dim(name, host, family, tp)
            if hdim == len(host) - 2:  # row-parallel: mask to the local d_in range
                lo, hi = local_range(host[-2], rank, tp)
                mine = (i >= lo) & (i < hi)
                i = torch.where(mine, i - lo, 0).to(torch.int32)
                v = torch.where(mine, v, torch.zeros((), dtype=v.dtype, device=v.device))
            else:
                dim = delta_split_dim(hdim, len(host), i.ndim)
                if dim is not None:
                    i, v = _slice(i, dim, rank, tp), _slice(v, dim, rank, tp)
        out_i.append((path, i))
        out_v.append((path, v))
    return unflatten(out_i), unflatten(out_v)

