"""Multi-tenant adapter registry (port of ``repro.serve.adapters``).

Each tenant registers the ``(indices, values)`` trees of one NeuroAda
adapter (``peft.load_adapter``, or ``core.adapt.init_adapters``). The store
stacks them per matrix with row 0 the implicit base model (zero values):
leaves under ``blocks`` become ``(L, N, k, d_out)`` (layer axis leading,
as the layer loop slices it), other leaves (an untied ``head``)
``(N, k, d_out)``. Stacks are cached per device and rebuilt only after
``register``/``remove``.
"""

from __future__ import annotations

import logging

import torch

from repro_torch.convert import to_tensor
from repro_torch.tree import flatten, map_leaves, path_str, unflatten

log = logging.getLogger("repro_torch.serve.adapters")

# top-level subtrees the serving forward applies deltas from
APPLIED_KEYS = ("blocks", "head")


def _as_tensor(x):
    if x is None or isinstance(x, torch.Tensor):
        return x
    return to_tensor(x)


def _structure(tree):
    return [(p, leaf is None, None if leaf is None else tuple(leaf.shape))
            for p, leaf in flatten(tree)]


class AdapterStore:
    def __init__(self, base_params=None):
        """``base_params`` (optional) lets registration check each delta's
        indices against the base weight shapes."""
        self._indices: list = []
        self._values: list = []
        self.names: list[str] = []
        self._stacked: dict = {}  # device -> (idx_tree, val_tree)
        self._base = base_params
        self.removals = 0  # bumped by remove(): ids shift
        # full re-stacks of the tenant trees (the engine's
        # serve_adapter_stack_builds gauge): one a register/remove and
        # device, never one a step
        self.stack_builds = 0

    @property
    def num_adapters(self) -> int:
        return len(self._indices)

    def _validate_base_shapes(self, indices, label: str) -> None:
        if self._base is None:
            return
        for path, leaf in flatten(indices):
            if leaf is None:
                continue
            node = self._base
            try:
                for key in path:
                    node = node[key]
            except (KeyError, TypeError):
                raise ValueError(
                    f"{label}: adapter leaf {path_str(path)} has no matching base weight"
                ) from None
            d_in = node.shape[-2]
            lo, hi = int(leaf.min()), int(leaf.max())
            if lo < 0 or hi >= d_in:
                raise ValueError(
                    f"{label}: delta index {lo if lo < 0 else hi} out of range "
                    f"[0, {d_in}) at {path_str(path)} — adapter trained against "
                    "a different architecture?"
                )

    def register(self, indices, values, name: str | None = None) -> int:
        """Register one tenant's trees; returns its adapter id (1-based,
        id 0 is the base model)."""
        indices = map_leaves(lambda x: None if x is None else _as_tensor(x).to(torch.int32),
                             indices)
        values = map_leaves(_as_tensor, values)
        if not isinstance(indices, dict) or "blocks" not in indices:
            raise ValueError("adapter tree has no 'blocks' subtree")
        label = name or f"adapter{len(self.names) + 1}"
        self._validate_base_shapes(indices, label)
        if _structure(indices) != _structure(values):
            raise ValueError(f"{label}: values tree does not mirror indices tree")
        for key, sub in values.items():
            if key in APPLIED_KEYS:
                continue
            if any(bool(v.float().abs().sum() > 0) for _, v in flatten(sub) if v is not None):
                log.warning("adapter %s has nonzero deltas under %r — not applied "
                            "at serve time (merge offline instead)", label, key)
        if self._indices and _structure(self._indices[0]) != _structure(indices):
            raise ValueError(f"{label}: adapter tree structure mismatch")
        self._indices.append(indices)
        self._values.append(values)
        self.names.append(label)
        self._stacked = {}
        return len(self._indices)

    def remove(self, name_or_id: str | int) -> None:
        """Unregister a tenant by name or 1-based id; later ids shift down."""
        if isinstance(name_or_id, str):
            try:
                i = self.names.index(name_or_id)
            except ValueError:
                raise KeyError(f"no tenant named {name_or_id!r}") from None
        else:
            if not 1 <= name_or_id <= len(self._indices):
                raise KeyError(f"adapter id {name_or_id} not registered")
            i = name_or_id - 1
        del self._indices[i], self._values[i], self.names[i]
        self._stacked = {}
        self.removals += 1

    def tenant_deltas(self) -> list[tuple]:
        """Every tenant's ``(indices, values)`` trees in id order (1-based;
        the implicit base is not included): the merged drafter folds their
        mean into the base (:func:`repro_torch.serve.draft.build_draft_params`)."""
        return list(zip(self._indices, self._values))

    def stacked(self, device):
        """(idx_tree, val_tree) of stacks on ``device``, N = tenants + 1,
        row 0 the base; None when no tenant is registered. Cached."""
        if not self._indices:
            return None
        device = torch.device(device)
        if device not in self._stacked:
            self.stack_builds += 1
            base_val = map_leaves(lambda v: None if v is None else torch.zeros_like(v),
                                  self._values[0])
            idx_all = [self._indices[0], *self._indices]
            val_all = [base_val, *self._values]

            def stack(key, trees):
                dim = 1 if key == "blocks" else 0
                flat = [flatten(t[key]) for t in trees]
                out = {}
                for j, (path, leaf) in enumerate(flat[0]):
                    out[path] = None if leaf is None else torch.stack(
                        [f[j][1].to(device) for f in flat], dim=dim).contiguous()
                return out[()] if list(out) == [()] else unflatten(out.items())

            self._stacked[device] = (
                {k: stack(k, idx_all) for k in self._indices[0]},
                {k: stack(k, val_all) for k in base_val},
            )
        return self._stacked[device]

