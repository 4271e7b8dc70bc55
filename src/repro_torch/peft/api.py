"""Adapter export and load (port of ``repro.peft.api.export_adapter`` /
``load_adapter``): the unmerged multi-tenant serving artifact, in the
same npz format, so an adapter written by either package loads in the
other."""

from __future__ import annotations

from repro_torch.checkpoint import load_pytree, save_pytree


def export_adapter(path: str, indices, values, metadata: dict | None = None) -> None:
    """Save only the ``(k, d_out)`` index and value trees of one tenant."""
    save_pytree(path, {"indices": indices, "values": values}, metadata)


def load_adapter(path: str):
    """-> (indices, values) trees of CPU tensors, as saved by
    :func:`export_adapter`."""
    tree = load_pytree(path)
    if not isinstance(tree, dict) or set(tree) != {"indices", "values"}:
        raise ValueError(f"{path} is not an adapter export (expected indices+values)")
    return tree["indices"], tree["values"]
