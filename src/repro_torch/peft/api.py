"""The PEFT interface of the trainer, and adapter export and load (port of
``repro.peft.api``; NeuroAda only).

A :class:`Peft` bundles the functions the trainer calls, so the trainer
does not know the method:

* ``init(params, rng=None) -> (trainable, aux)`` — ``trainable`` is the
  only tree that gets gradients; for NeuroAda the ``(…, k, d_out)``
  values, zero-initialised in ``pcfg.delta_dtype``, with the frozen
  indices as ``aux``;
* ``model_inputs(params, trainable, aux) -> (params, adapters)``;
* ``post_grad(grads, aux) -> grads``;
* ``merge(params, trainable, aux) -> params`` (Alg. 1 phase 3).

:func:`quantize_base` drops the frozen base to int8 or NF4 before adapting
or serving (QLoRA-style): only the bypass values train, so the packed base
changes nothing that is optimised.

Adapter files are the unmerged multi-tenant serving artifact, in the same
npz format as the reference, so an adapter written by either package
loads in the other.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.core.adapt import (
    DEFAULT_EXCLUDE,
    count_total,
    count_trainable,
    init_adapters,
    is_adaptable,
    merge_adapters,
    trainable_fraction,
    zip_adapters,
)
from repro_torch.models.transformer import DTYPES
from repro_torch.quant.qtensor import quantize_tree, tree_bytes

METHODS = ("neuroada",)
BASE_DTYPES = ("fp32", "int8", "nf4")  # "fp32": leave the config's dtype


def quantize_base(params, qdtype: str = "int8", *, block: int = 64):
    """The frozen base with every adaptable matrix packed to ``qdtype``, on
    the matrices' devices; embeddings, routers, norms and biases stay in
    the compute dtype. ``"fp32"`` returns ``params`` unchanged, so a
    launcher's ``--base-dtype`` passes through; packed leaves pass through.
    An MoE tree (one with a router) raises: the launchers and the engine
    reach a packed base only through here."""
    if qdtype == "fp32":
        return params
    if qdtype not in BASE_DTYPES:
        raise ValueError(f"base dtype {qdtype!r} not in {BASE_DTYPES}")
    if "router" in params.get("blocks", {}):
        raise NotImplementedError(
            f"a {qdtype} base on the MoE family's expert stacks is not ported yet "
            "(ROADMAP.md §1, packed base on MoE)")
    return quantize_tree(params, qdtype, block, is_adaptable)


class Peft(NamedTuple):
    method: str
    init: Callable  # (params, rng=None) -> (trainable, aux)
    model_inputs: Callable  # (params, trainable, aux) -> (params, adapters)
    post_grad: Callable  # (grads, aux) -> grads
    merge: Callable  # (params, trainable, aux) -> params


def neuroada(pcfg, *, exclude=DEFAULT_EXCLUDE) -> Peft:
    """NeuroAda: top-k input connections per neuron by ``pcfg.strategy``,
    values the only trainables."""
    dtype = DTYPES[pcfg.delta_dtype]

    def init(params, rng=None):
        indices, values = init_adapters(params, pcfg.k, strategy=pcfg.strategy,
                                        dtype=dtype, exclude=exclude)
        return values, indices

    def model_inputs(params, values, indices):
        return params, zip_adapters(indices, values)

    def merge(params, values, indices):
        return merge_adapters(params, indices, values)

    return Peft("neuroada", init, model_inputs, lambda g, aux: g, merge)


def get_peft(pcfg, **kw) -> Peft:
    if pcfg.method != "neuroada":
        raise NotImplementedError(
            f"peft method {pcfg.method!r} is not ported yet; the port has "
            f"{METHODS} (ROADMAP.md §1, remaining PEFT methods)")
    return neuroada(pcfg, **kw)


count_params = count_total


def stats(params, trainable) -> dict:
    """Trainable and total (logical) parameter counts, and the base's
    storage bytes — packed bytes for a quantized base."""
    return {"trainable": count_trainable(trainable), "total": count_total(params),
            "fraction": trainable_fraction(params, trainable),
            "base_bytes": tree_bytes(params)}


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
