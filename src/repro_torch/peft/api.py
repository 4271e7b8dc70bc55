"""The PEFT interface of the trainer — NeuroAda and every baseline the
paper compares — and adapter export and load (port of ``repro.peft.api``).

A :class:`Peft` bundles the functions the trainer calls, so the trainer
does not know the method:

* ``init(params, rng=None) -> (trainable, aux)`` — ``trainable`` is the
  only tree that gets gradients, ``aux`` its frozen companion (NeuroAda's
  indices, the masked method's bool mask); ``rng`` is a
  ``torch.Generator`` (LoRA's ``A``, the ``random`` strategy);
* ``model_inputs(params, trainable, aux) -> (params, adapters)``;
* ``post_grad(grads, aux) -> grads``;
* ``merge(params, trainable, aux) -> params`` (Alg. 1 phase 3, the export).

The methods (:func:`get_peft`, ``pcfg.method``):

* ``neuroada``: top-k input connections per neuron by ``pcfg.strategy``,
  the ``(…, k, d_out)`` values the only trainables (zero-initialised in
  ``pcfg.delta_dtype``), the indices as ``aux``;
* ``lora``: ``{"A", "B", "scale"}`` beside every adaptable matrix, ``A``
  normal · d_in^-0.5, ``B`` zeros, ``scale = alpha / r`` (a constant);
  on a packed base, QLoRA;
* ``bitfit``: copies of the biases and norm scales;
* ``masked``: the paper's Fig. 2 baseline — the same selection, but a
  dense trainable copy of the params, dense gradients and moments, and a
  bool mask that zeroes every unselected gradient;
* ``full`` (alias ``none``): a dense trainable copy of the params.

Memory follows from the trees: NeuroAda's, LoRA's and BitFit's trainables
are small, so their AdamW moments are; ``masked`` and ``full`` hold a
dense copy, a dense gradient and two dense float32 moments.

:func:`quantize_base` drops the frozen base to int8 or NF4 before adapting
or serving (QLoRA-style): only sound for the methods that freeze it.

Adapter files are the unmerged multi-tenant serving artifact, in the same
npz format as the reference, so an adapter written by either package
loads in the other.
"""

from __future__ import annotations

import logging
import re
from typing import Callable, NamedTuple

import torch

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
from repro_torch.quant.qtensor import any_quantized, dequantize_tree, quantize_tree, tree_bytes
from repro_torch.tree import map_leaves, path_str, with_paths

log = logging.getLogger("repro_torch.peft")

METHODS = ("neuroada", "lora", "bitfit", "masked", "full", "none")
BASE_DTYPES = ("fp32", "int8", "nf4")  # "fp32": leave the config's dtype


def quantize_base(params, qdtype: str = "int8", *, block: int = 64):
    """The frozen base with every adaptable matrix packed to ``qdtype``, on
    the matrices' devices; embeddings, routers, norms and biases stay in
    the compute dtype. ``"fp32"`` returns ``params`` unchanged, so a
    launcher's ``--base-dtype`` passes through; packed leaves pass through.
    On the MoE family the (L, E, d_in, d_out) expert stacks, the attention
    projections and an untied head pack (block scales along d_in, per
    expert); the router stays dense. Only the methods that freeze the base
    (neuroada, lora, bitfit) train on it."""
    if qdtype == "fp32":
        return params
    if qdtype not in BASE_DTYPES:
        raise ValueError(f"base dtype {qdtype!r} not in {BASE_DTYPES}")
    return quantize_tree(params, qdtype, block, is_adaptable)


class Peft(NamedTuple):
    method: str
    init: Callable  # (params, rng=None) -> (trainable, aux)
    model_inputs: Callable  # (params, trainable, aux) -> (params, adapters)
    post_grad: Callable  # (grads, aux) -> grads
    merge: Callable  # (params, trainable, aux) -> params


def _identity_grads(grads, aux):
    return grads


def _dense_copy(params, method: str):
    """A copy of every leaf: the trainable tree of the dense methods,
    which need a dense base (the launcher refuses a packed one)."""
    if any_quantized(params):
        raise ValueError(f"peft method {method!r} trains the dense weights: it needs a dense "
                         "base, not a packed (int8 / NF4) one")
    return map_leaves(lambda w: None if w is None else w.clone(), params)


# ------------------------------------------------------------------ NeuroAda


def neuroada(pcfg, *, grads=None, exclude=DEFAULT_EXCLUDE) -> Peft:
    """NeuroAda: top-k input connections per neuron by ``pcfg.strategy``
    (``grads``: the dL/dW tree ``gradient`` selects by), values the only
    trainables."""
    dtype = DTYPES[pcfg.delta_dtype]

    def init(params, rng=None):
        indices, values = init_adapters(params, pcfg.k, strategy=pcfg.strategy, rng=rng,
                                        grads=grads, dtype=dtype, exclude=exclude)
        return values, indices

    def model_inputs(params, values, indices):
        return params, zip_adapters(indices, values)

    def merge(params, values, indices):
        return merge_adapters(params, indices, values)

    return Peft("neuroada", init, model_inputs, _identity_grads, merge)


# ---------------------------------------------------------------------- LoRA


def lora(pcfg, exclude=DEFAULT_EXCLUDE) -> Peft:
    """LoRA (QLoRA on a packed base): ``y = x @ W + (x @ A @ B) · scale``
    at every adaptable matrix. ``A`` draws from ``rng`` leaf by leaf (the
    reference splits one key a leaf: parity tests feed the reference's
    initial tree)."""
    r, alpha = pcfg.lora_rank, pcfg.lora_alpha

    def init(params, rng=None):
        if rng is None:
            raise ValueError("peft method 'lora' draws A from rng: pass a torch.Generator")

        def one(pl):
            path, leaf = pl
            if leaf is None or not is_adaptable(path_str(path), leaf, exclude):
                return None
            *stack, d_in, d_out = leaf.shape
            dev, dt = leaf.device, leaf.dtype
            a = torch.randn((*stack, d_in, r), generator=rng, device=dev, dtype=torch.float32)
            return {"A": (a * d_in**-0.5).to(dt),
                    "B": torch.zeros((*stack, r, d_out), dtype=dt, device=dev),
                    # stack-shaped, so the layer loop slices it; a constant
                    "scale": torch.full(tuple(stack), alpha / r, dtype=dt, device=dev)}

        trainable = map_leaves(one, with_paths(params))
        if (trainable.get("head") or {}).get("w") is not None:
            log.warning("lora: the untied head's LoRA leaf is built and counted but, as in the "
                        "reference (repro/models/transformer.py:261-265), never applied: its "
                        "gradient is zero")
        return trainable, None

    def model_inputs(params, trainable, aux):
        return params, trainable

    def merge(params, trainable, aux):
        if any_quantized(params):  # folding into integer codes would round it away
            params = dequantize_tree(params)

        def one(w, ad):
            if ad is None:
                return w
            dense = torch.einsum("...ir,...ro->...io", ad["A"].float(), ad["B"].float())
            dense = dense * ad["scale"].float()[..., None, None]
            return (w.float() + dense).to(w.dtype)

        return map_leaves(one, params, trainable)

    return Peft("lora", init, model_inputs, _identity_grads, merge)


# -------------------------------------------------------------------- BitFit


_BITFIT_PAT = (r".*/b$", r".*norm.*", r".*_norm$")


def bitfit(pcfg) -> Peft:
    """Train biases and norm scales only (Ben Zaken et al., 2022)."""

    def is_bitfit(name, leaf):
        return (isinstance(leaf, torch.Tensor) and leaf.ndim <= 2
                and any(re.fullmatch(p, name) for p in _BITFIT_PAT))

    def init(params, rng=None):
        # copies, not aliases: the trainable tree is replaced every step
        return map_leaves(lambda pl: pl[1].clone() if is_bitfit(path_str(pl[0]), pl[1]) else None,
                          with_paths(params)), None

    def model_inputs(params, trainable, aux):
        return map_leaves(lambda p, t: p if t is None else t, params, trainable), None

    def merge(params, trainable, aux):
        return model_inputs(params, trainable, aux)[0]

    return Peft("bitfit", init, model_inputs, _identity_grads, merge)


# ------------------------------------------------- mask-based sparse tuning


def masked_sparse(pcfg, exclude=DEFAULT_EXCLUDE) -> Peft:
    """The paper's Fig. 2 baseline: NeuroAda's selection, but a dense
    trainable copy, dense gradients and moments, and a bool mask (``aux``)
    zeroing every unselected gradient."""

    def init(params, rng=None):
        trainable = _dense_copy(params, "masked")
        indices, _ = init_adapters(params, pcfg.k, strategy=pcfg.strategy, rng=rng,
                                   exclude=exclude)

        def mask_of(w, idx):
            if w is None:
                return None
            m = torch.zeros(w.shape, dtype=torch.bool, device=w.device)
            return m if idx is None else m.scatter_(-2, idx.long(), True)

        return trainable, map_leaves(mask_of, params, indices)

    def model_inputs(params, trainable, aux):
        return trainable, None

    def post_grad(grads, mask):
        return map_leaves(lambda g, m: None if g is None else g * m.to(g.dtype), grads, mask)

    def merge(params, trainable, aux):
        return trainable

    return Peft("masked", init, model_inputs, post_grad, merge)


# ------------------------------------------------------------------- full FT


def full_ft(pcfg) -> Peft:
    """Full fine-tuning: every parameter trains (a dense copy)."""

    def init(params, rng=None):
        return _dense_copy(params, "full"), None

    def model_inputs(params, trainable, aux):
        return trainable, None

    return Peft("full", init, model_inputs, _identity_grads, lambda p, t, a: t)


# ------------------------------------------------------------------ registry


def get_peft(pcfg, **kw) -> Peft:
    """The method ``pcfg.method`` names (``kw`` goes to :func:`neuroada`)."""
    m = pcfg.method
    if m == "neuroada":
        return neuroada(pcfg, **kw)
    if m == "lora":
        return lora(pcfg)
    if m == "bitfit":
        return bitfit(pcfg)
    if m == "masked":
        return masked_sparse(pcfg)
    if m in ("full", "none"):
        return full_ft(pcfg)
    raise ValueError(f"unknown peft method {m!r}")


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
