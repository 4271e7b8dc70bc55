"""Drafters for speculative decoding (port of ``repro.serve.draft``).

A drafter proposes ``spec_k`` tokens a slot; the served model scores them
all in one verify chunk and keeps a verified prefix, so the drafter moves
only how many tokens a forward yields, never which tokens come out:

* ``int8`` / ``nf4``: the frozen base re-packed (a self-draft without the
  tenants' bypasses; on MoE the expert stacks too). On a base already packed in the same scheme the
  drafter *is* the served tree, at no extra byte.
* ``merged``: the base plus the mean of every tenant's delta, folded into
  dense weights once, run without bypasses. With one tenant it is the
  served model and every greedy draft is accepted.
* ``ngram``: no model. The slot's own committed tokens propose the
  continuation of the most recent earlier occurrence of its current
  token, so a round costs one verify forward for up to ``spec_k + 1``
  tokens.
"""

from __future__ import annotations

from repro_torch.core.adapt import merge_adapters
from repro_torch.peft import quantize_base
from repro_torch.quant.qtensor import QuantizedTensor, any_quantized, dequantize_tree
from repro_torch.tree import flatten, map_leaves

DRAFT_MODES = ("off", "int8", "nf4", "merged", "ngram")


def build_draft_params(params, mode: str, *, store=None, quant_block: int = 64):
    """The drafter's param tree, built from the engine's served ``params``
    (already packed when the engine serves a packed base); None for
    ``off`` and ``ngram``. A packed base in another scheme is dequantized
    before it is re-packed: codes are never re-quantized."""
    if mode in ("off", "ngram"):
        return None
    if mode not in DRAFT_MODES:
        raise ValueError(f"draft mode {mode!r} not in {DRAFT_MODES}")
    if mode == "merged":
        if store is None or store.num_adapters == 0:
            raise ValueError("draft='merged' needs an adapter store with registered tenants "
                             "(the drafter is the base plus the mean of the tenants' deltas)")
        n, dev = store.num_adapters, params["embed"]["w"].device
        for idx, val in store.tenant_deltas():
            idx = map_leaves(lambda i: None if i is None else i.to(dev), idx)
            scaled = map_leaves(lambda v: None if v is None else v.to(dev) / n, val)
            params = merge_adapters(params, idx, scaled)  # a packed base dequantizes once
        return params
    if any_quantized(params):
        held = next(x.qdtype for _, x in flatten(params) if isinstance(x, QuantizedTensor))
        if held == mode:
            return params  # the base is already packed in this scheme: share it
        params = dequantize_tree(params)
    return quantize_base(params, mode, block=quant_block)
