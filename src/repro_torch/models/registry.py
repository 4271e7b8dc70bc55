"""The model API the engine and the trainer drive (port of
``repro.models.registry``): the dense, MoE and VLM families through
:mod:`~repro_torch.models.transformer`, the SSM family (falcon-mamba)
through :mod:`~repro_torch.models.mamba_lm`, the hybrid (zamba2) through
:mod:`~repro_torch.models.zamba2`, the encoder-decoder (seamless-m4t)
through :mod:`~repro_torch.models.encdec`."""

from __future__ import annotations

import torch
import torch.nn as nn

from repro_torch.core.delta import BatchedDelta
from repro_torch.device import resolve_device
from repro_torch.models import encdec, mamba_lm, transformer, zamba2
from repro_torch.tree import flatten

_FAMILY = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "ssm": mamba_lm,
    "hybrid": zamba2,
    "encdec": encdec,
}
# the stacked layer trees a family's per-layer views are cut from
_STACKS = ("blocks", "enc_blocks", "dec_blocks")
FAMILIES = tuple(_FAMILY)


class Model(nn.Module):
    """A config-bound model of one of :data:`FAMILIES`. Weights live in a
    nested param dict (:func:`init`, or converted from the reference),
    passed to each call as in the reference, so one ``Model`` serves any
    param tree of its config. Per-layer views of the last two param trees (a
    served model and its speculative drafter) and of the last tenant stacks
    seen are kept, so the serving loop does not re-slice the layer stacks
    every step; views of a tree with trainable (``requires_grad``) leaves
    are not kept.

    Every family has ``init``, ``loss``, ``forward_train``, ``prefill``,
    ``decode_step`` and ``init_cache``; the chunked prefill and
    verification, the paged cache and int8 KV belong to the transformer
    families alone and raise elsewhere with the reference's words."""

    def __init__(self, cfg):
        super().__init__()
        if cfg.family not in _FAMILY:
            raise ValueError(f"the port has the {', '.join(FAMILIES)} families, got "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.mod = _FAMILY[cfg.family]
        self._views: list = []  # [(stacked trees, views)], the most recent first
        self._a_views: tuple = ((), None)

    def _kv_lm(self, what: str) -> None:
        """Refuse what only the transformer (KV-cache) families have."""
        if self.mod is not transformer:
            raise ValueError(f"family {self.cfg.family!r} has no {what}")

    def init(self, seed: int = 0, device=None) -> dict:
        """Random weights from ``seed`` on ``device`` (default ``cuda``)."""
        return self.mod.init_params(self.cfg, seed=seed, device=resolve_device(device))

    def init_paged_cache(self, num_blocks: int, page_size: int, device,
                         kv_dtype: str = "fp32") -> dict:
        self._kv_lm("paged KV cache")
        return transformer.init_paged_cache(self.cfg, num_blocks, page_size, device,
                                            kv_dtype)

    def init_cache(self, slots: int, max_len: int, device, kv_dtype: str = "fp32") -> dict:
        """The dense slot cache of a transformer family, the SSM / hybrid
        decode state, or the encoder-decoder's self and cross k/v (cross at
        ``encdec.DECODE_ENC_LEN`` frames); ``kv_dtype`` ``fp32`` only but on
        the transformer families, as in the reference."""
        if self.mod is transformer:
            return transformer.init_cache(self.cfg, slots, max_len, device, kv_dtype)
        if kv_dtype != "fp32":
            self._kv_lm("quantized KV cache")
        return self.mod.init_cache(self.cfg, slots, max_len, device)

    def vlm_split(self, seq_len: int) -> tuple[int, int]:
        """(patch positions, text positions) of a VLM sequence of
        ``seq_len``: ``int(seq_len * image_frac)`` patches first."""
        s_img = int(seq_len * self.cfg.image_frac)
        return s_img, seq_len - s_img

    def _layers(self, params):
        """The family's per-layer views of ``params`` (``layer_views``),
        kept per stacked tree: ``blocks``, or the encoder-decoder's
        ``enc_blocks`` and ``dec_blocks``."""
        stacks = [params[k] for k in _STACKS if k in params]
        if any(isinstance(x, torch.Tensor) and x.requires_grad
               for blocks in stacks for _, x in flatten(blocks)):
            # a training step's live trainable tree (bitfit, masked, full): its
            # views are not kept, or they would hold its tensors past the step
            return self.mod.layer_views(params)
        hit = next((e for e in self._views
                    if len(e[0]) == len(stacks) and all(a is b for a, b in zip(e[0], stacks))),
                   None)
        if hit is None:
            hit = (stacks, self.mod.layer_views(params))
        self._views = [hit] + [e for e in self._views if e is not hit][:1]
        return hit[1]

    def _adapter_views(self, adapters):
        """Per-layer views of the tenant stacks, kept while the engine
        passes the same stacks (they change only on register/remove)."""
        blocks = adapters.get("blocks") if adapters else None
        if not blocks:  # a drafter's call keeps the served stacks' views
            return None
        if not isinstance(next(iter(blocks.values())), BatchedDelta):
            return None  # a training adapter tree: the forward slices it
        key = tuple(id(d.idx) for d in blocks.values())
        if self._a_views[0] != key:
            self._a_views = (key, transformer.adapter_views(adapters))
        return self._a_views[1]

    def loss(self, params, adapters, batch, remat: str = "none"):
        """(loss, {"ce", "aux"}) of a training batch; see the family
        module's ``loss_fn``."""
        return self.mod.loss_fn(self.cfg, params, adapters, batch, self._layers(params), remat)

    def forward_train(self, params, adapters, batch, remat: str = "none"):
        """((B, S, V) logits, aux) of a training batch."""
        return self.mod.forward_train(self.cfg, params, adapters, batch, self._layers(params),
                                      remat)

    def prefill(self, params, adapters, batch):
        """Whole-prompt forward: ((B, V) last-token logits, the cache
        ``decode_step`` continues from)."""
        return self.mod.prefill(self.cfg, params, adapters, batch, self._layers(params))

    def prefill_chunk(self, params, adapters, cache, batch):
        self._kv_lm("chunked prefill")
        return transformer.prefill_chunk(self.cfg, params, adapters, cache, batch,
                                         self._layers(params), self._adapter_views(adapters))

    def verify_chunk(self, params, adapters, cache, batch):
        """(B, C, V) logits at every chunk column (speculative verify)."""
        self._kv_lm("chunked verification")
        return transformer.verify_chunk(self.cfg, params, adapters, cache, batch,
                                        self._layers(params), self._adapter_views(adapters))

    def ingest_chunk(self, params, adapters, cache, batch):
        """A chunk's k/v writes only (a drafter riding a mixed step)."""
        self._kv_lm("chunked prefill")
        transformer.ingest_chunk(self.cfg, params, adapters, cache, batch,
                                 self._layers(params), self._adapter_views(adapters))

    def decode_step(self, params, adapters, cache, batch):
        """(B, V) logits of one token a sequence; the cache advances in
        place."""
        if self.mod is not transformer:
            return self.mod.decode_step(self.cfg, params, adapters, cache, batch,
                                        self._layers(params))
        return transformer.decode_step(self.cfg, params, adapters, cache, batch,
                                       self._layers(params), self._adapter_views(adapters))


def get_model(cfg) -> Model:
    return Model(cfg)
