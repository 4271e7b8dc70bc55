"""The model API the engine and the trainer drive (port of
``repro.models.registry``, the dense and MoE families)."""

from __future__ import annotations

import torch
import torch.nn as nn

from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.tree import flatten

FAMILIES = ("dense", "moe")


class Model(nn.Module):
    """A config-bound decoder of the dense or MoE family. Weights live in a nested param dict
    (:func:`init`, or converted from the reference), passed to each call as
    in the reference, so one ``Model`` serves any param tree of its config.
    Per-layer views of the last two param trees (a served model and its
    speculative drafter) and of the last tenant stacks seen are kept, so
    the serving loop does not re-slice the layer stacks every step; views
    of a tree with trainable (``requires_grad``) leaves are not kept."""

    def __init__(self, cfg):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"the port has the {' and '.join(FAMILIES)} families, got "
                             f"{cfg.family!r} (ROADMAP.md §1 item 10)")
        self.cfg = cfg
        self._views: list = []  # [(blocks, views)], the most recent first
        self._a_views: tuple = ((), None)

    def init(self, seed: int = 0, device=None) -> dict:
        """Random weights from ``seed`` on ``device`` (default ``cuda``)."""
        return transformer.init_params(self.cfg, seed=seed, device=resolve_device(device))

    def init_paged_cache(self, num_blocks: int, page_size: int, device,
                         kv_dtype: str = "fp32") -> dict:
        return transformer.init_paged_cache(self.cfg, num_blocks, page_size, device,
                                            kv_dtype)

    def init_cache(self, slots: int, max_len: int, device, kv_dtype: str = "fp32") -> dict:
        return transformer.init_cache(self.cfg, slots, max_len, device, kv_dtype)

    def _layers(self, params) -> list[dict]:
        blocks = params["blocks"]
        if any(isinstance(x, torch.Tensor) and x.requires_grad for _, x in flatten(blocks)):
            # a training step's live trainable tree (bitfit, masked, full): its
            # views are not kept, or they would hold its tensors past the step
            return transformer.layer_views(params)
        hit = next((e for e in self._views if e[0] is blocks), None)
        if hit is None:
            hit = (blocks, transformer.layer_views(params))
        self._views = [hit] + [e for e in self._views if e is not hit][:1]
        return hit[1]

    def _adapter_views(self, adapters):
        """Per-layer views of the tenant stacks, kept while the engine
        passes the same stacks (they change only on register/remove)."""
        blocks = adapters.get("blocks") if adapters else None
        if not blocks:  # a drafter's call keeps the served stacks' views
            return None
        key = tuple(id(d.idx) for d in blocks.values())
        if self._a_views[0] != key:
            self._a_views = (key, transformer.adapter_views(adapters))
        return self._a_views[1]

    def loss(self, params, adapters, batch, remat: str = "none"):
        """(loss, {"ce", "aux"}) of a training batch; see
        :func:`repro_torch.models.transformer.loss_fn`."""
        return transformer.loss_fn(self.cfg, params, adapters, batch, self._layers(params),
                                   remat)

    def forward_train(self, params, adapters, batch, remat: str = "none"):
        """((B, S, V) logits, aux) of a training batch."""
        return transformer.forward_train(self.cfg, params, adapters, batch,
                                         self._layers(params), remat)

    def prefill_chunk(self, params, adapters, cache, batch):
        return transformer.prefill_chunk(self.cfg, params, adapters, cache, batch,
                                         self._layers(params), self._adapter_views(adapters))

    def verify_chunk(self, params, adapters, cache, batch):
        """(B, C, V) logits at every chunk column (speculative verify)."""
        return transformer.verify_chunk(self.cfg, params, adapters, cache, batch,
                                        self._layers(params), self._adapter_views(adapters))

    def ingest_chunk(self, params, adapters, cache, batch):
        """A chunk's k/v writes only (a drafter riding a mixed step)."""
        transformer.ingest_chunk(self.cfg, params, adapters, cache, batch,
                                 self._layers(params), self._adapter_views(adapters))

    def decode_step(self, params, adapters, cache, batch):
        return transformer.decode_step(self.cfg, params, adapters, cache, batch,
                                       self._layers(params), self._adapter_views(adapters))


def get_model(cfg) -> Model:
    return Model(cfg)
