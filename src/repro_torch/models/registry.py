"""The model API the engine and the trainer drive (port of
``repro.models.registry``, the dense and MoE families)."""

from __future__ import annotations

import torch.nn as nn

from repro_torch.device import resolve_device
from repro_torch.models import transformer

FAMILIES = ("dense", "moe")


class Model(nn.Module):
    """A config-bound decoder of the dense or MoE family. Weights live in a nested param dict
    (:func:`init`, or converted from the reference), passed to each call as
    in the reference, so one ``Model`` serves any param tree of its config.
    Per-layer views of the last param tree and tenant stacks seen are kept,
    so the serving loop does not re-slice the layer stacks every step."""

    def __init__(self, cfg):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"the port has the {' and '.join(FAMILIES)} families, got "
                             f"{cfg.family!r} (ROADMAP.md §1 item 10)")
        self.cfg = cfg
        self._views: tuple = (None, None)
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
        if self._views[0] is not params["blocks"]:
            self._views = (params["blocks"], transformer.layer_views(params))
        return self._views[1]

    def _adapter_views(self, adapters):
        """Per-layer views of the tenant stacks, kept while the engine
        passes the same stacks (they change only on register/remove)."""
        blocks = adapters.get("blocks") if adapters else None
        key = tuple(id(d.idx) for d in blocks.values()) if blocks else ()
        if self._a_views[0] != key:
            self._a_views = (key, transformer.adapter_views(adapters))
        return self._a_views[1]

    def loss(self, params, adapters, batch):
        """(loss, {"ce", "aux"}) of a training batch; see
        :func:`repro_torch.models.transformer.loss_fn`."""
        return transformer.loss_fn(self.cfg, params, adapters, batch, self._layers(params))

    def forward_train(self, params, adapters, batch):
        """((B, S, V) logits, aux) of a training batch."""
        return transformer.forward_train(self.cfg, params, adapters, batch,
                                         self._layers(params))

    def prefill_chunk(self, params, adapters, cache, batch):
        return transformer.prefill_chunk(self.cfg, params, adapters, cache, batch,
                                         self._layers(params), self._adapter_views(adapters))

    def decode_step(self, params, adapters, cache, batch):
        return transformer.decode_step(self.cfg, params, adapters, cache, batch,
                                       self._layers(params), self._adapter_views(adapters))


def get_model(cfg) -> Model:
    return Model(cfg)
