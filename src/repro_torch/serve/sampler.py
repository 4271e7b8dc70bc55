"""Token sampling on the device (port of ``repro.serve.sampler``).

One ``(B, V_padded)`` logits tensor in, one ``(B,)`` int32 token vector
out, with no host synchronisation: the engine's one device-to-host
transfer per step carries the result. Greedy vs temperature is resolved
per row from a ``(B,)`` temperature tensor (0 = greedy); ``top_k`` and
``top_p`` are engine-level settings (0 = off), as in the reference.

A sampled row draws by Gumbel-max over the filtered, temperature-scaled
logits with noise from the engine's ``torch.Generator`` — a categorical
draw, but not JAX's random bits: sampled outputs match the reference in
distribution only. Greedy rows are exact (``argmax`` picks the first
maximum, as ``jnp.argmax`` does).
"""

from __future__ import annotations

import torch


class Sampler:
    def __init__(self, vocab_size: int, *, top_k: int = 0, top_p: float = 0.0):
        if not 0.0 <= top_p <= 1.0:
            raise ValueError(f"top_p must be in [0, 1], got {top_p}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        self.vocab_size = vocab_size
        self.top_k = top_k
        self.top_p = top_p

    def _filtered(self, logits, temps):
        """-> (B, vocab) filtered temperature-scaled logits and the (B,)
        greedy argmax (top-1 survives both filters)."""
        lg = logits[:, : self.vocab_size].float()
        if self.top_k and self.top_k < self.vocab_size:
            kth = torch.topk(lg, self.top_k, dim=-1).values[:, -1:]
            lg = lg.masked_fill(lg < kth, float("-inf"))
        greedy = torch.argmax(lg, dim=-1).to(torch.int32)
        scaled = lg / temps.float().clamp(min=1e-6)[:, None]
        if self.top_p and self.top_p < 1.0:
            srt = torch.sort(scaled, dim=-1, descending=True).values
            probs = torch.softmax(srt, dim=-1)
            above = torch.cumsum(probs, dim=-1) - probs  # mass strictly above
            cutoff = srt.masked_fill(above >= self.top_p, float("inf")).amin(
                dim=-1, keepdim=True)
            scaled = scaled.masked_fill(scaled < cutoff, float("-inf"))
        return scaled, greedy

    def __call__(self, logits, temps, generator: torch.Generator | None = None):
        """logits (B, V_padded), temps (B,) -> tokens (B,) int32."""
        scaled, greedy = self._filtered(logits, temps)
        u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
        gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
        sampled = torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)
        return torch.where(temps.float() > 0.0, sampled, greedy)

    def probs(self, logits, temps):
        """The (B, vocab) distribution ``__call__`` draws from: the softmax
        of the filtered, temperature-scaled logits on sampled rows, a
        one-hot at the greedy argmax on temp-0 rows. The speculative accept
        rule ``u · q(d) < p(d)`` then is an exact token match on greedy
        rows."""
        scaled, greedy = self._filtered(logits, temps)
        p = torch.softmax(scaled, dim=-1)
        onehot = torch.zeros_like(p).scatter_(-1, greedy.long()[:, None], 1.0)
        return torch.where(temps.float()[:, None] > 0.0, p, onehot)
