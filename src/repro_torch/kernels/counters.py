"""Launch counts: proof that a run went through the hand-written kernels.

Each kernel module owns one :class:`LaunchCounter`. Its wrapper adds one
to ``kernel`` right after a successful launch, and the module's plain
PyTorch version adds one to ``plain`` on every call — so a run on the
card that should be all-kernel can assert ``plain == 0``. A wrapper that
chooses among several kernels also counts each launch under its route in
``routes``.
"""

from __future__ import annotations


class LaunchCounter:
    def __init__(self, name: str):
        self.name = name
        self.kernel = 0
        self.plain = 0
        self.routes: dict[str, int] = {}

    def launched(self, route: str) -> None:
        self.kernel += 1
        self.routes[route] = self.routes.get(route, 0) + 1

    def count(self, t) -> None:
        """A tensor-parallel wrapper's tally of one call on ``t``'s device:
        a launch of the kernel it wraps for a CUDA tensor, else a call of
        that kernel's plain version."""
        if t.is_cuda:
            self.launched("tp")
        else:
            self.plain += 1

    def reset(self) -> None:
        self.kernel = 0
        self.plain = 0
        self.routes = {}

    def __repr__(self) -> str:
        return f"LaunchCounter({self.name!r}, kernel={self.kernel}, plain={self.plain})"
