"""Launch counts: proof that a run went through the hand-written kernels.

Each kernel module owns one :class:`LaunchCounter`. Its wrapper adds one
to ``kernel`` right after a successful launch, and the module's plain
PyTorch version adds one to ``plain`` on every call — so a run on the
card that should be all-kernel can assert ``plain == 0``.
"""

from __future__ import annotations


class LaunchCounter:
    def __init__(self, name: str):
        self.name = name
        self.kernel = 0
        self.plain = 0

    def reset(self) -> None:
        self.kernel = 0
        self.plain = 0

    def __repr__(self) -> str:
        return f"LaunchCounter({self.name!r}, kernel={self.kernel}, plain={self.plain})"
