"""The one monotonic clock for the serving stack (DESIGN §16).

Before this module existed the engine stamped ``Request.t_submit`` /
``t_last`` straight off ``time.perf_counter()`` while the tracer ran its
own ``clock()`` captured at construction — two independent call sites
whose readings could never be compared, so TTFT histogram samples and
trace span durations only *approximately* agreed. Every serving-side
timestamp now routes through :func:`now`:

* ``Scheduler.submit`` stamps ``t_submit`` with it,
* the engine reads it for TTFT/ITL observation, step walls, deadline
  arithmetic and token-bucket refills,
* ``Tracer`` uses it as the default clock source, so a trace timestamp
  is exactly ``(now() - tracer_t0) * 1e6``.

Tests (and the chaos harness) substitute a fake source via the ``clock=``
parameters the scheduler, engine and tracer all take — injecting one
callable moves *every* lifecycle clock together, which is what makes
deadline expiry and rate-limit refill deterministically testable. The
default source is ``time.perf_counter``: monotonic, high-resolution, and
the same reference the repo's benches have always used.
"""

from __future__ import annotations

import time

__all__ = ["now"]


def now() -> float:
    """Seconds on the shared monotonic timebase (``time.perf_counter``)."""
    return time.perf_counter()
