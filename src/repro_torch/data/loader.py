"""Host-sharded, prefetching, restart-deterministic data loader.

Each host generates only its batch slice (``host_id``/``host_count``), the
stream is a pure function of (seed, step) so resuming from a checkpoint at
step N replays the exact remaining stream, and a background thread keeps
``prefetch`` batches ready.

The port's own copy of ``repro.data.loader`` (numpy only).
"""

from __future__ import annotations

import queue
import threading


from repro_torch.data.synthetic import TASKS


class DataLoader:
    def __init__(
        self,
        task: str,
        vocab: int,
        global_batch: int,
        seq: int,
        *,
        seed: int = 0,
        host_id: int = 0,
        host_count: int = 1,
        start_step: int = 0,
        prefetch: int = 2,
        **task_kw,
    ):
        if global_batch % host_count:
            raise ValueError(f"global_batch {global_batch} % hosts {host_count} != 0")
        self.task_fn = TASKS[task]
        self.vocab, self.seq = vocab, seq
        self.global_batch = global_batch
        self.local_batch = global_batch // host_count
        self.host_id, self.host_count = host_id, host_count
        self.seed = seed
        self.step = start_step
        self.task_kw = task_kw
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _make(self, step: int) -> dict:
        # Generate the GLOBAL batch deterministically, slice this host's rows
        # (cheap at these sizes; real text pipelines shard at the file level).
        batch = self.task_fn(
            self.vocab, self.global_batch, self.seq, self.seed, step, **self.task_kw
        )
        lo = self.host_id * self.local_batch
        hi = lo + self.local_batch
        return {k: v[lo:hi] if v.ndim >= 1 and v.shape[0] == self.global_batch else v
                for k, v in batch.items()}

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            b = self._make(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self) -> dict:
        step, b = self._q.get()
        self.step = step + 1
        return b

    def __iter__(self):
        return self

    def close(self):
        self._stop.set()


def peek_batch(task: str, vocab: int, batch: int, seq: int, seed: int = 0, **kw) -> dict:
    """One batch without a loader thread (tests/benchmarks)."""
    return TASKS[task](vocab, batch, seq, seed, 0, **kw)
