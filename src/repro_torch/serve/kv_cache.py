"""KV cache managers (port of ``repro.serve.kv_cache``): the dense slot
cache and the paged block pool.

:class:`KVCache` is the dense layout: ``(L, slots + 1, max_len, KV, hd)``
k/v where every slot reserves ``max_len`` rows; the extra slot absorbs the
chunk writer's pads (the reference drops them). Positions are device state
(a step hands its final vector back through :meth:`sync`); the host
``pos_host`` mirror serves admission bookkeeping.

:class:`PagedKVCache` is the shared block pool. Host bookkeeping is the
reference's, unchanged: per-slot read and write block tables (logical page
-> physical block), a free list with per-block refcounts, and a prefix map
that lets same-tenant requests whose prompts share page-aligned prefixes
point at the same refcounted blocks. Unallocated table entries (and, in the
write table, shared pages) hold the sentinel ``num_blocks``. Device state:
the ``(L, num_blocks + 1, page, KV, hd)`` k/v pools, whose extra block at
index ``num_blocks`` absorbs every sentinel write (the reference drops them
with ``mode="drop"``; attention never reads the trash block), and the
per-slot position vector the steps carry.

``kv_dtype="int8"`` (DESIGN §15) stores k/v as int8 codes with float32
scales beside them: one per (block, kv-head) in the pool, one per (slot,
16-row group, kv-head) in the dense cache. All cache writes happen inside
the model's forward; these classes only place.
"""

from __future__ import annotations

import numpy as np
import torch

#: cache storage dtypes the engines accept: "fp32" keeps the model's
#: compute dtype, "int8" packs symmetric-absmax codes with float32 scales
KV_DTYPES = ("fp32", "int8")


def _check_kv_dtype(kv_dtype: str) -> None:
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")


def _pool_bytes(data: dict) -> int:
    """Bytes of every cache leaf without its trash row (axis 1), from the
    shapes alone: no tensor operation, so an engine's set-up dispatches
    the same operations with its metrics on or off."""
    return sum(t.element_size() * t.numel() // t.shape[1] * (t.shape[1] - 1)
               for t in data.values())


class KVCache:
    def __init__(self, model, slots: int, max_len: int, device, kv_dtype: str = "fp32"):
        _check_kv_dtype(kv_dtype)
        self.slots = slots
        self.max_len = max_len
        self.kv_dtype = kv_dtype
        self.device = torch.device(device)
        self.data = model.init_cache(slots, max_len, self.device, kv_dtype=kv_dtype)
        self.pos = torch.zeros((slots,), dtype=torch.int32, device=self.device)
        self.pos_host = np.zeros((slots,), np.int32)  # admission mirror

    def pool_bytes(self) -> int:
        """Cache bytes as the reference counts them: codes plus scales (or
        the fp k/v) of the ``slots`` real slots — the trash slot is not
        counted."""
        return _pool_bytes(self.data)

    def pool_bytes_per_shard(self) -> int:
        """Bytes one tensor-parallel shard holds: the whole cache (the port
        serves unsharded)."""
        return self.pool_bytes()

    def full(self, slot: int) -> bool:
        return self.pos_host[slot] >= self.max_len - 1

    def sync(self, pos_dev: torch.Tensor, pos_np: np.ndarray) -> None:
        """Adopt a step's final positions (device tensor and host mirror)."""
        self.pos = pos_dev
        self.pos_host[:] = pos_np

    def evict(self, slot: int) -> None:
        """Free a slot: zero its position on the host and on the device (a
        device write, no transfer). Its rows stay stale: the next owner's
        chunks overwrite them before any frontier reaches them."""
        self.pos_host[slot] = 0
        self.pos[slot] = 0

    def drained(self) -> bool:
        """Every slot idle (the dense twin of :meth:`PagedKVCache.drained`)."""
        return not self.pos_host.any()


class DraftKVCache:
    """A model drafter's scratch k/v for speculative decoding: always the
    dense ``(L, slots + 1, max_len, KV, hd)`` layout in the compute dtype,
    whatever the main cache's layout or dtype. It tracks no position: the
    drafter writes at the engine's per-slot ``pos``, rows at or past a
    slot's frontier are stale until overwritten, so a rejected draft rolls
    back for free. It needs no sharing, accounting or eviction: every
    (re-)admission's chunk steps rebuild a slot's rows."""

    def __init__(self, model, slots: int, max_len: int, device):
        self.data = model.init_cache(slots, max_len, torch.device(device))

    def pool_bytes(self) -> int:
        """k and v of the ``slots`` real slots (the trash slot not counted)."""
        return _pool_bytes(self.data)


class PagedKVCache:
    def __init__(self, model, slots: int, max_len: int, page_size: int,
                 num_blocks: int, device, kv_dtype: str = "fp32"):
        _check_kv_dtype(kv_dtype)
        self.kv_dtype = kv_dtype
        self.slots = slots
        self.max_len = max_len
        self.page_size = page_size
        self.num_blocks = num_blocks
        self.device = torch.device(device)
        self.max_pages = -(-max_len // page_size)
        if num_blocks < self.max_pages:
            raise ValueError(
                f"num_blocks {num_blocks} cannot hold one max_len={max_len} "
                f"request ({self.max_pages} pages of {page_size})"
            )
        self.data = model.init_paged_cache(num_blocks, page_size, self.device,
                                           kv_dtype=kv_dtype)
        self.pos = torch.zeros((slots,), dtype=torch.int32, device=self.device)
        self.pos_host = np.zeros((slots,), np.int32)  # admission mirror
        self.table = np.full((slots, self.max_pages), num_blocks, np.int32)
        self.wtable = np.full((slots, self.max_pages), num_blocks, np.int32)
        self.alloc_count = np.zeros((slots,), np.int32)
        self.refcount = np.zeros((num_blocks,), np.int32)
        self._free = list(range(num_blocks - 1, -1, -1))  # pop() -> 0, 1, ...
        # (adapter_id, exact token prefix) -> shared block, and back
        self._prefix: dict[tuple, int] = {}
        self._block_key: dict[int, tuple] = {}
        # a registered prefix block is attendable only once its chunk landed
        self._written = np.zeros((num_blocks,), np.bool_)
        self._table_dev = None  # device copies, re-uploaded after mutation
        self._wtable_dev = None
        # admission's page accounting, scraped into the engine's metrics:
        # full prompt pages shared with a resident block, and pages freshly
        # allocated
        self.prefix_page_hits = 0
        self.prefix_page_fresh = 0
        # chaos pool pressure (DESIGN §16): free blocks held hostage by
        # steal_blocks, unallocatable and owned by no slot
        self._stolen: list[int] = []

    # ------------------------------------------------------------- queries

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def shared_blocks(self) -> int:
        """Blocks referenced by more than one slot (live prefix reuse); the
        refcounts are a host array, so this reads no device state."""
        return int((self.refcount > 1).sum())

    def pool_bytes(self) -> int:
        """Pool bytes as the reference counts them: codes plus scales (or
        the fp k/v) of the ``num_blocks`` real blocks — the trash block is
        not counted."""
        return _pool_bytes(self.data)

    def pool_bytes_per_shard(self) -> int:
        """Bytes one tensor-parallel shard holds: the whole pool (the port
        serves unsharded)."""
        return self.pool_bytes()

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def full(self, slot: int) -> bool:
        return self.pos_host[slot] >= self.max_len - 1

    def table_device(self) -> torch.Tensor:
        if self._table_dev is None:
            self._table_dev = torch.as_tensor(self.table, device=self.device)
        return self._table_dev

    def write_table_device(self) -> torch.Tensor:
        if self._wtable_dev is None:
            self._wtable_dev = torch.as_tensor(self.wtable, device=self.device)
        return self._wtable_dev

    # ---------------------------------------------------------- allocation

    def _dirty(self) -> None:
        self._table_dev = None
        self._wtable_dev = None

    def _release(self, blk: int) -> None:
        self.refcount[blk] -= 1
        if self.refcount[blk] == 0:
            key = self._block_key.pop(blk, None)
            if key is not None:
                del self._prefix[key]
            self._written[blk] = False
            self._free.append(blk)

    def admit(self, slot: int, tokens, adapter_id: int) -> int | None:
        """Place a prompt's pages. Returns how many leading prompt tokens
        already sit in the pool (shared prefix: the chunk walk skips them),
        or None, with nothing taken, when the pool cannot cover the prompt
        or a matching prefix block is still being written.

        Full pages are looked up by ``(adapter_id, exact token prefix)``, so
        reuse never crosses tenants; a hit bumps the refcount and goes into
        the read table only (the write table keeps the sentinel)."""
        plen = len(tokens)
        n_pages = self.blocks_for(plen)
        if n_pages > self.max_pages:
            raise ValueError(
                f"prompt of {plen} tokens needs {n_pages} pages; "
                f"max_len {self.max_len} caps a slot at {self.max_pages}"
            )
        n_full = plen // self.page_size
        row = np.full((self.max_pages,), self.num_blocks, np.int32)
        wrow = np.full((self.max_pages,), self.num_blocks, np.int32)
        prefix: list[int] = []
        shared_lead = 0
        n_hit = 0
        chain_shared = True
        for j in range(n_pages):
            key = None
            if j < n_full:
                p0 = j * self.page_size
                prefix.extend(int(t) for t in tokens[p0: p0 + self.page_size])
                key = (int(adapter_id), tuple(prefix))
                shared = self._prefix.get(key)
                if shared is not None:
                    if not self._written[shared]:
                        for j2 in range(j):
                            self._release(int(row[j2]))
                        return None
                    self.refcount[shared] += 1
                    row[j] = shared
                    n_hit += 1
                    if chain_shared:
                        shared_lead = (j + 1) * self.page_size
                    continue
            chain_shared = False
            if not self._free:
                for j2 in range(j):
                    self._release(int(row[j2]))
                return None
            blk = self._free.pop()
            self.refcount[blk] = 1
            row[j] = blk
            wrow[j] = blk
            if key is not None:
                self._prefix[key] = blk
                self._block_key[blk] = key
        self.table[slot] = row
        self.wtable[slot] = wrow
        self.alloc_count[slot] = n_pages
        self.prefix_page_hits += n_hit
        self.prefix_page_fresh += n_pages - n_hit
        self._dirty()
        return shared_lead

    def mark_prefilled(self, slot: int, n_tokens: int) -> None:
        """Owned pages entirely below ``n_tokens`` are written: from now on
        same-tenant admissions may share them."""
        wrow = self.wtable[slot]
        for j in range(min(n_tokens // self.page_size, self.max_pages)):
            if wrow[j] != self.num_blocks:
                self._written[wrow[j]] = True

    def reserve(self, slot: int, target_len: int) -> bool:
        """Extend a slot's tables to cover ``target_len`` positions; keeps
        partial progress on failure (the engine preempts and retries)."""
        need = self.blocks_for(target_len)
        while self.alloc_count[slot] < need:
            if not self._free:
                return False
            blk = self._free.pop()
            self.refcount[blk] = 1
            self.table[slot, self.alloc_count[slot]] = blk
            self.wtable[slot, self.alloc_count[slot]] = blk
            self.alloc_count[slot] += 1
            self._dirty()
        return True

    def sync(self, pos_dev: torch.Tensor, pos_np: np.ndarray) -> None:
        """Adopt a step's final positions (device tensor and host mirror)."""
        self.pos = pos_dev
        self.pos_host[:] = pos_np

    def evict(self, slot: int) -> None:
        """Return a slot's blocks (refcounted), reset its tables and zero
        its position on the host and on the device (a device write, no
        transfer), so an idle slot's frontier never reaches a page."""
        for j in range(int(self.alloc_count[slot])):
            self._release(int(self.table[slot, j]))
        self.table[slot] = self.num_blocks
        self.wtable[slot] = self.num_blocks
        self.alloc_count[slot] = 0
        self.pos_host[slot] = 0
        self.pos[slot] = 0
        self._dirty()

    # -------------------------------------------- chaos hooks (DESIGN §16)

    @property
    def stolen_blocks(self) -> int:
        return len(self._stolen)

    def steal_blocks(self, n: int) -> int:
        """Chaos pool pressure: pull up to ``n`` blocks off the free list and
        hold them, unallocatable and owned by no slot, so reserve() and
        admission come up short as in a fuller pool. Returns how many were
        taken; :meth:`restore_blocks` gives them back."""
        take = min(max(n, 0), len(self._free))
        for _ in range(take):
            self._stolen.append(self._free.pop())
        return take

    def restore_blocks(self, n: int | None = None) -> int:
        """Return stolen blocks (all of them by default) to the free list."""
        back = len(self._stolen) if n is None else min(n, len(self._stolen))
        for _ in range(back):
            self._free.append(self._stolen.pop())
        return back

    def drained(self) -> bool:
        """Every block free with zero refcount, every table entry the
        sentinel, no prefix registered, nothing stolen (so a leak cannot
        pass for chaos pressure)."""
        return (
            not self._stolen
            and len(self._free) == self.num_blocks
            and not self.refcount.any()
            and bool((self.table == self.num_blocks).all())
            and bool((self.wtable == self.num_blocks).all())
            and not self.alloc_count.any()
            and not self._prefix
            and not self._block_key
        )
