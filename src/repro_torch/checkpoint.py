"""npz trees in the reference's on-disk format, and the step-indexed
checkpoints of a training run (port of ``repro.checkpoint.manager``).

A tree flattens to path-keyed arrays (``"blocks/wq/w"``). ``None`` leaves
are stored as the string ``"__none__"``; bf16 leaves, which numpy cannot
hold natively, as their raw bits in uint16 plus a ``"__dtype__/<key>"``
sidecar naming the dtype; a packed (int8 or NF4) leaf as ``<key>/data``
and ``<key>/scales`` plus a ``"__quant__/<key>"`` JSON sidecar holding
``[qdtype, block, dtype_name]``. Files written by either package load in
the other, packed leaves byte for byte. Reading needs no ``ml_dtypes``:
the uint16 bits are viewed as ``torch.bfloat16`` directly. Named tuples
(``TrainState``, ``AdamWState``) flatten to their field names, as the
reference's ``GetAttrKey`` paths do, so a training checkpoint
(``trainable/...``, ``opt_state/step|mu|nu/...``) resumes in either
package.

:class:`CheckpointManager` keeps ``ckpt_{step:08d}.npz`` files under a
directory, the last ``keep`` of them, and writes on a background thread,
one write in flight. The copy from the device to host memory happens on
the calling thread before the writer starts, so the writer never touches
a CUDA tensor (and the training step may go on changing the state in
place); a write error surfaces at the next :meth:`CheckpointManager.wait`.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import torch

from repro_torch.quant.qtensor import QuantizedTensor
from repro_torch.tree import flatten, is_namedtuple, path_str, unflatten

_SENTINEL_NONE = "__none__"
_DTYPE_KEY = "__dtype__"
_QUANT_KEY = "__quant__"


def _to_numpy(leaf, flat: dict, key: str) -> None:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            flat[f"{_DTYPE_KEY}/{key}"] = np.array("bfloat16")
            flat[key] = t.view(torch.int16).numpy().view(np.uint16)
            return
        flat[key] = t.numpy()
        return
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        flat[f"{_DTYPE_KEY}/{key}"] = np.array("bfloat16")
        flat[key] = arr.view(np.uint16)
    else:
        flat[key] = arr


def save_pytree(path: str, tree, metadata: dict | None = None) -> None:
    """Atomic write of ``tree`` (torch tensors, numpy arrays or ``None``)."""
    flat: dict[str, np.ndarray] = {}
    for p, leaf in flatten(tree):
        key = path_str(p)
        if leaf is None:
            flat[key] = np.array(_SENTINEL_NONE)
        elif isinstance(leaf, QuantizedTensor):
            flat[f"{_QUANT_KEY}/{key}"] = np.array(
                json.dumps([leaf.qdtype, leaf.block, leaf.dtype_name]))
            _to_numpy(leaf.data, flat, f"{key}/data")
            _to_numpy(leaf.scales, flat, f"{key}/scales")
        else:
            _to_numpy(leaf, flat, key)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    if metadata is not None:
        mtmp = path + ".meta.tmp"
        with open(mtmp, "w") as f:
            json.dump(metadata, f)
        os.replace(mtmp, path + ".meta.json")


def _sidecars(flat: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: str(v) for k, v in flat.items()
            if k.startswith(prefix + "/")}


def load_pytree(path: str) -> dict:
    """-> nested dict of CPU torch tensors (``None`` where stored so, a
    :class:`QuantizedTensor` for a packed leaf)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    dtypes = _sidecars(flat, _DTYPE_KEY)
    quant = {k: json.loads(v) for k, v in _sidecars(flat, _QUANT_KEY).items()}
    pairs = []
    for key, val in flat.items():
        if key.startswith((_DTYPE_KEY + "/", _QUANT_KEY + "/")):
            continue
        if val.dtype.kind == "U" and str(val) == _SENTINEL_NONE:
            leaf = None
        elif key in dtypes:
            if dtypes[key] != "bfloat16":
                raise ValueError(f"{path}: leaf {key} has unsupported dtype "
                                 f"{dtypes[key]!r}")
            leaf = torch.from_numpy(val.view(np.int16).copy()).view(torch.bfloat16)
        else:
            leaf = torch.from_numpy(np.array(val))  # a 0-d leaf stays 0-d
        pairs.append((tuple(key.split("/")), leaf))
    tree = unflatten(pairs)
    for key, (qdtype, block, dtype_name) in quant.items():
        *parents, last = key.split("/")
        node = tree
        for p in parents:
            node = node[p]
        packed = node[last]  # {"data": …, "scales": …} built above
        node[last] = QuantizedTensor(packed["data"], packed["scales"], qdtype, int(block),
                                     dtype_name)
    return tree


def restore_into(template, restored, path: tuple = ()):
    """``restored`` (a nested dict from :func:`load_pytree`, named tuples
    flattened to field names) back in ``template``'s structure: dicts and
    named tuples as the template has them, every leaf on the template
    leaf's device in its dtype. ``None`` in either tree gives ``None``. A
    packed template leaf takes only a packed leaf of the same scheme and
    block, a dense one only a dense leaf (the reference's errors)."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: restore_into(v, restored[k], path + (k,)) for k, v in template.items()}
    if is_namedtuple(template):
        return type(template)(*(restore_into(getattr(template, f), restored[f], path + (f,))
                                for f in template._fields))
    if restored is None:
        return None
    where = list(path)
    if isinstance(template, QuantizedTensor):
        if not isinstance(restored, QuantizedTensor):
            raise ValueError(f"checkpoint leaf at {where} is dense but the template expects "
                             "a packed QuantizedTensor")
        if (restored.qdtype, restored.block) != (template.qdtype, template.block):
            raise ValueError(
                f"checkpoint leaf at {where} is packed as {restored.qdtype}/block="
                f"{restored.block} but the template expects {template.qdtype}/block="
                f"{template.block} — restore with the same --base-dtype/--quant-block")
        dev = template.device
        return QuantizedTensor(restored.data.to(dev, template.data.dtype),
                               restored.scales.to(dev, template.scales.dtype), restored.qdtype,
                               restored.block, restored.dtype_name)
    if isinstance(restored, QuantizedTensor):
        raise ValueError(
            f"checkpoint leaf at {where} is a packed QuantizedTensor but the template expects "
            "a dense array — restore with a quantized template (same --base-dtype as the run "
            "that wrote the checkpoint)")
    return torch.as_tensor(restored).to(device=template.device, dtype=template.dtype)


def _to_host(tree):
    """``tree`` as nested dicts (named tuples opened by field name) with
    every tensor, packed leaves' included, copied to host memory."""
    def host(x):
        if isinstance(x, QuantizedTensor):
            return QuantizedTensor(host(x.data), host(x.scales), x.qdtype, x.block,
                                   x.dtype_name)
        if isinstance(x, torch.Tensor):  # a copy even on the CPU
            return x.detach().to("cpu", copy=True)
        return x

    return unflatten([(p, host(x)) for p, x in flatten(tree)])


class CheckpointManager:
    """Step-indexed checkpoints under ``directory``: keep-last-``keep``,
    one asynchronous write in flight, resume from the latest.
    ``last_copy_s`` / ``last_write_s`` time the last save's device-to-host
    copy (calling thread) and file write (writer thread)."""

    def __init__(self, directory: str, *, keep: int = 3, async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._pending: threading.Thread | None = None
        self._error: BaseException | None = None
        self.last_copy_s = self.last_write_s = 0.0
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.npz")

    def steps(self) -> list[int]:
        return sorted(int(f[5:13]) for f in os.listdir(self.dir)
                      if f.startswith("ckpt_") and f.endswith(".npz"))

    def wait(self) -> None:
        """Join the write in flight; raise its error, if it failed."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def save(self, step: int, tree, metadata: dict | None = None) -> None:
        self.wait()  # one write in flight
        t0 = time.perf_counter()
        host_tree = _to_host(tree)
        self.last_copy_s = time.perf_counter() - t0
        meta = dict(metadata or {}, step=step)

        def write():
            try:
                t1 = time.perf_counter()
                save_pytree(self._path(step), host_tree, meta)
                self._gc()
                self.last_write_s = time.perf_counter() - t1
            except BaseException as e:  # surfaced at the next wait()
                self._error = e

        if self.async_write:
            self._pending = threading.Thread(target=write, daemon=True)
            self._pending.start()
        else:
            write()

    def _gc(self) -> None:
        for s in self.steps()[: -self.keep]:
            for suffix in (".npz", ".npz.meta.json"):
                p = os.path.join(self.dir, f"ckpt_{s:08d}{suffix}")
                if os.path.exists(p):
                    os.remove(p)

    def restore_latest(self):
        """-> (step, tree of CPU tensors) of the latest checkpoint, or
        (None, None); :func:`restore_into` puts it in place."""
        self.wait()
        steps = self.steps()
        if not steps:
            return None, None
        return steps[-1], load_pytree(self._path(steps[-1]))
