"""Quantized frozen-base storage: blockwise int8 / NF4 weight compression
(port of ``repro.quant.qtensor``).

Only the sparse ``(idx, val)`` bypass trains, so the frozen matrices can be
stored in int8 or NF4 without touching the optimisation problem (DESIGN.md
§8). A weight ``W (..., d_in, d_out)`` is quantized *blockwise per output
channel*: ``d_in`` is cut into blocks of ``block`` rows (zero-padded at the
end) and each ``(block, 1)`` column slice gets one float32 absmax scale, so
``scales`` is ``(..., ceil(d_in / block), d_out)``:

* ``int8``: ``q = round(W / s)``, ``s = absmax / 127``, clipped to ±127;
* ``nf4``: 4-bit NormalFloat, ``s = absmax``, two codes to a uint8 along
  ``d_in`` (row ``2i`` in the low nibble, ``2i + 1`` in the high one).

The arithmetic follows the reference op for op (float32, a true divide by
the safe scale, round half to even, 15 float32 ``>`` compares against the
codebook midpoints), so packing is byte-identical in both packages and a
packed checkpoint crosses between them unchanged.

:class:`QuantizedTensor` is a plain class, not a tuple: ``qt[i]`` slices
``data`` and ``scales`` on the leading (layer) axis, which is how the layer
loop takes per-layer views of a stacked ``(L, …)`` leaf.
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.tree import flatten, map_leaves, path_str, unflatten

# QLoRA Appendix E: 16 quantiles of N(0, 1) renormalised to [-1, 1], with an
# exact zero (the reference's table, copied: the port imports nothing of it).
NF4_CODES = np.array(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
        0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
        0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
        0.7229568362236023, 1.0,
    ],
    np.float32,
)
# decision boundaries: midpoints between adjacent codes, in float32
NF4_BOUNDARIES = (NF4_CODES[1:] + NF4_CODES[:-1]) / np.float32(2.0)

QDTYPES = ("int8", "nf4")
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16"}
_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


class QuantizedTensor:
    """Packed codes and per-block scales of one (possibly layer-stacked)
    weight.

    ``data``   — int8 ``(..., d_in, d_out)`` or uint8 ``(..., d_in/2, d_out)``
    ``scales`` — float32 ``(..., ceil(d_in/block), d_out)``
    ``qdtype``, ``block`` and ``dtype_name`` — the scheme, the rows per
    scale block and the logical (dequantized) dtype, e.g. ``"bfloat16"``.
    """

    __slots__ = ("data", "scales", "qdtype", "block", "dtype_name")

    def __init__(self, data: torch.Tensor, scales: torch.Tensor, qdtype: str = "int8",
                 block: int = 64, dtype_name: str = "float32"):
        self.data = data
        self.scales = scales
        self.qdtype = qdtype
        self.block = int(block)
        self.dtype_name = dtype_name

    # --- the logical matrix's shape and dtype (selection, shape checks)
    @property
    def shape(self) -> tuple[int, ...]:
        s = tuple(self.data.shape)
        if self.qdtype == "nf4":
            return s[:-2] + (2 * s[-2],) + s[-1:]
        return s

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype_name]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def numel(self) -> int:
        """Logical element count (the dequantized matrix's)."""
        return int(np.prod(self.shape))

    def is_floating_point(self) -> bool:
        return self.dtype.is_floating_point

    @property
    def nbytes(self) -> int:
        """Packed storage: data + scales."""
        return (self.data.numel() * self.data.element_size()
                + self.scales.numel() * self.scales.element_size())

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.data.to(device), self.scales.to(device), self.qdtype,
                               self.block, self.dtype_name)

    def __getitem__(self, i) -> "QuantizedTensor":
        """One slice of the leading axis (a layer of an (L, d_in, d_out)
        stack, or an (E, d_in, d_out) layer of an (L, E, d_in, d_out) expert
        stack); the matrix axes stay whole."""
        if self.data.ndim < 3:
            raise IndexError(f"a {self.data.ndim}-d QuantizedTensor has no layer axis")
        return QuantizedTensor(self.data[i], self.scales[i], self.qdtype, self.block,
                               self.dtype_name)

    def __repr__(self) -> str:
        return (f"QuantizedTensor({self.qdtype}, shape={self.shape}, block={self.block}, "
                f"dtype={self.dtype_name}, device={self.device})")


def _blocked(w: torch.Tensor, block: int) -> tuple[torch.Tensor, int]:
    """(..., d_in, d_out) -> (..., n_blocks, block, d_out), zero-padded."""
    d_in = w.shape[-2]
    n_blocks = -(-d_in // block)
    pad = n_blocks * block - d_in
    if pad:
        w = F.pad(w, (0, 0, 0, pad))
    return w.reshape(*w.shape[:-2], n_blocks, block, w.shape[-1]), d_in


def quantize(w: torch.Tensor, qdtype: str = "int8", block: int = 64) -> QuantizedTensor:
    """Blockwise per-channel symmetric quantization along ``d_in`` (axis -2),
    on ``w``'s device. A stack (``ndim > 2``: layers, or layers × experts)
    packs one leading slice at a time, so the float32 intermediates never
    span the whole stack (an olmoe expert stack is 4.3 GB in bf16)."""
    if qdtype not in QDTYPES:
        raise ValueError(f"qdtype {qdtype!r} not in {QDTYPES}")
    if block < 2 or block % 2:
        raise ValueError(f"block must be even and >= 2, got {block}")
    if w.ndim < 2:
        raise ValueError(f"quantize wants a (..., d_in, d_out) matrix, got {tuple(w.shape)}")
    if w.dtype not in _DTYPE_NAMES:
        raise TypeError(f"quantize wants a float32/bf16/fp16 matrix, got {w.dtype}")
    if qdtype == "nf4" and w.shape[-2] % 2:
        raise ValueError(f"nf4 packing needs an even d_in, got {w.shape[-2]}")
    if w.ndim == 2:
        return _quantize(w, qdtype, block)
    parts = [_quantize(w[i], qdtype, block) for i in range(w.shape[0])]
    return QuantizedTensor(torch.stack([q.data for q in parts]),
                           torch.stack([q.scales for q in parts]), qdtype, block,
                           _DTYPE_NAMES[w.dtype])


def _quantize(w: torch.Tensor, qdtype: str, block: int) -> QuantizedTensor:
    dtype_name = _DTYPE_NAMES[w.dtype]
    wb, d_in = _blocked(w.float(), block)  # (..., nb, block, d_out)
    absmax = wb.abs().amax(dim=-2)  # (..., nb, d_out)
    one = torch.ones((), dtype=torch.float32, device=w.device)
    if qdtype == "int8":
        # a divisor on w's device: torch turns division by a host scalar on
        # the card into a multiply by its reciprocal, which can differ in
        # the last bit from the reference's divide
        scales = absmax / torch.full((), 127.0, device=w.device)
        safe = torch.where(scales > 0, scales, one)
        q = torch.round(wb / safe[..., None, :]).clamp(-127, 127).to(torch.int8)
        data = q.reshape(*q.shape[:-3], -1, q.shape[-1])[..., :d_in, :].contiguous()
        return QuantizedTensor(data, scales, "int8", block, dtype_name)
    scales = absmax
    safe = torch.where(scales > 0, scales, one)
    normed = wb / safe[..., None, :]
    codes = torch.zeros(normed.shape, dtype=torch.uint8, device=w.device)
    for b in torch.from_numpy(NF4_BOUNDARIES).to(w.device):  # 15 float32 compares
        codes += (normed > b).to(torch.uint8)
    codes = codes.reshape(*codes.shape[:-3], -1, codes.shape[-1])[..., :d_in, :]
    data = codes[..., 0::2, :] | (codes[..., 1::2, :] << 4)
    return QuantizedTensor(data.contiguous(), scales.contiguous(), "nf4", block, dtype_name)


def unpack_nf4(data: torch.Tensor) -> torch.Tensor:
    """uint8 (..., d_in/2, d_out) -> int64 codes (..., d_in, d_out)."""
    lo = (data & 0xF).long()
    hi = ((data >> 4) & 0xF).long()
    inter = torch.stack([lo, hi], dim=-2)  # (..., d_in/2, 2, d_out)
    return inter.reshape(*inter.shape[:-3], -1, inter.shape[-1])


_NF4_TABLES: dict = {}  # the codebook on each device it was used on


def _nf4_table(device) -> torch.Tensor:
    """NF4_CODES on ``device``, copied there once: a serving step's
    dequantize then makes no host-to-device copy (which waits for the
    host)."""
    table = _NF4_TABLES.get(device)
    if table is None:
        table = _NF4_TABLES[device] = torch.from_numpy(NF4_CODES).to(device)
    return table


def dequantize_f32(data: torch.Tensor, scales: torch.Tensor, qdtype: str,
                   block: int) -> torch.Tensor:
    """The float32 matrix ``code × scale`` (..., d_in, d_out), before any
    cast."""
    if qdtype == "nf4":
        wf = _nf4_table(data.device)[unpack_nf4(data)]
    else:
        wf = data.float()
    s = scales.float().repeat_interleave(block, dim=-2)
    return wf * s[..., : wf.shape[-2], :]


def dequantize(qt: QuantizedTensor) -> torch.Tensor:
    """The logical (..., d_in, d_out) matrix in ``qt.dtype``."""
    return dequantize_f32(qt.data, qt.scales, qt.qdtype, qt.block).to(qt.dtype)


# ----------------------------------------------------------------- trees

# The linear-weight policy shared with adapter selection (core.adapt):
# only ``…/w`` matrices; embeddings gather rows and routers are tiny and
# load-balance-sensitive, so both stay in the compute dtype.
DEFAULT_QUANT_EXCLUDE = (r".*embed.*", r".*router.*")


def is_linear_weight(name: str, leaf, exclude=DEFAULT_QUANT_EXCLUDE) -> bool:
    """A ``…/w`` floating matrix (dense or packed) outside ``exclude``."""
    if not name.endswith("/w"):
        return False
    if not isinstance(leaf, (torch.Tensor, QuantizedTensor)) or leaf.ndim < 2:
        return False
    if not leaf.is_floating_point():
        return False
    return not any(re.fullmatch(p, name) for p in exclude)


def quantize_tree(tree, qdtype: str, block: int, predicate):
    """Quantize every leaf with ``predicate(name, leaf)``; packed leaves
    pass through unchanged."""
    out = []
    for path, leaf in flatten(tree):
        if (leaf is not None and not isinstance(leaf, QuantizedTensor)
                and predicate(path_str(path), leaf)):
            leaf = quantize(leaf, qdtype, block)
        out.append((path, leaf))
    return unflatten(out)


def dequantize_tree(tree):
    """Packed leaves -> dense matrices in their logical dtype."""
    return map_leaves(lambda x: dequantize(x) if isinstance(x, QuantizedTensor) else x, tree)


def any_quantized(tree) -> bool:
    return any(isinstance(x, QuantizedTensor) for _, x in flatten(tree))


def tree_bytes(tree) -> int:
    """Storage bytes of a tree, packed bytes for quantized leaves."""
    total = 0
    for _, x in flatten(tree):
        if isinstance(x, QuantizedTensor):
            total += x.nbytes
        elif x is not None:
            total += x.numel() * x.element_size()
    return total
