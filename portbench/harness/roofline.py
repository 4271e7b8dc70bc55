"""The yardstick's arithmetic: the H100's published peaks, the least time a
piece of work can take, and the work of each kernel and of a whole step
counted from the configuration and the traffic's shapes (never from
launches), so the same work is counted whatever implements it.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W limit): 989
TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM3 (every counted
kernel and step runs in bf16). A kernel's bytes count each input byte read once and
each output byte written once; where the work depends on the data (a
bypass reads only the rows its indices name) it counts what these inputs
need.
"""

from __future__ import annotations

from .arch import Arch, capacity, num_groups

PEAK_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16, I32 = 2, 4

# the kernels' names in the device trace; "!" leaves a name out
KERNELS = {
    "fused_linear": ("fused_linear_bf16_kernel", "fused_linear_f32_kernel",
                     "linear_wgmma_kernel", "!PackedW"),
    "sparse_delta_dval": ("dval_kernel",),
}


def least_seconds(nbytes: float, flops: float, peak: float = PEAK_BF16) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)


def roofline_share(work: list[tuple[float, float]], seconds: float) -> float | None:
    """Percent of ``seconds`` that the least time of ``work`` ((bytes,
    flops) pairs, one a launch's worth) takes; None without device time."""
    if seconds <= 0 or not work:
        return None
    return 100.0 * sum(least_seconds(b, f) for b, f in work) / seconds


def fused_linear_work(arch: Arch, rows: int, unique: dict) -> list[tuple[float, float]]:
    """One training forward's fused projections (x @ W + the bypass + the
    bias), each layer's: the attention's four, and the MLP's three on a
    dense model (an expert stack runs a batched product instead)."""
    names = ["wq", "wk", "wv", "wo"] + ([] if arch.experts else ["wgate", "wup", "wdown"])
    shapes = arch.linear_shapes()
    out = []
    for name in names:
        k_in, n = shapes[name]
        bias = n * BF16 if arch.qkv_bias and name in ("wq", "wk", "wv") else 0
        nbytes = (rows * k_in + k_in * n + rows * n) * BF16 + unique["k"] * n * (I32 + BF16)
        flops = 2.0 * rows * n * (k_in + unique["k"])
        out += [(nbytes + bias, flops)] * arch.layers
    return out


def expert_rows(arch: Arch, tokens: int) -> int:
    """Buffer rows of each expert for ``tokens`` routed tokens (groups x
    capacity): what the expert products and their bypasses are given."""
    g = num_groups(tokens, arch.top_k)
    return g * capacity(arch, tokens // g)


def dval_work(arch: Arch, rows: int, unique: dict) -> list[tuple[float, float]]:
    """One training backward's value gradients, one an adapted matrix:
    dval[j, o] = Σ_m x[m, idx[j, o]] · dy[m, o]. ``unique[name]`` holds the
    distinct input rows the indices name (a layer's, or an expert's: a
    list), ``unique["k"]`` the k."""
    k = unique["k"]
    shapes = arch.linear_shapes()
    out = []
    for name, shape in shapes.items():
        if name == "router":
            continue
        k_in, n = shape[-2:]
        if arch.experts and name in ("wgate", "wup", "wdown"):
            r = expert_rows(arch, rows)
            for layer in unique[name]:
                xr = sum(r * u for u in layer)
                e = arch.experts
                out.append(((e * r * n + xr) * BF16 + e * k * n * (I32 + BF16),
                            2.0 * e * r * k * n))
            continue
        for u in unique[name]:
            out.append(((rows * n + rows * u) * BF16 + k * n * (I32 + BF16), 2.0 * rows * k * n))
    if not arch.tied:
        n = arch.padded_vocab
        u = unique["head"][0]
        out.append(((rows * n + rows * u) * BF16 + k * n * (I32 + BF16), 2.0 * rows * k * n))
    return out


def active_params(arch: Arch) -> int:
    """Weights one token multiplies through in the layers (the attention's
    four, the MLP or the router and its K experts); the head apart."""
    shapes = arch.linear_shapes()
    n = 0
    for name, shape in shapes.items():
        k_in, d_out = shape[-2:]
        per = k_in * d_out
        if arch.experts and name in ("wgate", "wup", "wdown"):
            per *= arch.top_k
        n += per
    return n * arch.layers


def head_params(arch: Arch) -> int:
    return arch.d_model * arch.vocab


def attention_pair_flops(arch: Arch) -> float:
    """Forward flops of one (query, key) pair over every layer's heads:
    q·k and p·v."""
    return 4.0 * arch.heads * arch.head_dim * arch.layers


def train_step_flops(arch: Arch, batch: int, seq: int) -> float:
    """Useful flops of one training step with frozen weights: the forward
    (2 a weight a token) and the input gradient (2 more), layers and head;
    causal attention forward (q·k, p·v) and backward (twice that). No
    weight gradient, no recomputation."""
    t = batch * seq
    pairs = batch * seq * (seq + 1) / 2
    return 4.0 * (active_params(arch) + head_params(arch)) * t \
        + 3.0 * attention_pair_flops(arch) * pairs
