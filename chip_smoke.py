#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one card

Phases, in order, with no fallback anywhere (any failure exits non-zero):

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compile the hand-written CUDA kernels from the seven sources in
   ``src/repro_torch/kernels/csrc`` (timed; eleven entry points);
3. kernels: each kernel against its plain PyTorch version on the card at
   the full-width qwen2-1.5b shapes (bf16 and fp32) — the three serving
   kernels at the serving shapes (ragged frontiers, shared and sentinel
   pages), the int8 bodies of the paged decode and prefill (int8 pools,
   an all-zero page) at the same shapes, the dense decode over an (8,
   Smax, 2, 128) slot cache with bf16 and int8 KV (frontiers 0, 1 and
   Smax, an fp Smax of 1000), ``fused_linear`` and ``sparse_delta_dval`` on ragged shapes
   (row, column and K tails) and at every projection of a training step
   (M = 4 x 512 rows; wdown's K = 8960 included), ``fused_linear_q`` (int8
   and NF4) on ragged shapes (scale blocks 2-128 crossing K tiles, k 0-3)
   and at every projection at M = 2048 (training, bypass k = 1) and M = 8
   (decode rows, no bypass); ``sparse_delta`` and the batched
   ``sparse_delta_dval`` on ragged shapes (B 1, 3 and 64) and at the
   olmoe-1b-7b training shapes (three expert linears over (64, 320, ·)
   buffers, the untied head over 2048 rows; dval's 2-D call equal to its
   B = 1 call bit for bit), and the earlier kernels at olmoe's shapes
   (paged attention with 16/16 heads, ``fused_linear`` 2048², the batched
   apply over 256 stacked (tenant, expert) adapters) — then timed beside
   its plain version, its bound and a one-call PyTorch yardstick where
   there is one (the port never calls it);
4. reduced serving: reduced qwen2-1.5b in fp32 through the paged
   multi-tenant engine on the card (kernels) and on the CPU (plain
   versions): greedy tokens must be identical; then the same on an int8
   and on an NF4 base (each engine packs its own copy; every base matmul
   through ``fused_linear_q``, 7 a layer-forward); then with int8 KV on the
   paged pool (also on an int8 base) and with bf16 and int8 KV on the dense
   slot cache, each run launching only its own attention bodies; the paged
   and dense int8 runs' tokens must be identical;
5. full serving: qwen2-1.5b at full published width in bf16, random
   weights from a seed, 3 NeuroAda tenants plus the base, 8 slots,
   ``max_len`` 1024, prompts of 40-700 tokens: every request ends, all
   three serving kernels launched, no plain version called, one
   device-to-host transfer per step (every forward and token draw under
   ``torch.cuda.set_sync_debug_mode("error")``, so no hidden one), the
   block pool fully free at the end;
   the same run again under ``torch.profiler`` (device time by kernel);
   then a longer, decode-dominated window (16 requests x 128 new tokens)
   served twice, for the median and spread of tokens/s; then the
   same tenants, prompts and settings on an int8 and on an NF4 base
   (``ServeEngine(base_dtype=...)``): the gate run (every base matmul
   through ``fused_linear_q``, 7 a layer-forward) and one window run;
   between them, the same tenants, prompts and settings on the paged pool
   with int8 KV and on the dense slot cache with bf16 and int8 KV: the
   gate run (its attention kernels launched and no other, pool bytes as
   reckoned: 234,881,024 bf16, 117,669,888 int8), the same run profiled
   (busy share, launches per layer-forward) and one window run;
6. reduced training: reduced qwen2-1.5b in fp32, the same params and three
   batches trained on the card (kernels) and on the CPU (plain versions),
   on the fp32, an int8 and an NF4 base: losses within 1e-5, final values
   within 1e-5 relative;
7. full training: qwen2-1.5b at full width and depth in bf16, NeuroAda
   k = 1 (magnitude), task ``lm``, batch 4 x seq 512: 2 warm-up steps, 10
   measured (losses, step time, tokens/s, peak memory, launches per step:
   196 of each training kernel, no plain call), one profiled step (device
   busy share); then the trained adapter is exported and served as a
   tenant beside the base. The same on an int8 and on an NF4 base
   (``fused_linear_q`` in place of ``fused_linear``, the packed base
   unchanged by every step, peak memory below the bf16 base's);
8. MoE: reduced olmoe-1b-7b in fp32 trained three steps on the card and
   on the CPU (losses within 1e-5, values within 1e-4 relative) and served
   with 2 tenants (greedy tokens identical); then full-width olmoe-1b-7b
   in bf16, random weights from a seed: selection at k = 1 over the
   expert stacks and the untied head, 2 warm-up + 10 measured steps at
   batch 4 x seq 512 (64 ``fused_linear``, 49 ``sparse_delta`` and 113
   ``sparse_delta_dval`` launches a step, no plain call, finite losses),
   one profiled step; its adapter served beside 2 random tenants and the
   base with phase 5's settings (every request ends, one transfer a step
   and no hidden one, as in phase 5, the pool drains, pool bytes
   1,073,741,824 as reckoned), profiled, and one window run.

The second-to-last line of output is the kernels JSON line, the last line
``{"ok": true, "device": {...}}``; the kernels line has a row for each of
the eleven kernels; the rows of kernels olmoe also runs carry an ``olmoe``
entry (ms, plain ms and bound at olmoe's shapes, launches in its training
steps or serving gate run). Detailed per-shape kernel results go to
``chiprun_out/chip_smoke_kernels.json``, the windows' runs to
``chiprun_out/window*.json``. Exits non-zero without CUDA, and
outside a checkout of the repository (the package is not importable).
The training phases write ``train*.json`` and ``train*_profile.txt`` to
the same directory, the MoE serving ``full_profile_olmoe.txt`` and
``window_olmoe.json``.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import PeftConfig, TrainConfig, get_config, reduced  # noqa: E402
from repro_torch.core.adapt import init_adapters  # noqa: E402
from repro_torch.data import TASKS, DataLoader  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    ATTENTION,
    COUNTERS,
    PACKED_BASE,
    SERVING,
    SINGLE_TENANT,
    TRAINING,
    build,
    reset_counters,
)
from repro_torch.kernels import decode_attention as dec_mod  # noqa: E402
from repro_torch.kernels import dense_decode_attention as dd_mod  # noqa: E402
from repro_torch.kernels import fused_linear as fl_mod  # noqa: E402
from repro_torch.kernels import prefill_attention as pre_mod  # noqa: E402
from repro_torch.kernels import quant_linear as ql_mod  # noqa: E402
from repro_torch.kernels import sparse_delta as sd_mod  # noqa: E402
from repro_torch.kernels.ref import gather_paged_kv  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.layers import quant_kv_page  # noqa: E402
from repro_torch.peft import (  # noqa: E402
    export_adapter,
    get_peft,
    load_adapter,
    quantize_base,
    stats,
)
from repro_torch.quant import QuantizedTensor, dequantize, quantize, tree_bytes  # noqa: E402
from repro_torch.serve import AdapterStore, ServeEngine  # noqa: E402
from repro_torch.serve.sampler import Sampler  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402
from repro_torch.tree import flatten, map_leaves  # noqa: E402

OUT_DIR = os.path.join(ROOT, "chiprun_out")
# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and dense bf16
# tensor-core rate; fp32 work outside the tensor cores runs at 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

# full-width serving shape of qwen2-1.5b (configs/qwen2_1p5b.py)
SLOTS, MAX_LEN, PAGE, PREFILL_CHUNK, DECODE_CHUNK = 8, 1024, 16, 256, 8
N_TENANTS, K_DELTA = 3, 2
# full-width training step: batch x seq rows through every projection
TRAIN_BATCH, TRAIN_SEQ, TRAIN_K, TRAIN_LR = 4, 512, 1, 3e-3
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
# the packed bases, with the launchers' default scale block
PACKED, QUANT_BLOCK = ("int8", "nf4"), 64


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def self_device_us(event) -> float:
    if hasattr(event, "self_device_time_total"):
        return event.self_device_time_total
    return event.self_cuda_time_total


def device_kernels(prof) -> list:
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def cuda_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: the summed durations of the
    kernels it launches (CUPTI, through ``torch.profiler``), averaged over
    ``iters`` calls. Host time between launches is not counted, so a
    small kernel's time is its own and not the Python wrapper's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # a profiling session now and then records no kernel at all (seen once
    # in a run of ~60 sessions); take the next session then, never a zero
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(self_device_us(e) for e in device_kernels(prof))
        if total > 0:
            return total / iters / 1e3
    raise RuntimeError("torch.profiler recorded no device time in 3 sessions")


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name: str, got, want, dtype) -> float:
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol,
                               msg=lambda m: f"{name}: {m}")
    return max_err(got, want)


# ------------------------------------------------------------- kernel cases


def delta_case(gen, m, d_in, d_out, x_dtype, v_dtype, dev):
    x = torch.randn(m, d_in, generator=gen, device=dev).to(x_dtype)
    idx = torch.randint(0, d_in, (N_TENANTS + 1, K_DELTA, d_out), generator=gen,
                        device=dev, dtype=torch.int32)
    val = (torch.randn(N_TENANTS + 1, K_DELTA, d_out, generator=gen, device=dev)
           * 0.05).to(v_dtype)
    val[0] = 0  # row 0 is the base model
    # rows of one slot share a tenant, as the engine broadcasts (B,) ids
    per_slot = torch.randint(0, N_TENANTS + 1, (SLOTS,), generator=gen, device=dev)
    aid = per_slot.repeat_interleave(-(-m // SLOTS))[:m].to(torch.int32).contiguous()
    return x, idx, val, aid


def delta_cost(x, idx, val, aid, d_out) -> tuple[float, float]:
    """Bytes and flops the function needs on this data: of each row of x
    only the columns its tenant's indices name, the used tenants' idx/val
    and the ids read once, y written once."""
    k = idx.shape[1]
    rows = torch.bincount(aid.long(), minlength=idx.shape[0]).tolist()
    used = [a for a, n in enumerate(rows) if n]
    x_elems = sum(rows[a] * int(torch.unique(idx[a]).numel()) for a in used)
    nbytes = (x_elems * x.element_size() + aid.numel() * 4
              + len(used) * k * d_out * (4 + val.element_size())
              + x.shape[0] * d_out * x.element_size())
    return nbytes, 2.0 * x.shape[0] * k * d_out


def paged_case(gen, q_off, q_len, c, dtype, dev, num_blocks, share_pages=3,
               arch="qwen2-1.5b"):
    """q (B, c, H, hd) of ``arch`` (12 and 128 for qwen2-1.5b) against a
    pool of ``num_blocks`` pages through a table with ragged frontiers
    ``q_off + q_len``; slots 0 and 1 share their leading pages, pages past
    each frontier hold the sentinel ``num_blocks``."""
    cfg = get_config(arch)
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    b = len(q_off)
    n_pages = -(-MAX_LEN // PAGE)
    q_off = torch.tensor(q_off, dtype=torch.int32, device=dev)
    vl = (q_off + torch.tensor(q_len, dtype=torch.int32, device=dev)).contiguous()
    perm = torch.randperm(num_blocks, generator=gen, device=dev).tolist()
    table = torch.full((b, n_pages), num_blocks, dtype=torch.int32)
    for s in range(b):
        used = -(-int(vl[s]) // PAGE)
        table[s, :used] = torch.tensor([perm.pop() for _ in range(used)])
    n_share = min(share_pages, int((table[0] < num_blocks).sum()),
                  int((table[1] < num_blocks).sum()))
    table[1, :n_share] = table[0, :n_share]
    q = torch.randn(b, c, h, hd, generator=gen, device=dev).to(dtype)
    kp = torch.randn(num_blocks, PAGE, hkv, hd, generator=gen, device=dev).to(dtype)
    vp = torch.randn(num_blocks, PAGE, hkv, hd, generator=gen, device=dev).to(dtype)
    return q, kp, vp, table.to(dev), q_off.contiguous(), vl


def attention_bytes(q, kp, table, vl, q_rows: int, n_lengths: int) -> float:
    """Bytes the function needs on this data: the ``q_rows`` query
    positions that see at least one cache column (an idle slot's are never
    read), k and v at each distinct pool position below some slot's
    frontier (pages shared by two slots count once), the table entries up
    to each frontier, the ``n_lengths`` (B,) int32 vectors, and the whole
    output written once."""
    h, hd, es = q.shape[2], q.shape[3], q.element_size()
    hkv = kp.shape[2]
    tab, lens = table.cpu().tolist(), vl.cpu().tolist()
    positions = {(tab[s][t // PAGE], t % PAGE) for s, n in enumerate(lens) for t in range(n)}
    pages = sum(-(-n // PAGE) for n in lens)
    return (q_rows * h * hd * es + 2 * len(positions) * hkv * hd * es + pages * 4
            + n_lengths * 4 * q.shape[0] + q.numel() * es)


def prefill_mask(qoff, vl, table, dev):
    """(B, 1, C, S) columns each chunk row sees: causal, below its slot's
    frontier."""
    col = torch.arange(table.shape[1] * PAGE, device=dev)[None, None, :]
    qpos = qoff[:, None, None] + torch.arange(PREFILL_CHUNK, device=dev)[None, :, None]
    return ((col <= qpos) & (col < vl[:, None, None]))[:, None]


def decode_cost(q, kp, table, vl) -> tuple[float, float]:
    return (attention_bytes(q, kp, table, vl, int((vl > 0).sum()), 1),
            4.0 * float(vl.sum()) * q.shape[2] * q.shape[3])


def prefill_cost(q, kp, table, qoff, vl, mask) -> tuple[float, float]:
    return (attention_bytes(q, kp, table, vl, int(mask[:, 0].any(-1).sum()), 2),
            4.0 * float(mask[:, 0].sum()) * q.shape[2] * q.shape[3])


def sdpa_yardstick(q, kp, vp, table, mask):
    """One SDPA call on the pre-gathered, head-expanded cache (timed only)."""
    h, hkv = q.shape[2], kp.shape[2]
    k = gather_paged_kv(kp, table).repeat_interleave(h // hkv, dim=2).transpose(1, 2)
    v = gather_paged_kv(vp, table).repeat_interleave(h // hkv, dim=2).transpose(1, 2)
    qt = q.transpose(1, 2)
    k, v, qt = k.contiguous(), v.contiguous(), qt.contiguous()
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask)


def phase_kernels(dev, card: str) -> tuple[dict, list]:
    gen = torch.Generator(device=dev).manual_seed(1234)
    cfg = get_config("qwen2-1.5b")
    d, dq, dkv, dff = cfg.d_model, cfg.num_heads * cfg.resolved_head_dim, \
        cfg.num_kv_heads * cfg.resolved_head_dim, cfg.d_ff
    projections = [("wq", d, dq), ("wk", d, dkv), ("wv", d, dkv), ("wo", dq, d),
                   ("wgate", d, dff), ("wup", d, dff), ("wdown", dff, d)]
    num_blocks = SLOTS * (-(-MAX_LEN // PAGE))
    detail = []
    summary = {}

    # -- sparse_delta_batched: every projection, mixed (M = slots * chunk)
    #    and decode (M = slots) rows, every (x, values) pair of float32 and
    #    bf16 the wrapper accepts (adapter files keep their own dtype)
    m_mixed = SLOTS * PREFILL_CHUNK
    err_bf16 = 0.0
    layer = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "flops": 0.0}
    for name, d_in, d_out in projections:
        for m in (m_mixed, SLOTS):
            for x_dt, v_dt in ((torch.bfloat16, torch.bfloat16),
                               (torch.bfloat16, torch.float32),
                               (torch.float32, torch.bfloat16),
                               (torch.float32, torch.float32)):
                x, idx, val, aid = delta_case(gen, m, d_in, d_out, x_dt, v_dt, dev)
                got = sd_mod.sparse_delta_batched(x, idx, val, aid)
                want = sd_mod.sparse_delta_batched_plain(x, idx, val, aid)
                torch.cuda.synchronize()
                err = check_close(f"sparse_delta {name} M={m}", got, want, x_dt)
                row = {"kernel": "sparse_delta_batched", "proj": name, "M": m,
                       "d_in": d_in, "d_out": d_out, "x": str(x_dt), "val": str(v_dt),
                       "max_abs_err": err}
                if x_dt == torch.bfloat16 and v_dt == torch.bfloat16:
                    err_bf16 = max(err_bf16, err)
                    row["ms"] = cuda_ms(lambda: sd_mod.sparse_delta_batched(x, idx, val, aid))
                    row["plain_ms"] = cuda_ms(
                        lambda: sd_mod.sparse_delta_batched_plain(x, idx, val, aid), iters=3)
                    nbytes, flops = delta_cost(x, idx, val, aid, d_out)
                    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, x_dt)
                    if m == m_mixed:
                        layer["ms"] += row["ms"]
                        layer["plain_ms"] += row["plain_ms"]
                        layer["bytes"] += nbytes
                        layer["flops"] += flops
                detail.append(row)
    b_ms, b_by = bound(layer["bytes"], layer["flops"], torch.bfloat16)
    summary["sparse_delta_batched"] = {
        "source": sd_mod.SOURCE, "replaces": sd_mod.REPLACES, "max_abs_err": err_bf16, "ms": layer["ms"],
        "plain_ms": layer["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
        "shape": f"7 projections of one layer, M={m_mixed} bf16 rows, k={K_DELTA}, "
                 f"N={N_TENANTS + 1}",
    }
    log(f"[kernels] sparse_delta_batched ok: max|err| bf16 {err_bf16:.3e}, "
        f"one layer at M={m_mixed}: {layer['ms']:.4f} ms (plain {layer['plain_ms']:.4f} ms, "
        f"bound {b_ms:.4f} ms by {b_by}) [{card}]")

    # -- paged decode attention: one query per slot, ragged frontiers
    dec_vl = [1, 17, 300, MAX_LEN - 1, 512, 0, 640, 33]
    for dt in (torch.bfloat16, torch.float32):
        q, kp, vp, table, _, vl = paged_case(gen, [0] * SLOTS, dec_vl, 1, dt, dev,
                                             num_blocks)
        got = dec_mod.paged_decode_attention(q, kp, vp, table, vl)
        want = dec_mod.paged_decode_attention_plain(q, kp, vp, table, vl)
        torch.cuda.synchronize()
        err = check_close("paged_decode_attention", got, want, dt)
        assert float(got[5].float().abs().max()) == 0.0, "idle slot must give zeros"
        row = {"kernel": "paged_decode_attention", "dtype": str(dt), "kv_valid_len": dec_vl,
               "max_abs_err": err}
        if dt == torch.bfloat16:
            row["ms"] = cuda_ms(lambda: dec_mod.paged_decode_attention(q, kp, vp, table, vl))
            row["plain_ms"] = cuda_ms(
                lambda: dec_mod.paged_decode_attention_plain(q, kp, vp, table, vl), iters=3)
            s = table.shape[1] * PAGE
            mask = (torch.arange(s, device=dev)[None, :] < vl[:, None])[:, None, None, :]
            row["library_ms"] = cuda_ms(sdpa_yardstick(q, kp, vp, table, mask))
            row["bound_ms"], row["bound_by"] = bound(*decode_cost(q, kp, table, vl), dt)
            summary["paged_decode_attention"] = dict(
                source=dec_mod.SOURCE, replaces=dec_mod.REPLACES, max_abs_err=err, ms=row["ms"], plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=row["library_ms"],
                shape=f"q (8,1,12,128) bf16, pool ({num_blocks},16,2,128), "
                      f"kv_valid_len {dec_vl}")
        detail.append(row)
    r = summary["paged_decode_attention"]
    log(f"[kernels] paged_decode_attention ok: max|err| bf16 {r['max_abs_err']:.3e}, "
        f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, sdpa {r['library_ms']:.4f}, "
        f"bound {r['bound_ms']:.4f} by {r['bound_by']}) [{card}]")

    # -- paged prefill attention: one mixed step's chunk buffer; decode
    #    slots are one-token chunks, idle and stalled slots q_len = 0
    pre_off = [700, 0, 256, 0, 512, 40, 0, 300]
    pre_len = [1, 256, 188, 0, 256, 1, 40, 0]
    for dt in (torch.bfloat16, torch.float32):
        q, kp, vp, table, qoff, vl = paged_case(gen, pre_off, pre_len, PREFILL_CHUNK, dt,
                                                dev, num_blocks)
        got = pre_mod.paged_prefill_attention(q, kp, vp, table, qoff, vl)
        want = pre_mod.paged_prefill_attention_plain(q, kp, vp, table, qoff, vl)
        torch.cuda.synchronize()
        err = check_close("paged_prefill_attention", got, want, dt)
        assert float(got[3].float().abs().max()) == 0.0, "idle slot must give zeros"
        row = {"kernel": "paged_prefill_attention", "dtype": str(dt), "q_offset": pre_off,
               "q_len": pre_len, "max_abs_err": err}
        if dt == torch.bfloat16:
            row["ms"] = cuda_ms(
                lambda: pre_mod.paged_prefill_attention(q, kp, vp, table, qoff, vl))
            row["plain_ms"] = cuda_ms(
                lambda: pre_mod.paged_prefill_attention_plain(q, kp, vp, table, qoff, vl),
                iters=3)
            mask = prefill_mask(qoff, vl, table, dev)
            row["library_ms"] = cuda_ms(sdpa_yardstick(q, kp, vp, table, mask))
            row["bound_ms"], row["bound_by"] = bound(
                *prefill_cost(q, kp, table, qoff, vl, mask), dt)
            summary["paged_prefill_attention"] = dict(
                source=pre_mod.SOURCE, replaces=pre_mod.REPLACES, max_abs_err=err, ms=row["ms"], plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=row["library_ms"],
                shape=f"q (8,256,12,128) bf16, pool ({num_blocks},16,2,128), "
                      f"q_offset {pre_off}, q_len {pre_len}")
        detail.append(row)
    r = summary["paged_prefill_attention"]
    log(f"[kernels] paged_prefill_attention ok: max|err| bf16 {r['max_abs_err']:.3e}, "
        f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, sdpa {r['library_ms']:.4f}, "
        f"bound {r['bound_ms']:.4f} by {r['bound_by']}) [{card}]")
    kv_kernels(gen, dev, summary, detail, card, num_blocks, dec_vl, pre_off, pre_len)
    train_kernels(gen, projections, dev, summary, detail, card)
    packed_kernels(gen, projections, dev, summary, detail, card)
    moe_kernels(gen, dev, summary, detail, card, num_blocks, dec_vl, pre_off, pre_len)
    return summary, detail


def quantized(gen, shape, dev, zero_group=None):
    """Random float32 rows quantized per (leading index, kv-head) by the
    port's writer arithmetic (``quant_kv_page``): (codes int8, scales f32).
    ``zero_group`` names a leading index whose rows are all zero (scale 0)."""
    x = torch.randn(shape, generator=gen, device=dev)
    if zero_group is not None:
        x[zero_group] = 0.0
    return quant_kv_page(x)


def kv_kernels(gen, dev, summary, detail, card: str, num_blocks: int, dec_vl, pre_off,
               pre_len) -> None:
    """The int8 bodies of the two paged kernels (int8 pools with one scale
    per (block, kv-head), one page all zero) at the serving shapes of the
    fp rows above, and the dense decode over a (8, Smax, 2, 128) slot cache,
    fp and int8 (16-row scale groups, one group all zero), with frontiers 0,
    1 and Smax and an fp Smax of 1000 (no multiple of the 16-row tile);
    bf16 within 2e-2, fp32 within 2e-5; the bf16 calls at Smax 1024 timed.
    The int8 bodies have no one-call PyTorch yardstick; the fp dense decode
    has SDPA's on the head-expanded cache."""
    cfg = get_config("qwen2-1.5b")
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    def visible(table, vl):
        tab, lens = table.cpu().tolist(), vl.cpu().tolist()
        positions = {(tab[s][t // PAGE], t % PAGE) for s, n in enumerate(lens) for t in range(n)}
        pages = {tab[s][t // PAGE] for s, n in enumerate(lens) for t in range(n)}
        return len(positions), len(pages), 4 * sum(-(-n // PAGE) for n in lens)

    # -- paged decode and prefill, int8 pools
    for kind, (q_off, q_len, c) in (("decode", ([0] * SLOTS, dec_vl, 1)),
                                    ("prefill", (pre_off, pre_len, PREFILL_CHUNK))):
        mod = dec_mod if kind == "decode" else pre_mod
        name = f"paged_{kind}_attention_q"
        for dt in (torch.bfloat16, torch.float32):
            q, _, _, table, qoff, vl = paged_case(gen, q_off, q_len, c, dt, dev, num_blocks)
            kc, ks = quantized(gen, (num_blocks, PAGE, hkv, hd), dev, zero_group=int(table[4, 1]))
            vc, vs = quantized(gen, (num_blocks, PAGE, hkv, hd), dev)
            if kind == "decode":
                args = (q, kc, vc, table, vl, ks, vs)
                fn, plain = mod.paged_decode_attention, mod.paged_decode_attention_plain
            else:
                args = (q, kc, vc, table, qoff, vl, ks, vs)
                fn, plain = mod.paged_prefill_attention, mod.paged_prefill_attention_plain
            got, want = fn(*args), plain(*args)
            torch.cuda.synchronize()
            err = check_close(name, got, want, dt)
            idle = 5 if kind == "decode" else 3
            assert float(got[idle].float().abs().max()) == 0.0, "idle slot must give zeros"
            row = {"kernel": name, "dtype": str(dt), "q_offset": q_off, "q_len": q_len,
                   "max_abs_err": err}
            if dt == torch.bfloat16:
                row["ms"] = cuda_ms(lambda: fn(*args))
                row["plain_ms"] = cuda_ms(lambda: plain(*args), iters=3)
                n_pos, n_pages, idx_bytes = visible(table, vl)
                if kind == "decode":
                    n_vis = float(vl.sum())
                    q_rows = int((vl > 0).sum())
                else:
                    col = torch.arange(table.shape[1] * PAGE, device=dev)[None, None, :]
                    qpos = qoff[:, None, None] + torch.arange(c, device=dev)[None, :, None]
                    mask = (col <= qpos) & (col < vl[:, None, None])
                    n_vis = float(mask.sum())
                    q_rows = int(mask.any(-1).sum())
                nbytes = (q_rows * h * hd * q.element_size() + 2 * n_pos * hkv * hd
                          + 2 * n_pages * hkv * 4 + idx_bytes
                          + (1 if kind == "decode" else 2) * 4 * q.shape[0]
                          + q.numel() * q.element_size())
                row["bound_ms"], row["bound_by"] = bound(nbytes, 4.0 * n_vis * h * hd, dt)
                summary[name] = dict(
                    source=mod.SOURCE, replaces=mod.Q_REPLACES, max_abs_err=err, ms=row["ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"], library_ms=None,
                    shape=f"q ({SLOTS},{c},12,128) bf16, int8 pools ({num_blocks},16,2,128) "
                          f"+ f32 scales ({num_blocks},2), q_offset {q_off}, q_len {q_len}")
            detail.append(row)
        r = summary[name]
        log(f"[kernels] {name} ok: max|err| bf16 {r['max_abs_err']:.3e}, {r['ms']:.4f} ms "
            f"(plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.5f} by {r['bound_by']}; no "
            f"one-call yardstick) [{card}]")

    # -- dense decode over a slot cache, fp and int8
    for quant, smaxes in ((False, (1000, MAX_LEN)), (True, (MAX_LEN,))):
        name = "decode_attention_q" if quant else "decode_attention"
        for smax in smaxes:
            vl = torch.tensor([0, 1, smax, 300, 17, smax - 1, 640, 33], dtype=torch.int32,
                              device=dev)
            for dt in (torch.bfloat16, torch.float32):
                q = torch.randn(SLOTS, 1, h, hd, generator=gen, device=dev).to(dt)
                if quant:
                    g = smax // dd_mod.TILE
                    kc, ks = quantized(gen, (SLOTS, g, dd_mod.TILE, hkv, hd), dev,
                                       zero_group=(1, 0))
                    vc, vs = quantized(gen, (SLOTS, g, dd_mod.TILE, hkv, hd), dev)
                    args = (q, kc.reshape(SLOTS, smax, hkv, hd), vc.reshape(SLOTS, smax, hkv, hd),
                            vl, ks, vs)
                else:
                    k = torch.randn(SLOTS, smax, hkv, hd, generator=gen, device=dev).to(dt)
                    v = torch.randn(SLOTS, smax, hkv, hd, generator=gen, device=dev).to(dt)
                    args = (q, k, v, vl)
                got = dd_mod.decode_attention(*args)
                want = dd_mod.decode_attention_plain(*args)
                torch.cuda.synchronize()
                err = check_close(f"{name} Smax={smax}", got, want, dt)
                assert float(got[0].float().abs().max()) == 0.0, "kv_valid_len 0 must give zeros"
                row = {"kernel": name, "dtype": str(dt), "smax": smax,
                       "kv_valid_len": vl.tolist(), "max_abs_err": err}
                if dt == torch.bfloat16 and smax == MAX_LEN:
                    row["ms"] = cuda_ms(lambda: dd_mod.decode_attention(*args))
                    row["plain_ms"] = cuda_ms(lambda: dd_mod.decode_attention_plain(*args),
                                              iters=3)
                    rows = int(vl.sum())
                    tiles = sum(-(-n // dd_mod.TILE) for n in vl.tolist())
                    es = 1 if quant else q.element_size()
                    nbytes = (int((vl > 0).sum()) * h * hd * q.element_size()
                              + 2 * rows * hkv * hd * es + (2 * tiles * hkv * 4 if quant else 0)
                              + 4 * SLOTS + q.numel() * q.element_size())
                    row["bound_ms"], row["bound_by"] = bound(nbytes, 4.0 * rows * h * hd, dt)
                    lib = None
                    if not quant:
                        mask = (torch.arange(smax, device=dev)[None, :] < vl[:, None])
                        kt = args[1].repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous()
                        vt = args[2].repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous()
                        qt = q.transpose(1, 2).contiguous()
                        m4 = mask[:, None, None, :]
                        lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                             attn_mask=m4))
                    row["library_ms"] = lib
                    summary[name] = dict(
                        source=dd_mod.SOURCE, replaces=dd_mod.Q_REPLACES if quant
                        else dd_mod.REPLACES, max_abs_err=err, ms=row["ms"],
                        plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                        bound_by=row["bound_by"], library_ms=lib,
                        shape=f"q ({SLOTS},1,12,128) bf16, cache ({SLOTS},{smax},2,128) "
                              + ("int8 + f32 scales (8,64,2)" if quant else "bf16")
                              + f", kv_valid_len {vl.tolist()}")
                detail.append(row)
        r = summary[name]
        lib = f", sdpa {r['library_ms']:.4f}" if r["library_ms"] is not None else ""
        log(f"[kernels] {name} ok (Smax {', '.join(map(str, smaxes))}): max|err| bf16 "
            f"{r['max_abs_err']:.3e}, {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}{lib}, bound "
            f"{r['bound_ms']:.5f} by {r['bound_by']}) [{card}]")


# ------------------------------------------------------------------- MoE
# full-width olmoe-1b-7b (configs/olmoe_1b_7b.py): 64 experts top-8, d_ff
# 1024 per expert, an untied head of 50304; a training step routes its
# batch x seq = 2048 tokens in 32 groups of 64 with capacity 10, so every
# expert buffer holds 32 x 10 = 320 rows
MOE_ARCH = "olmoe-1b-7b"
# the paged pool of full-width olmoe at SLOTS x MAX_LEN, reckoned by hand:
# 2 (k, v) x 16 layers x 512 blocks x 16 rows x 16 kv heads x 128 x 2 bytes
MOE_POOL_BYTES = 1_073_741_824


def distinct_cols(idx) -> torch.Tensor:
    """(B,) number of distinct indices in each batch's (k, d_out) matrix."""
    s = idx.reshape(idx.shape[0], -1).sort(dim=1).values
    return 1 + (s[:, 1:] != s[:, :-1]).sum(dim=1)


def single_cost(x, idx, val) -> tuple[float, float]:
    """Bytes and flops of the single-tenant apply on this data: of each row
    of batch b only the columns its indices name, idx/val read once, y
    written once; 2·B·M·k·d_out flops."""
    b, m, _ = x.shape
    k, d_out = idx.shape[1:]
    es = x.element_size()
    nbytes = (float(distinct_cols(idx).sum()) * m * es + b * k * d_out * (4 + val.element_size())
              + b * m * d_out * es)
    return nbytes, 2.0 * b * m * k * d_out


def batched_dval_cost(x, idx, dy) -> tuple[float, float]:
    """dy read once, of x only the columns each batch's idx names, idx read
    once, the float32 (B, k, d_out) output written once."""
    b, m, _ = x.shape
    k, d_out = idx.shape[1:]
    nbytes = ((dy.numel() + float(distinct_cols(idx).sum()) * m) * x.element_size()
              + b * k * d_out * 8)
    return nbytes, 2.0 * b * m * k * d_out


def moe_kernels(gen, dev, summary, detail, card: str, num_blocks: int, dec_vl, pre_off,
                pre_len) -> None:
    """``sparse_delta`` and the batched ``sparse_delta_dval`` against their
    plain versions: ragged shapes first (rows and columns off every tile,
    B = 1, 3 and 64, k 1-3, both value dtypes; each batch of dval also as
    its own 2-D call), then the shapes of an olmoe training step — the
    three expert linears over (64, 320, ·) buffers and the untied head over
    2048 rows, k = 1 — in bf16 and fp32, the bf16 calls timed. dval repeats
    bit for bit, and its 2-D call equals the B = 1 call bit for bit. Then
    the earlier slices' kernels at olmoe's own shapes: paged decode and
    prefill with 16 query and 16 kv heads (group 1), ``fused_linear`` 2048
    x 2048 without bias, ``sparse_delta_batched`` over 256 stacked (tenant,
    expert) adapters."""
    cfg = get_config(MOE_ARCH)
    d, f, e, v = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.padded_vocab
    m_tok = TRAIN_BATCH * TRAIN_SEQ
    g = moe_mod.num_groups(m_tok, cfg.experts_per_token)
    rows = g * moe_mod.capacity(cfg, m_tok // g)
    assert rows == 320, rows

    def rand_case(b, m, d_in, d_out, kk, dt, vdt):
        x = torch.randn(b, m, d_in, generator=gen, device=dev).to(dt)
        idx = torch.randint(0, d_in, (b, kk, d_out), generator=gen, device=dev,
                            dtype=torch.int32)
        val = (torch.randn(b, kk, d_out, generator=gen, device=dev) * 0.05).to(vdt)
        # the gradient of a mean over the rows: dval stays O(1)
        dy = (torch.randn(b, m, d_out, generator=gen, device=dev) * m**-0.5).to(dt)
        return x, idx, val, dy

    def check_dval(tag, x, idx, dy, dt, per_batch=False):
        got = sd_mod.sparse_delta_dval(x, idx, dy)
        err = check_close(f"sparse_delta_dval {tag}", got,
                          sd_mod.sparse_delta_dval_plain(x, idx, dy), dt)
        assert torch.equal(got, sd_mod.sparse_delta_dval(x, idx, dy)), \
            f"sparse_delta_dval {tag}: two launches on the same inputs differ"
        assert torch.equal(sd_mod.sparse_delta_dval(x[0], idx[0], dy[0]),
                           sd_mod.sparse_delta_dval(x[:1], idx[:1], dy[:1])[0]), \
            f"sparse_delta_dval {tag}: the 2-D call differs from the B = 1 call"
        for i in range(x.shape[0] if per_batch else 0):
            check_close(f"sparse_delta_dval {tag} batch {i} alone", got[i],
                        sd_mod.sparse_delta_dval(x[i], idx[i], dy[i]), dt)
        return err

    for b, m, d_in, d_out, kk in ((1, 130, 77, 129, 1), (64, 7, 300, 260, 2),
                                  (3, 33, 1000, 5, 3)):
        for dt in (torch.bfloat16, torch.float32):
            for vdt in (torch.bfloat16, torch.float32):
                x, idx, val, dy = rand_case(b, m, d_in, d_out, kk, dt, vdt)
                got = sd_mod.sparse_delta(x, idx, val)
                want = sd_mod.sparse_delta_plain(x, idx, val)
                torch.cuda.synchronize()
                check_close(f"sparse_delta ragged B={b} M={m} d_in={d_in} d_out={d_out}", got,
                            want, dt)
            check_dval(f"ragged B={b} M={m} d_in={d_in} d_out={d_out}", x, idx, dy, dt,
                       per_batch=True)
    log("[kernels] sparse_delta and batched sparse_delta_dval ok on ragged shapes (B 1/3/64, "
        "M 7/33/130, d_in 77/300/1000, d_out 5/129/260, k 1-3; dval per batch = its 2-D "
        "call; bf16 2e-2, fp32 2e-5)")

    shapes = (("wgate", e, rows, d, f), ("wup", e, rows, d, f), ("wdown", e, rows, f, d),
              ("head", 1, m_tok, d, v))
    acc = {n: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "flops": 0.0, "err": 0.0}
           for n in ("sparse_delta", "sparse_delta_dval")}
    for name, b, m, d_in, d_out in shapes:
        for dt in (torch.bfloat16, torch.float32):
            x, idx, val, dy = rand_case(b, m, d_in, d_out, TRAIN_K, dt, torch.bfloat16)
            got = sd_mod.sparse_delta(x, idx, val)
            want = sd_mod.sparse_delta_plain(x, idx, val)
            torch.cuda.synchronize()
            err = check_close(f"sparse_delta {name} B={b} M={m}", got, want, dt)
            e_dv = check_dval(f"{name} B={b} M={m}", x, idx, dy, dt)
            del got, want
            rows_out = [{"kernel": "sparse_delta", "proj": name, "B": b, "M": m, "d_in": d_in,
                         "d_out": d_out, "dtype": str(dt), "max_abs_err": err},
                        {"kernel": "sparse_delta_dval", "proj": name, "B": b, "M": m,
                         "d_in": d_in, "d_out": d_out, "dtype": str(dt), "max_abs_err": e_dv}]
            if dt == torch.bfloat16:
                for row, fn, plain, cost in (
                        (rows_out[0], lambda: sd_mod.sparse_delta(x, idx, val),
                         lambda: sd_mod.sparse_delta_plain(x, idx, val),
                         single_cost(x, idx, val)),
                        (rows_out[1], lambda: sd_mod.sparse_delta_dval(x, idx, dy),
                         lambda: sd_mod.sparse_delta_dval_plain(x, idx, dy),
                         batched_dval_cost(x, idx, dy))):
                    row["ms"] = cuda_ms(fn)
                    row["plain_ms"] = cuda_ms(plain, iters=3)
                    row["bound_ms"], row["bound_by"] = bound(*cost, dt)
                    a = acc[row["kernel"]]
                    for key, val_ in (("ms", row["ms"]), ("plain_ms", row["plain_ms"]),
                                      ("bytes", cost[0]), ("flops", cost[1])):
                        a[key] += val_
                    a["err"] = max(a["err"], row["max_abs_err"])
                r0, r1 = rows_out
                log(f"[kernels] olmoe {name} ({b}, {m}, {d_in}) -> {d_out}: sparse_delta "
                    f"{r0['ms']:.4f} ms (plain {r0['plain_ms']:.4f}, bound {r0['bound_ms']:.4f} "
                    f"by {r0['bound_by']}); sparse_delta_dval {r1['ms']:.4f} ms (plain "
                    f"{r1['plain_ms']:.4f}, bound {r1['bound_ms']:.4f} by {r1['bound_by']}) "
                    f"[{card}]")
            detail.extend(rows_out)
    shape = (f"the three expert linears of one olmoe-1b-7b layer ({e} experts x {rows} rows: "
             f"{d}->{f}, {d}->{f}, {f}->{d}) and the untied head ({m_tok} rows, {d}->{v}), "
             f"bf16, k={TRAIN_K}")
    a = acc["sparse_delta"]
    b_ms, b_by = bound(a["bytes"], a["flops"], torch.bfloat16)
    summary["sparse_delta"] = {
        "source": sd_mod.SOURCE, "replaces": sd_mod.DELTA_REPLACES,
        "max_abs_err": a["err"], "ms": a["ms"], "plain_ms": a["plain_ms"], "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None, "shape": shape}
    a = acc["sparse_delta_dval"]
    d_ms, d_by = bound(a["bytes"], a["flops"], torch.bfloat16)
    summary["sparse_delta_dval"]["olmoe"] = {
        "ms": a["ms"], "plain_ms": a["plain_ms"], "bound_ms": d_ms, "bound_by": d_by,
        "max_abs_err": a["err"], "shape": shape}
    log(f"[kernels] sparse_delta ok (bf16 2e-2, fp32 2e-5 at the 4 olmoe shapes): max|err| "
        f"bf16 {summary['sparse_delta']['max_abs_err']:.3e}; 3 expert linears + head "
        f"{summary['sparse_delta']['ms']:.4f} ms (plain {summary['sparse_delta']['plain_ms']:.4f}, "
        f"bound {b_ms:.4f} by {b_by}; no one-call yardstick); batched sparse_delta_dval "
        f"{a['ms']:.4f} ms (plain {a['plain_ms']:.4f}, bound {d_ms:.4f} by {d_by}) [{card}]")

    # -- the earlier slices' kernels at olmoe's shapes (checked; timed, with
    #    their bound, in bf16 into the kernel's "olmoe" entry)
    out = {}

    def timed(kernel, tag, fn, plain, dt, cost):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        row = {"kernel": kernel, "arch": MOE_ARCH, "case": tag, "dtype": str(dt),
               "max_abs_err": check_close(f"{kernel} olmoe {tag}", got, want, dt)}
        if dt == torch.bfloat16:
            row["ms"] = cuda_ms(fn)
            row["plain_ms"] = cuda_ms(plain, iters=3)
            row["bound_ms"], row["bound_by"] = bound(*cost(), dt)
            out[kernel] = row
            summary[kernel]["olmoe"] = {key: row[key] for key in (
                "case", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
        detail.append(row)

    for dt in (torch.bfloat16, torch.float32):
        q, kp, vp, table, _, vl = paged_case(gen, [0] * SLOTS, dec_vl, 1, dt, dev, num_blocks,
                                             arch=MOE_ARCH)
        timed(
            "paged_decode_attention", "q (8,1,16,128), group 1",
            lambda: dec_mod.paged_decode_attention(q, kp, vp, table, vl),
            lambda: dec_mod.paged_decode_attention_plain(q, kp, vp, table, vl), dt,
            lambda: decode_cost(q, kp, table, vl))
        q, kp, vp, table, qoff, vl = paged_case(gen, pre_off, pre_len, PREFILL_CHUNK, dt, dev,
                                                num_blocks, arch=MOE_ARCH)
        timed(
            "paged_prefill_attention", "q (8,256,16,128), group 1",
            lambda: pre_mod.paged_prefill_attention(q, kp, vp, table, qoff, vl),
            lambda: pre_mod.paged_prefill_attention_plain(q, kp, vp, table, qoff, vl), dt,
            lambda: prefill_cost(q, kp, table, qoff, vl, prefill_mask(qoff, vl, table, dev)))
        x = torch.randn(m_tok, d, generator=gen, device=dev).to(dt)
        w = (torch.randn(d, d, generator=gen, device=dev) * d**-0.5).to(dt)
        idx = torch.randint(0, d, (TRAIN_K, d), generator=gen, device=dev, dtype=torch.int32)
        val = (torch.randn(TRAIN_K, d, generator=gen, device=dev) * 0.05).to(torch.bfloat16)
        timed(
            "fused_linear", "2048 x 2048 x 2048, no bias, k=1",
            lambda: fl_mod.fused_linear(x, w, idx, val, None),
            lambda: fl_mod.fused_linear_plain(x, w, idx, val, None), dt,
            lambda: linear_cost(x, w, idx, val, None))
        # a mixed step's expert buffers: 64 experts x 320 rows, each row's
        # adapter the stacked (tenant, expert) pair tenant * 64 + expert
        n_ad = (N_TENANTS + 1) * e
        xb = torch.randn(e * rows, d, generator=gen, device=dev).to(dt)
        bidx = torch.randint(0, d, (n_ad, K_DELTA, f), generator=gen, device=dev,
                             dtype=torch.int32)
        bval = (torch.randn(n_ad, K_DELTA, f, generator=gen, device=dev) * 0.05).to(
            torch.bfloat16)
        bval[:e] = 0  # tenant 0 is the base
        tenant = torch.randint(0, N_TENANTS + 1, (e, rows), generator=gen, device=dev)
        aid = (tenant * e + torch.arange(e, device=dev)[:, None]).reshape(-1).to(
            torch.int32).contiguous()
        timed(
            "sparse_delta_batched", f"expert buffers ({e * rows}, {d}) -> {f}, N*E={n_ad}",
            lambda: sd_mod.sparse_delta_batched(xb, bidx, bval, aid),
            lambda: sd_mod.sparse_delta_batched_plain(xb, bidx, bval, aid), dt,
            lambda: delta_cost(xb, bidx, bval, aid, f))
    log("[kernels] the earlier kernels at olmoe shapes ok (bf16 2e-2, fp32 2e-5): " + "; ".join(
        f"{k} {r['case']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
        f"{r['bound_ms']:.4f} by {r['bound_by']})"
        for k, r in out.items()) + f" [{card}]")


def linear_cost(x, w, idx, val, bias) -> tuple[float, float]:
    """x and W read once, idx/val/bias read once, y written once; the
    product's 2·M·K·N flops plus 2·M·k·N of bypass."""
    m, kd = x.shape
    k, n = idx.shape
    es = x.element_size()
    nbytes = (m * kd + kd * n + m * n) * es + k * n * (4 + val.element_size())
    if bias is not None:
        nbytes += n * es
    return nbytes, 2.0 * m * kd * n + 2.0 * m * k * n


def dval_cost(x, idx, dy) -> tuple[float, float]:
    """dy read once, of x only the columns idx names (each once per row),
    idx read once, the float32 (k, d_out) output written once."""
    k, n = idx.shape
    cols = int(torch.unique(idx).numel())
    nbytes = (dy.numel() + x.shape[0] * cols) * x.element_size() + k * n * 8
    return nbytes, 2.0 * x.shape[0] * k * n


def train_kernels(gen, projections, dev, summary, detail, card: str) -> None:
    """``fused_linear`` and ``sparse_delta_dval`` at every projection of a
    full-width training step (M = batch x seq rows; qkv carry a bias; k =
    1 magnitude selection gives one distinct index per column), bf16 and
    fp32; the bf16 calls timed, summed over the layer's 7 projections."""
    # ragged shapes first (untimed): row, column and K tails, K not a
    # multiple of 8 (the kernel's unaligned load path), k > 1, both value
    # dtypes — the path shapes below all tile evenly
    for rm, rk, rn, kk in ((130, 77, 129, 1), (200, 1000, 264, 2), (7, 4500, 520, 3)):
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(rm, rk, generator=gen, device=dev).to(dt)
            w = (torch.randn(rk, rn, generator=gen, device=dev) * rk**-0.5).to(dt)
            idx = torch.randint(0, rk, (kk, rn), generator=gen, device=dev, dtype=torch.int32)
            b = torch.randn(rn, generator=gen, device=dev).to(dt)
            dy = (torch.randn(rm, rn, generator=gen, device=dev) * rm**-0.5).to(dt)
            for vdt in (torch.bfloat16, torch.float32):
                val = (torch.randn(kk, rn, generator=gen, device=dev) * 0.05).to(vdt)
                for bias in (b, None):
                    got = fl_mod.fused_linear(x, w, idx, val, bias)
                    want = fl_mod.fused_linear_plain(x, w, idx, val, bias)
                    torch.cuda.synchronize()
                    check_close(f"fused_linear ragged M={rm} K={rk} N={rn}", got, want, dt)
            got = sd_mod.sparse_delta_dval(x, idx, dy)
            want = sd_mod.sparse_delta_dval_plain(x, idx, dy)
            torch.cuda.synchronize()
            check_close(f"sparse_delta_dval ragged M={rm} d_in={rk} d_out={rn}", got, want, dt)
    log(f"[kernels] fused_linear and sparse_delta_dval ok on ragged shapes (M 7/130/200, "
        f"K 77/1000/4500, N 129/264/520, k 1-3; bf16 2e-2, fp32 2e-5)")
    m = TRAIN_BATCH * TRAIN_SEQ
    layer = {n: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "flops": 0.0, "lib": 0.0,
                 "err": 0.0} for n in TRAINING}
    for name, d_in, d_out in projections:
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(m, d_in, generator=gen, device=dev).to(dt)
            w = (torch.randn(d_in, d_out, generator=gen, device=dev) * d_in**-0.5).to(dt)
            idx = torch.randint(0, d_in, (TRAIN_K, d_out), generator=gen, device=dev,
                                dtype=torch.int32)
            val = (torch.randn(TRAIN_K, d_out, generator=gen, device=dev) * 0.05).to(
                torch.bfloat16)
            bias = (torch.randn(d_out, generator=gen, device=dev).to(dt)
                    if name in ("wq", "wk", "wv") else None)
            # the gradient of a mean over the rows: dval stays O(1), so the
            # float32 tolerance measures rounding, not the size of a sum
            dy = (torch.randn(m, d_out, generator=gen, device=dev) * m**-0.5).to(dt)
            got = fl_mod.fused_linear(x, w, idx, val, bias)
            want = fl_mod.fused_linear_plain(x, w, idx, val, bias)
            gd = sd_mod.sparse_delta_dval(x, idx, dy)
            wd = sd_mod.sparse_delta_dval_plain(x, idx, dy)
            torch.cuda.synchronize()
            e_fl = check_close(f"fused_linear {name} K={d_in} N={d_out}", got, want, dt)
            e_dv = check_close(f"sparse_delta_dval {name}", gd, wd, dt)
            assert torch.equal(gd, sd_mod.sparse_delta_dval(x, idx, dy)), \
                f"sparse_delta_dval {name}: two launches on the same inputs differ"
            rows = [{"kernel": "fused_linear", "proj": name, "M": m, "K": d_in, "N": d_out,
                     "bias": bias is not None, "dtype": str(dt), "max_abs_err": e_fl},
                    {"kernel": "sparse_delta_dval", "proj": name, "M": m, "d_in": d_in,
                     "d_out": d_out, "dtype": str(dt), "max_abs_err": e_dv}]
            if dt == torch.bfloat16:
                for row, fn, plain, cost in (
                        (rows[0], lambda: fl_mod.fused_linear(x, w, idx, val, bias),
                         lambda: fl_mod.fused_linear_plain(x, w, idx, val, bias),
                         linear_cost(x, w, idx, val, bias)),
                        (rows[1], lambda: sd_mod.sparse_delta_dval(x, idx, dy),
                         lambda: sd_mod.sparse_delta_dval_plain(x, idx, dy),
                         dval_cost(x, idx, dy))):
                    row["ms"] = cuda_ms(fn)
                    row["plain_ms"] = cuda_ms(plain, iters=3)
                    row["bound_ms"], row["bound_by"] = bound(*cost, dt)
                    acc = layer[row["kernel"]]
                    acc["ms"] += row["ms"]
                    acc["plain_ms"] += row["plain_ms"]
                    acc["bytes"] += cost[0]
                    acc["flops"] += cost[1]
                    acc["err"] = max(acc["err"], row["max_abs_err"])
                # the library yardstick of fused_linear: the dense part only
                lib = ((lambda: torch.addmm(bias, x, w)) if bias is not None
                       else (lambda: torch.mm(x, w)))
                rows[0]["library_ms"] = cuda_ms(lib)
                layer["fused_linear"]["lib"] += rows[0]["library_ms"]
                r0, r1 = rows
                log(f"[kernels] {name} K={d_in} N={d_out}: fused_linear {r0['ms']:.4f} ms "
                    f"(plain {r0['plain_ms']:.4f}, torch.addmm dense part "
                    f"{r0['library_ms']:.4f}, bound {r0['bound_ms']:.4f} by "
                    f"{r0['bound_by']}); sparse_delta_dval {r1['ms']:.4f} ms (plain "
                    f"{r1['plain_ms']:.4f}, bound {r1['bound_ms']:.4f} by {r1['bound_by']}) "
                    f"[{card}]")
            detail.extend(rows)
    shape = (f"7 projections of one layer of qwen2-1.5b, M={m} bf16 rows, k={TRAIN_K}, "
             f"qkv bias")
    for name, mod_source, mod_replaces in (
            ("fused_linear", fl_mod.SOURCE, fl_mod.REPLACES),
            ("sparse_delta_dval", sd_mod.DVAL_SOURCE, sd_mod.DVAL_REPLACES)):
        acc = layer[name]
        b_ms, b_by = bound(acc["bytes"], acc["flops"], torch.bfloat16)
        summary[name] = {
            "source": mod_source, "replaces": mod_replaces, "max_abs_err": acc["err"],
            "ms": acc["ms"], "plain_ms": acc["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": acc["lib"] if name == "fused_linear" else None, "shape": shape,
        }
        lib = f", torch.addmm/mm dense part {acc['lib']:.4f}" if name == "fused_linear" else ""
        log(f"[kernels] {name} ok (bf16 2e-2, fp32 2e-5 at all 7 shapes): max|err| bf16 "
            f"{acc['err']:.3e}; one layer {acc['ms']:.4f} ms (plain {acc['plain_ms']:.4f}"
            f"{lib}, bound {b_ms:.4f} by {b_by}) [{card}]")


def packed_cost(x, qt, k, val, bias) -> tuple[float, float]:
    """x read once, the packed codes and scales read once (never a dense
    weight), idx/val/bias read once, y written once; 2·M·K·N flops of the
    product plus 2·M·k·N of bypass."""
    m, kd = x.shape
    n = qt.shape[-1]
    es = x.element_size()
    nbytes = (m * kd + m * n) * es + qt.nbytes
    if k:
        nbytes += k * n * (4 + val.element_size())
    if bias is not None:
        nbytes += n * es
    return nbytes, 2.0 * m * kd * n + 2.0 * m * k * n


def packed_kernels(gen, projections, dev, summary, detail, card: str) -> None:
    """``fused_linear_q`` (int8 and NF4) against its plain version: ragged
    shapes first (row, column and K tails, scale blocks that cross K tiles,
    k 0-3), then every projection at the training rows (M = batch x seq,
    bypass k = 1, qkv bias) and at the decode rows (M = slots, no bypass:
    the serving base matmul), bf16 and fp32; the bf16 calls timed and
    summed over the layer's 7 projections per (scheme, M)."""
    for rm, rk, rn, kk, block in ((130, 78, 129, 2, 32), (7, 4500, 520, 3, 128),
                                  (200, 1000, 264, 0, 6), (33, 96, 48, 1, 2)):
        for qd in PACKED:
            for dt in (torch.bfloat16, torch.float32):
                w = torch.randn(rk, rn, generator=gen, device=dev) * rk**-0.5
                qt = quantize(w.to(dt), qd, block)
                x = torch.randn(rm, rk, generator=gen, device=dev).to(dt)
                b = torch.randn(rn, generator=gen, device=dev).to(dt)
                idx = torch.randint(0, rk, (kk, rn), generator=gen, device=dev,
                                    dtype=torch.int32) if kk else None
                for vdt in (torch.bfloat16, torch.float32):
                    val = (torch.randn(kk, rn, generator=gen, device=dev) * 0.05).to(vdt) \
                        if kk else None
                    for bias in (b, None):
                        args = (x, qt.data, qt.scales, idx, val, bias)
                        got = ql_mod.fused_linear_q(*args, qdtype=qd, block=block)
                        want = ql_mod.fused_linear_q_plain(*args, qdtype=qd, block=block)
                        torch.cuda.synchronize()
                        check_close(f"fused_linear_q {qd} ragged M={rm} K={rk} N={rn} k={kk} "
                                    f"block={block}", got, want, dt)
    log("[kernels] fused_linear_q ok on ragged shapes, int8 and NF4 (M 7/33/130/200, "
        "K 78/96/1000/4500, N 48/129/264/520, blocks 2/6/32/128, k 0-3; bf16 2e-2, "
        "fp32 2e-5)")
    m_train, m_dec = TRAIN_BATCH * TRAIN_SEQ, SLOTS
    cases = {}
    for qd in PACKED:
        for m in (m_train, m_dec):
            acc = {"ms": 0.0, "plain_ms": 0.0, "lib": 0.0, "bytes": 0.0, "flops": 0.0,
                   "err": 0.0}
            for name, d_in, d_out in projections:
                w = torch.randn(d_in, d_out, generator=gen, device=dev) * d_in**-0.5
                for dt in (torch.bfloat16, torch.float32):
                    wd = w.to(dt)
                    qt = quantize(wd, qd, QUANT_BLOCK)
                    x = torch.randn(m, d_in, generator=gen, device=dev).to(dt)
                    k = TRAIN_K if m == m_train else 0
                    idx = val = bias = None
                    if k:
                        idx = torch.randint(0, d_in, (k, d_out), generator=gen, device=dev,
                                            dtype=torch.int32)
                        val = (torch.randn(k, d_out, generator=gen, device=dev) * 0.05).to(
                            torch.bfloat16)
                        if name in ("wq", "wk", "wv"):
                            bias = torch.randn(d_out, generator=gen, device=dev).to(dt)
                    args = (x, qt.data, qt.scales, idx, val, bias)
                    fn = lambda: ql_mod.fused_linear_q(*args, qdtype=qd, block=QUANT_BLOCK)  # noqa: E731
                    plain = lambda: ql_mod.fused_linear_q_plain(*args, qdtype=qd,  # noqa: E731
                                                                block=QUANT_BLOCK)
                    got, want = fn(), plain()
                    torch.cuda.synchronize()
                    err = check_close(f"fused_linear_q {qd} {name} M={m}", got, want, dt)
                    row = {"kernel": "fused_linear_q", "qdtype": qd, "proj": name, "M": m,
                           "K": d_in, "N": d_out, "k": k, "bias": bias is not None,
                           "dtype": str(dt), "max_abs_err": err}
                    if dt == torch.bfloat16:
                        cost = packed_cost(x, qt, k, val, bias)
                        row["ms"] = cuda_ms(fn)
                        row["plain_ms"] = cuda_ms(plain, iters=3)
                        row["bound_ms"], row["bound_by"] = bound(*cost, dt)
                        # yardstick: the dense part on the dense bf16 weight
                        # (no single PyTorch call dequantizes and multiplies)
                        lib = ((lambda: torch.addmm(bias, x, wd)) if bias is not None
                               else (lambda: torch.mm(x, wd)))
                        row["library_ms"] = cuda_ms(lib)
                        for key, v in (("ms", row["ms"]), ("plain_ms", row["plain_ms"]),
                                       ("lib", row["library_ms"]), ("bytes", cost[0]),
                                       ("flops", cost[1])):
                            acc[key] += v
                        acc["err"] = max(acc["err"], err)
                    detail.append(row)
            b_ms, b_by = bound(acc["bytes"], acc["flops"], torch.bfloat16)
            cases[f"{qd} M={m}"] = {"ms": acc["ms"], "plain_ms": acc["plain_ms"],
                                    "library_ms": acc["lib"], "bound_ms": b_ms,
                                    "bound_by": b_by, "max_abs_err": acc["err"]}
            log(f"[kernels] fused_linear_q {qd} one layer at M={m} (k={TRAIN_K if m == m_train else 0}): "
                f"{acc['ms']:.4f} ms (plain {acc['plain_ms']:.4f}, torch.mm dense bf16 part "
                f"{acc['lib']:.4f}, bound {b_ms:.4f} by {b_by}); max|err| bf16 "
                f"{acc['err']:.3e} [{card}]")
    head = cases[f"int8 M={m_train}"]
    summary["fused_linear_q"] = {
        "source": ql_mod.SOURCE, "replaces": ql_mod.REPLACES,
        "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "shape": f"7 projections of one layer, int8 base (block {QUANT_BLOCK}), M={m_train} "
                 f"bf16 rows, k={TRAIN_K}, qkv bias; other cases under 'cases'",
        "cases": cases,
    }
    log(f"[kernels] fused_linear_q ok (bf16 2e-2, fp32 2e-5 at all 7 shapes, int8 and NF4, "
        f"M={m_train} and M={m_dec}) [{card}]")


# --------------------------------------------------------------- engine runs


def random_tenants(params, n, seed, dtype, device, idx=None):
    """``n`` NeuroAda tenants: magnitude top-k indices (or the given
    indices tree), random values."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if idx is None:
        idx, _ = init_adapters(params, K_DELTA)
    out = []
    for _ in range(n):
        val = map_leaves(
            lambda v: None if v is None else
            (torch.randn(v.shape, generator=gen, device=device) * 0.05).to(dtype), idx)
        out.append((idx, val))
    return out


@contextlib.contextmanager
def forwards_never_wait(model):
    """Every forward of ``model`` and every token draw inside runs under
    ``torch.cuda.set_sync_debug_mode("error")``: one that waits for the
    device (``.item()``, a device-to-host copy, ``bincount``'s range read)
    raises, so the engine's fetch stays a step's only transfer."""
    def guarded(fn):
        def call(*args, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return call

    try:  # the mode must catch what it is here for
        guarded(torch.bincount)(torch.zeros(1, dtype=torch.int64, device="cuda"))
    except RuntimeError:
        pass
    else:
        raise AssertionError("sync debug mode let bincount's host read through")
    draw = Sampler.__call__
    model.prefill_chunk = guarded(model.prefill_chunk)
    model.decode_step = guarded(model.decode_step)
    Sampler.__call__ = guarded(draw)
    try:
        yield
    finally:
        del model.prefill_chunk, model.decode_step
        Sampler.__call__ = draw


def serve(model, params, tenants, prompts, max_new, device, **kw):
    store = AdapterStore(base_params=params)
    for i, (idx, val) in enumerate(tenants):
        store.register(idx, val, name=f"tenant{i + 1}")
    eng = ServeEngine(model, params, adapter_store=store, device=device, **kw)
    for i, p in enumerate(prompts):
        eng.submit(p, max_new=max_new, adapter_id=i % (len(tenants) + 1))
    return eng, eng.run_to_completion()


def attention_names(paged: bool, kv_dtype: str) -> tuple[tuple, set]:
    """(attention kernels a serving run of this layout and KV dtype must
    launch, the other attention kernels, which it must not)."""
    mine = ATTENTION[(paged, kv_dtype)]
    return mine, {n for names in ATTENTION.values() for n in names} - set(mine)


def phase_reduced(base: str = "fp32", paged: bool = True, kv_dtype: str = "fp32",
                  arch: str = "qwen2-1.5b") -> list:
    """Greedy tokens card vs CPU of reduced ``arch``; on a packed ``base``
    each engine packs the same fp32 params on its own device;
    ``paged``/``kv_dtype`` pick the KV cache. No training kernel launches.
    Returns the card's tokens."""
    cfg = reduced(get_config(arch)).replace(dtype="float32")
    model = get_model(cfg)
    params_cpu = model.init(seed=0, device="cpu")
    tenants_cpu = random_tenants(params_cpu, 2, seed=5, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist() for n in (5, 37, 12, 70, 3)]
    kw = dict(slots=3, max_len=128, prefill_chunk=16, decode_chunk=4, eos_id=1 << 20,
              base_dtype=base, quant_block=QUANT_BLOCK, paged=paged, kv_dtype=kv_dtype)
    if paged:
        kw["page_size"] = PAGE
    _, want = serve(model, params_cpu, tenants_cpu, prompts, 10, "cpu", **kw)
    to_cuda = lambda t: map_leaves(lambda x: None if x is None else x.cuda(), t)  # noqa: E731
    tenants = [(to_cuda(i), to_cuda(v)) for i, v in tenants_cpu]
    reset_counters()
    eng, got = serve(model, to_cuda(params_cpu), tenants, prompts, 10, "cuda", **kw)
    mine, others = attention_names(paged, kv_dtype)
    for c in COUNTERS.values():
        assert c.name not in mine + ("sparse_delta_batched",) or c.kernel > 0, \
            f"reduced run on the card never launched {c.name}"
        assert c.name not in others or c.kernel == 0, f"reduced {kv_dtype} run launched {c.name}"
        assert c.name not in TRAINING + SINGLE_TENANT or c.kernel == 0, \
            f"reduced serving launched the training kernel {c.name}"
        assert c.plain == 0, f"reduced run on the card called plain {c.name}"
    forwards = forwards_of(eng)
    n_q = COUNTERS["fused_linear_q"].kernel
    assert n_q == (7 * forwards if base in PACKED else 0), (base, n_q, forwards)
    assert isinstance(eng.params["blocks"]["wq"]["w"], QuantizedTensor) == (base in PACKED)
    for a, b in zip(want, got):
        assert a.out == b.out, (f"{base} base, {'paged' if paged else 'dense'} {kv_dtype} KV, "
                                f"rid {a.rid}: cpu {a.out} != cuda {b.out}")
    log(f"[reduced-{'' if arch == 'qwen2-1.5b' else arch + '-'}{base}-"
        f"{'paged' if paged else 'dense'}-{kv_dtype}] greedy tokens identical "
        f"on cpu (plain) and cuda (kernels): {len(got)} requests, "
        f"{sum(len(r.out) for r in got)} tokens; attention kernels "
        f"{ {n: COUNTERS[n].kernel for n in mine} }, fused_linear_q {n_q} launches, "
        f"{forwards} layer-forwards")
    return [r.out for r in got]


def forwards_of(eng) -> int:
    """Layer-forwards an engine ran: every mixed step is one forward, every
    decode megastep ``decode_chunk`` of them, each through every layer."""
    st = eng.step_times
    return eng.model.cfg.num_layers * (len(st["mixed"]) + eng.decode_chunk * len(st["decode"]))


def phase_full(card: str) -> dict:
    cfg = get_config("qwen2-1.5b")
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    tenants = random_tenants(params, N_TENANTS, seed=7, dtype=torch.bfloat16,
                             device="cuda")
    torch.cuda.synchronize()
    log(f"[full] qwen2-1.5b bf16 init + {N_TENANTS} tenants: "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(11)
    lens = [40, 700, 130, 256, 511, 64, 300, 620, 90, 410]
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist() for n in lens]
    max_new = 32
    kw = dict(slots=SLOTS, max_len=MAX_LEN, prefill_chunk=PREFILL_CHUNK,
              decode_chunk=DECODE_CHUNK, page_size=PAGE)
    # warm-up: cuBLAS handles and allocator pools, outside the measured run
    serve(model, params, tenants, prompts[:2], 2, "cuda", **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    with forwards_never_wait(model):
        eng, reqs = serve(model, params, tenants, prompts, max_new, "cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: COUNTERS[n].kernel for n in SERVING}
    for name, c in COUNTERS.items():
        assert name not in SERVING or c.kernel > 0, f"full run never launched {name}"
        assert c.plain == 0, f"full run called the plain version of {name} {c.plain} times"
    for r in reqs:
        assert r.done and r.reason in ("eos", "max_new"), (r.rid, r.reason, len(r.out))
        assert len(r.out) == max_new or r.out[-1] == eng.eos_id, (r.rid, r.out)
    assert eng.transfers == eng.steps, (eng.transfers, eng.steps)
    assert eng.kv.drained(), "block pool not fully free after the run"
    n_tok = sum(len(r.out) for r in reqs)
    times = {k: (float(np.mean(v)) if v else float("nan")) for k, v in eng.step_times.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[full] {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s: "
        f"{n_tok / wall:.1f} tok/s; steps {eng.steps} "
        f"(mixed {len(eng.step_times['mixed'])}, decode {len(eng.step_times['decode'])}); "
        f"mean mixed step {times['mixed'] * 1e3:.2f} ms, mean decode megastep "
        f"{times['decode'] * 1e3:.2f} ms; peak memory {peak:.2f} GiB; "
        f"preemptions {eng.preemptions} [{card}]")
    log(f"[full] launches on the serving path: {json.dumps(launches)}")
    busy, n_launch, (peng, _) = profile_run(
        lambda: serve(model, params, tenants, prompts, max_new, "cuda", **kw), card,
        "profile", "full_profile.txt")
    log(f"[full] {n_launch / forwards_of(peng):.1f} kernel launches per layer-forward "
        f"(profiled gate run, paged bf16 KV) [{card}]")
    phase_window(model, params, tenants, card, kw)
    for paged, kv_dtype in KV_CONFIGS:
        launches.update(phase_full_kv(model, params, tenants, prompts, max_new, kw, card, paged,
                                      kv_dtype))
    packed = {qd: phase_full_packed(model, params, tenants, prompts, max_new, kw, card, qd)
              for qd in PACKED}
    return launches, packed


# the KV caches beside the paged bf16 one: (paged, kv_dtype), and the cache
# bytes of full-width qwen2-1.5b at SLOTS x MAX_LEN, reckoned by hand (the
# same for both layouts): bf16 k/v, or int8 codes 117,440,512 + scales 229,376
KV_CONFIGS = ((True, "int8"), (False, "fp32"), (False, "int8"))
POOL_BYTES = {"fp32": 234_881_024, "int8": 117_669_888}


def reckoned_pool_bytes(cfg, kv_dtype: str) -> int:
    """k and v for SLOTS x MAX_LEN tokens (bf16, or int8 codes plus one
    float32 scale per 16 tokens and kv-head): the same for both layouts."""
    elems = cfg.num_layers * SLOTS * MAX_LEN * cfg.num_kv_heads * cfg.resolved_head_dim
    if kv_dtype == "fp32":
        return 2 * elems * 2
    return 2 * elems + 2 * cfg.num_layers * (SLOTS * MAX_LEN // 16) * cfg.num_kv_heads * 4


def phase_full_kv(model, params, tenants, prompts, max_new, kw, card: str, paged: bool,
                  kv_dtype: str) -> dict:
    """Phase 5 on another KV cache: the paged pool with int8 KV, the dense
    slot cache with bf16 or int8 KV. The gate run (checked: every request
    ends, one transfer per step, the cache drains, this cache's attention
    kernels launched and no other attention kernel, no plain version, pool
    bytes exactly as reckoned), the same run profiled (busy share, launches
    per layer-forward), one window run. Returns the gate run's attention
    launches."""
    name = f"{'paged' if paged else 'dense'}-{kv_dtype}"
    kw = dict(kw, paged=paged, kv_dtype=kv_dtype)
    if not paged:
        kw.pop("page_size")
    mine, others = attention_names(paged, kv_dtype)
    serve(model, params, tenants, prompts[:2], 2, "cuda", **kw)  # warm-up
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    eng, reqs = serve(model, params, tenants, prompts, max_new, "cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = {c.name: c.kernel for c in COUNTERS.values()}
    for c in COUNTERS.values():
        assert c.plain == 0, f"{name} serving called the plain version of {c.name}"
        assert c.name not in others or c.kernel == 0, f"{name} serving launched {c.name}"
    assert all(n[m] > 0 for m in mine + ("sparse_delta_batched",)), n
    for r in reqs:
        assert r.done and r.reason in ("eos", "max_new"), (r.rid, r.reason, len(r.out))
    assert eng.transfers == eng.steps, (eng.transfers, eng.steps)
    assert eng.kv.drained(), f"{name} cache not drained after the run"
    pool = eng.kv.pool_bytes()
    want = reckoned_pool_bytes(model.cfg, kv_dtype)
    assert pool == want == POOL_BYTES[kv_dtype], (pool, want)
    n_tok = sum(len(r.out) for r in reqs)
    log(f"[full-{name}] {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s: "
        f"{n_tok / wall:.1f} tok/s; steps {eng.steps}; pool {pool:,} bytes (as reckoned); "
        f"attention launches {json.dumps({m: n[m] for m in mine})}, plain 0 [{card}]")
    busy, n_launch, (peng, _) = profile_run(
        lambda: serve(model, params, tenants, prompts, max_new, "cuda", **kw), card,
        f"profile-{name}", f"full_profile_{name.replace('-', '_')}.txt")
    per_fwd = n_launch / forwards_of(peng)
    log(f"[full-{name}] {per_fwd:.1f} kernel launches per layer-forward (profiled gate run) "
        f"[{card}]")
    phase_window(model, params, tenants, card, kw, repeats=1, tag=f"window-{name}",
                 fname=f"window_{name.replace('-', '_')}.json",
                 extra={"paged": paged, "kv_dtype": kv_dtype, "pool_bytes": pool,
                        "busy_share": busy, "launches_per_layer_forward": per_fwd})
    return {m: n[m] for m in mine}


def phase_full_packed(model, params, tenants, prompts, max_new, kw, card: str,
                      qd: str) -> int:
    """Phase 5 on a packed base: ``ServeEngine(base_dtype=qd)`` packs the
    base at init on the card; the same tenants, prompts and settings serve
    the gate run (checked: every base matmul through ``fused_linear_q``,
    7 per layer-forward, tenants' bypasses on top) and one window run.
    Returns the gate run's ``fused_linear_q`` launches."""
    t0 = time.perf_counter()
    eng, _ = serve(model, params, tenants, prompts[:2], 2, "cuda", base_dtype=qd,
                   quant_block=QUANT_BLOCK, **kw)  # warm-up, and the packed base
    torch.cuda.synchronize()
    packed = eng.params
    assert isinstance(packed["blocks"]["wq"]["w"], QuantizedTensor)
    base_bytes = tree_bytes(packed)
    log(f"[full-{qd}] base packed on the card by ServeEngine(base_dtype={qd!r}): "
        f"{tree_bytes(params):,} -> {base_bytes:,} bytes; warm-up "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    del eng
    reset_counters()
    t0 = time.perf_counter()
    eng, reqs = serve(model, packed, tenants, prompts, max_new, "cuda", base_dtype=qd,
                      quant_block=QUANT_BLOCK, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = {name: c.kernel for name, c in COUNTERS.items()}
    for name, c in COUNTERS.items():
        assert c.plain == 0, f"{qd} serving called the plain version of {name} {c.plain} times"
    forwards = n["paged_decode_attention"] + n["paged_prefill_attention"]  # one a layer-forward
    assert n["fused_linear_q"] == 7 * forwards > 0, (n, forwards)
    assert n["sparse_delta_batched"] > 0 and n["fused_linear"] == 0, n
    for r in reqs:
        assert r.done and r.reason in ("eos", "max_new"), (r.rid, r.reason, len(r.out))
    assert eng.transfers == eng.steps, (eng.transfers, eng.steps)
    assert eng.kv.drained(), "block pool not fully free after the run"
    n_tok = sum(len(r.out) for r in reqs)
    log(f"[full-{qd}] {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s: {n_tok / wall:.1f} "
        f"tok/s; steps {eng.steps}; launches {json.dumps(n)} (fused_linear_q = 7 x "
        f"{forwards} layer-forwards), plain 0 [{card}]")
    phase_window(model, packed, tenants, card, dict(kw, base_dtype=qd, quant_block=QUANT_BLOCK),
                 repeats=1, tag=f"window-{qd}", fname=f"window_{qd}.json",
                 extra={"base_dtype": qd, "base_bytes": base_bytes})
    return n["fused_linear_q"]


# a longer, decode-dominated window, repeated: the run above is a smoke
# figure (20 steps); tokens/s and step times are taken here, with spread
WINDOW_REQUESTS, WINDOW_NEW, WINDOW_REPEATS = 16, 128, 2


def phase_window(model, params, tenants, card: str, kw: dict, repeats: int = WINDOW_REPEATS,
                 tag: str = "window", fname: str = "window.json", extra=None) -> None:
    rng = np.random.default_rng(13)
    lens = rng.integers(40, 701, size=WINDOW_REQUESTS)
    prompts = [rng.integers(3, model.cfg.vocab_size, size=int(n)).tolist() for n in lens]
    runs = []
    for i in range(repeats):
        t0 = time.perf_counter()
        eng, reqs = serve(model, params, tenants, prompts, WINDOW_NEW, "cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert all(r.done for r in reqs) and eng.kv.drained()
        assert eng.transfers == eng.steps, (eng.transfers, eng.steps)
        n_tok = sum(len(r.out) for r in reqs)
        st = eng.step_times
        runs.append({"tok_s": n_tok / wall, "wall_s": wall, "tokens": n_tok,
                     "mixed_steps": len(st["mixed"]), "decode_steps": len(st["decode"]),
                     "mixed_ms": float(np.mean(st["mixed"])) * 1e3,
                     "decode_ms": float(np.mean(st["decode"])) * 1e3})
        r = runs[-1]
        log(f"[{tag}] run {i + 1}/{repeats}: {n_tok} tokens in {wall:.3f} s = "
            f"{r['tok_s']:.1f} tok/s; mixed {r['mixed_steps']} x {r['mixed_ms']:.2f} ms, "
            f"decode {r['decode_steps']} x {r['decode_ms']:.2f} ms [{card}]")
    stats = {}
    for key in ("tok_s", "mixed_ms", "decode_ms"):
        vals = [r[key] for r in runs]
        stats[key] = {"median": float(np.median(vals)), "min": min(vals), "max": max(vals)}
    with open(os.path.join(OUT_DIR, fname), "w") as f:
        json.dump({"card": card, "requests": WINDOW_REQUESTS, "prompt_tokens": int(lens.sum()),
                   "max_new": WINDOW_NEW, "runs": runs, "stats": stats, **(extra or {})},
                  f, indent=1)
    t, d, m = stats["tok_s"], stats["decode_ms"], stats["mixed_ms"]
    log(f"[{tag}] {WINDOW_REQUESTS} requests ({int(lens.sum())} prompt tokens) x "
        f"{WINDOW_NEW} new, {repeats} runs: median {t['median']:.1f} tok/s "
        f"(min {t['min']:.1f}, max {t['max']:.1f}); decode megastep median "
        f"{d['median']:.2f} ms ({d['median'] / DECODE_CHUNK:.2f} ms per token step; min "
        f"{d['min']:.2f}, max {d['max']:.2f}); mixed step median {m['median']:.2f} ms "
        f"(min {m['min']:.2f}, max {m['max']:.2f}) [{card}]")


BUCKETS = (("paged_prefill_attention", ("paged_prefill",)),
           ("paged_decode_attention", ("paged_decode",)),
           ("sparse_delta_batched", ("idsfromarray",)),
           ("sparse_delta", ("idsfromrow",)),
           ("fused_linear_q", ("fused_linear_q",)),
           ("fused_linear", ("fused_linear",)),
           ("sparse_delta_dval", ("dval_",)),
           ("index ops (index_add_, gathers)", ("index",)),
           ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "splitk")))


def profile_run(run, card: str, tag: str, fname: str) -> tuple[float, int, object]:
    """``run`` under ``torch.profiler``: device time by kernel (a table in
    the output directory's ``fname``), by bucket; returns the device's busy
    share of the run's wall time, the number of kernels launched and what
    ``run`` returned. Only the device is traced: nothing here reads the
    host's op trace, and with 10^5 kernels a run its post-processing takes
    minutes."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = self_device_us
    rows = sorted((e for e in device_kernels(prof) if dev(e) > 0), key=dev, reverse=True)
    total = sum(dev(e) for e in rows)
    with open(os.path.join(OUT_DIR, fname), "w") as f:
        f.write(f"{card}\nwall {wall_us:.0f} us, device {total:.0f} us\n")
        for e in rows:
            f.write(f"{dev(e):12.0f} us {e.count:7d} x  {e.key}\n")
    buckets = {name: 0.0 for name, _ in BUCKETS}
    for e in rows:
        key = e.key.lower()
        name = next((n for n, pats in BUCKETS if any(p in key for p in pats)), "other")
        buckets[name] = buckets.get(name, 0.0) + dev(e)
    shares = ", ".join(f"{k} {v / total:.1%}" for k, v in buckets.items() if v)
    n_launch = sum(e.count for e in rows)
    log(f"[{tag}] device busy {total / wall_us:.1%} of {wall_us / 1e3:.1f} ms wall "
        f"(profiled run; device {total / 1e3:.1f} ms, {n_launch} kernels); device time: "
        f"{shares} [{card}]")
    return total / wall_us, n_launch, out


# ---------------------------------------------------------------- training


def train_run(model, params, pcfg, tcfg, batches):
    """Train on ``batches`` (numpy) from ``params``; (losses, values)."""
    trainer = Trainer(model, get_peft(pcfg), tcfg, params)
    hist = trainer.run(iter(batches))
    return [h["loss"] for h in hist], trainer.state.trainable


def packed_fingerprint(params) -> list:
    """Per packed leaf: its bytes summed (codes, and scales as int32 bits),
    on the card — a change of any byte shows up with high odds."""
    return [torch.stack([x.data.view(torch.uint8).sum(dtype=torch.int64),
                         x.scales.view(torch.int32).sum(dtype=torch.int64)])
            for _, x in flatten(params) if isinstance(x, QuantizedTensor)]


def path_kernels(base: str, cfg) -> tuple[tuple, tuple]:
    """(kernels a training step must launch, kernels it must not) on a base;
    the single-tenant bypass runs only where the model has an untied head
    or expert stacks to adapt (the MoE family)."""
    moe = bool(cfg.num_experts)
    single = (SINGLE_TENANT, ()) if moe else ((), SINGLE_TENANT)
    if base == "bf16":
        return TRAINING + single[0], PACKED_BASE + single[1]
    return PACKED_BASE + ("sparse_delta_dval",) + single[0], ("fused_linear",) + single[1]


def step_launches(cfg, base: str) -> dict:
    """Launches of each path kernel in one training step: every adapted
    matrix once forward (its kernel) and once backward (dval). Dense: 7
    projections a layer; MoE: 4 attention projections through fused_linear,
    3 expert stacks and the untied head through sparse_delta."""
    L = cfg.num_layers
    if cfg.num_experts:
        return {"fused_linear": 4 * L, "sparse_delta": 3 * L + 1, "sparse_delta_dval": 7 * L + 1}
    return {n: 7 * L for n in path_kernels(base, cfg)[0]}


def trainable_count(cfg, k: int) -> int:
    """NeuroAda values: k per output neuron of every adapted matrix."""
    hd = cfg.resolved_head_dim
    attn = cfg.num_heads * hd + 2 * cfg.num_kv_heads * hd + cfg.d_model
    mlp = 2 * cfg.d_ff + cfg.d_model
    per_layer = attn + (cfg.num_experts * mlp if cfg.num_experts else mlp)
    head = 0 if cfg.tie_embeddings else cfg.padded_vocab
    return k * (cfg.num_layers * per_layer + head)


# card vs CPU after three AdamW steps, relative on the value tree. The MoE
# family is worse conditioned: on the CPU alone, weights perturbed by 1e-7
# (relative) move reduced olmoe's values by 3.7e-5 (reduced qwen2's by
# 9e-7) — a few wgate values whose first gradients nearly vanish take Adam
# steps of another size (Adam's first step is ±lr whatever the gradient's
# magnitude). Losses are held to 1e-5 for both.
VALUE_TOL = {"dense": 1e-5, "moe": 1e-4}


def phase_reduced_train(card: str, base: str = "bf16", arch: str = "qwen2-1.5b") -> None:
    """Reduced ``arch`` in fp32 (fp32 values too), the same params and
    three batches, trained on the card and on the CPU; on a packed base the
    params are packed on the CPU and the same bytes move to the card."""
    cfg = reduced(get_config(arch)).replace(dtype="float32")
    model = get_model(cfg)
    params_cpu = model.init(seed=0, device="cpu")
    if base != "bf16":
        params_cpu = quantize_base(params_cpu, base, block=QUANT_BLOCK)
    pcfg = PeftConfig(k=2, delta_dtype="float32")
    tcfg = TrainConfig(steps=3, learning_rate=TRAIN_LR)
    batches = [TASKS["reasoning"](cfg.vocab_size, 4, 16, 0, i) for i in range(3)]
    want_loss, want_val = train_run(model, params_cpu, pcfg, tcfg, batches)
    to_cuda = lambda t: map_leaves(lambda x: None if x is None else x.to("cuda"), t)  # noqa: E731
    reset_counters()
    got_loss, got_val = train_run(model, to_cuda(params_cpu), pcfg, tcfg, batches)
    must, must_not = path_kernels(base, cfg)
    for name, c in COUNTERS.items():
        assert name not in must or c.kernel > 0, f"reduced training never launched {name}"
        assert name not in must_not or c.kernel == 0, f"reduced training launched {name}"
        assert c.plain == 0, f"reduced training on the card called plain {name}"
    for i, (a, b) in enumerate(zip(want_loss, got_loss)):
        assert abs(a - b) <= 1e-5, f"step {i}: loss cpu {a!r} != cuda {b!r}"
    # relative error of the whole value tree: ||cuda - cpu|| / ||cpu||
    pairs = [(a, b.cpu()) for (_, a), (_, b) in zip(flatten(want_val), flatten(got_val))
             if a is not None]
    diff = sum(float((b - a).double().square().sum()) for a, b in pairs) ** 0.5
    norm = sum(float(a.double().square().sum()) for a, _ in pairs) ** 0.5
    tol = VALUE_TOL["moe" if cfg.num_experts else "dense"]
    assert diff <= tol * norm, f"values: ||cuda - cpu|| / ||cpu|| = {diff / norm:.3e} > {tol}"
    base_txt = "fp32 base" if base == "bf16" else f"{base} base"
    log(f"[reduced-train] 3 steps of reduced {arch} fp32, {base_txt}: losses cpu "
        f"{[f'{x:.7f}' for x in want_loss]} cuda {[f'{x:.7f}' for x in got_loss]} "
        f"(max |diff| {max(abs(a - b) for a, b in zip(want_loss, got_loss)):.2e}); values "
        f"||cuda - cpu|| / ||cpu|| = {diff / norm:.2e} [{card}]")


def phase_train(card: str, base: str = "bf16", arch: str = "qwen2-1.5b") -> dict:
    """Full-width NeuroAda training of ``arch`` on a bf16 base, or on one
    packed to ``base`` (int8, NF4) after init and before selection, as the
    launcher does; then its adapter served on the same base (for MoE beside
    two random tenants, with a window run). Returns the measured steps'
    launches and the step's figures."""
    cfg = get_config(arch)
    model = get_model(cfg)
    params = model.init(seed=0, device="cuda")
    if base != "bf16":
        params = quantize_base(params, base, block=QUANT_BLOCK)  # the dense base is freed
    base_bytes = tree_bytes(params)
    tcfg = TrainConfig(steps=TRAIN_WARMUP + TRAIN_STEPS + 1, learning_rate=TRAIN_LR)
    moe = bool(cfg.num_experts)
    tag = "train" if base == "bf16" else f"train-{base}"
    tag = "train-olmoe" if moe else tag
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = Trainer(model, get_peft(PeftConfig(k=TRAIN_K)), tcfg, params)
    torch.cuda.synchronize()
    select_s = time.perf_counter() - t0
    st = stats(params, trainer.state.trainable)
    assert st["trainable"] == trainable_count(cfg, TRAIN_K), st
    log(f"[{tag}] {arch} {base} base ({base_bytes:,} bytes), NeuroAda k={TRAIN_K} "
        f"magnitude: trainable {st['trainable']:,} of {st['total']:,} "
        f"({100 * st['fraction']:.4f} %), selection {select_s:.2f} s [{card}]")
    must, must_not = path_kernels(base, cfg)
    data = DataLoader("lm", cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    try:
        for _ in range(TRAIN_WARMUP):
            trainer.step(next(data))
        fingerprint = packed_fingerprint(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        times, losses, peak = [], [], 0
        for _ in range(TRAIN_STEPS):
            batch = next(data)
            t0 = time.perf_counter()
            m = trainer.step(batch)  # returns floats: waits for the device
            times.append(time.perf_counter() - t0)
            peak = max(peak, torch.cuda.max_memory_allocated())
            losses.append(m["loss"])
            assert m["skipped"] == 0, m
            # the packed base is the same, byte for byte, after every step
            # (checked outside the step's time and peak memory)
            assert tree_bytes(params) == base_bytes
            assert all(torch.equal(a, b) for a, b in zip(fingerprint,
                                                         packed_fingerprint(params)))
            torch.cuda.reset_peak_memory_stats()
        launches = {n: COUNTERS[n].kernel for n in must}
        for name, c in COUNTERS.items():
            assert c.plain == 0, f"training called the plain version of {name} {c.plain} times"
            assert name not in must_not or c.kernel == 0, f"training launched {name}"
        per_step = {n: v / TRAIN_STEPS for n, v in launches.items()}
        want = step_launches(cfg, base)
        assert per_step == want, (per_step, want)
        assert all(np.isfinite(losses)), losses
        prof = f"{tag.replace('-', '_')}_profile.txt"
        busy, _, _ = profile_run(lambda: trainer.step(next(data)), card, f"{tag}-profile",
                                 prof)
    finally:
        data.close()
    med = float(np.median(times))
    tok = TRAIN_BATCH * TRAIN_SEQ
    log(f"[{tag}] losses {[round(x, 4) for x in losses]} (all finite) [{card}]")
    log(f"[{tag}] {TRAIN_STEPS} steps of batch {TRAIN_BATCH} x seq {TRAIN_SEQ}: step time "
        f"median {med * 1e3:.2f} ms (min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}); "
        f"{tok / med:.0f} training tokens/s; peak memory {peak / 2**30:.2f} GiB; base "
        f"{base_bytes:,} bytes; launches per step {json.dumps(per_step)}, plain 0; device "
        f"busy {busy:.1%} of a profiled step [{card}]")
    result = {"card": card, "base": base, "base_bytes": base_bytes, "losses": losses,
              "step_s": times, "tokens_per_step": tok, "peak_bytes": peak,
              "launches_per_step": per_step, "busy_share": busy,
              "trainable": st["trainable"], "fraction": st["fraction"]}
    with open(os.path.join(OUT_DIR, f"{tag.replace('-', '_')}.json"), "w") as f:
        json.dump(dict(result, arch=arch), f, indent=1)
    out = {"launches": launches, "peak": peak, "median_s": med}
    if moe:
        out["serve_launches"] = serve_moe(model, params, trainer, card)
    else:
        serve_trained(model, params, trainer, card, tag)
    return out


def serve_trained(model, params, trainer, card: str, tag: str) -> None:
    """Export the trained adapter, load it back and serve it as tenant 1
    beside the base (id 0), on the base it was trained on."""
    path = os.path.join(OUT_DIR, f"{tag}_adapter.npz")
    export_adapter(path, trainer.aux, trainer.state.trainable, {"arch": model.cfg.name})
    idx, val = load_adapter(path)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(3, model.cfg.vocab_size, size=n).tolist() for n in (60, 300, 25, 128)]
    reset_counters()
    eng, reqs = serve(model, params, [(idx, val)], prompts, 16, "cuda", slots=4, max_len=512,
                      prefill_chunk=PREFILL_CHUNK, decode_chunk=DECODE_CHUNK, page_size=PAGE)
    assert all(r.done for r in reqs) and eng.kv.drained()
    assert {r.adapter_id for r in reqs} == {0, 1}
    assert COUNTERS["sparse_delta_batched"].kernel > 0
    assert all(c.plain == 0 for c in COUNTERS.values())
    packed = any(isinstance(x, QuantizedTensor) for _, x in flatten(params))
    assert (COUNTERS["fused_linear_q"].kernel > 0) == packed
    log(f"[{tag}] exported adapter ({os.path.getsize(path)} bytes) served as tenant 1 beside "
        f"the base{' on the packed base it was trained on' if packed else ''}: {len(reqs)} "
        f"requests, {sum(len(r.out) for r in reqs)} tokens [{card}]")


def serve_moe(model, params, trainer, card: str) -> dict:
    """Full-width olmoe serving: the trained adapter (exported and loaded
    back) as tenant 1 beside two random tenants on its indices and the base,
    with phase 5's engine settings and prompts. The gate run (every request
    ends, the paged serving kernels launched and no training kernel, no
    plain version, one transfer a step, the pool drains, pool bytes as
    reckoned), the same run profiled (busy share, launches per
    layer-forward), then one window run. Returns the gate run's launches of
    the serving kernels."""
    path = os.path.join(OUT_DIR, "train-olmoe_adapter.npz")
    export_adapter(path, trainer.aux, trainer.state.trainable, {"arch": model.cfg.name})
    idx, val = load_adapter(path)
    idx, val = (map_leaves(lambda x: None if x is None else x.cuda(), t) for t in (idx, val))
    tenants = [(idx, val)] + random_tenants(params, 2, seed=9, dtype=torch.bfloat16,
                                            device="cuda", idx=idx)
    rng = np.random.default_rng(11)
    lens = [40, 700, 130, 256, 511, 64, 300, 620, 90, 410]
    prompts = [rng.integers(3, model.cfg.vocab_size, size=n).tolist() for n in lens]
    max_new = 32
    kw = dict(slots=SLOTS, max_len=MAX_LEN, prefill_chunk=PREFILL_CHUNK,
              decode_chunk=DECODE_CHUNK, page_size=PAGE)
    serve(model, params, tenants, prompts[:2], 2, "cuda", **kw)  # warm-up
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    with forwards_never_wait(model):
        eng, reqs = serve(model, params, tenants, prompts, max_new, "cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = {name: c.kernel for name, c in COUNTERS.items()}
    for name, c in COUNTERS.items():
        assert c.plain == 0, f"olmoe serving called the plain version of {name}"
        assert name in SERVING or c.kernel == 0, f"olmoe serving launched {name}"
        assert name not in SERVING or c.kernel > 0, f"olmoe serving never launched {name}"
    for r in reqs:
        assert r.done and r.reason in ("eos", "max_new"), (r.rid, r.reason, len(r.out))
    assert {r.adapter_id for r in reqs} == {0, 1, 2, 3}
    assert eng.transfers == eng.steps, (eng.transfers, eng.steps)
    assert eng.kv.drained(), "olmoe block pool not fully free after the run"
    pool = eng.kv.pool_bytes()
    assert pool == MOE_POOL_BYTES, pool
    n_tok = sum(len(r.out) for r in reqs)
    st = eng.step_times
    log(f"[serve-olmoe] trained adapter ({os.path.getsize(path):,} bytes) as tenant 1 beside 2 "
        f"random tenants and the base: {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s: "
        f"{n_tok / wall:.1f} tok/s; steps {eng.steps} (mixed {len(st['mixed'])} x "
        f"{float(np.mean(st['mixed'])) * 1e3:.2f} ms, decode {len(st['decode'])} x "
        f"{float(np.mean(st['decode'])) * 1e3:.2f} ms); pool {pool:,} bytes (as reckoned); "
        f"launches {json.dumps({k: n[k] for k in SERVING})}, plain 0 [{card}]")
    busy, n_launch, (peng, _) = profile_run(
        lambda: serve(model, params, tenants, prompts, max_new, "cuda", **kw), card,
        "profile-olmoe", "full_profile_olmoe.txt")
    per_fwd = n_launch / forwards_of(peng)
    log(f"[serve-olmoe] {per_fwd:.1f} kernel launches per layer-forward (profiled gate run) "
        f"[{card}]")
    phase_window(model, params, tenants, card, kw, repeats=1, tag="window-olmoe",
                 fname="window_olmoe.json",
                 extra={"arch": model.cfg.name, "pool_bytes": pool, "busy_share": busy,
                        "launches_per_layer_forward": per_fwd})
    return {k: n[k] for k in SERVING}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(OUT_DIR, exist_ok=True)

    card = card_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    secs, build_log = build.timed_build()
    with open(os.path.join(OUT_DIR, "kernel_build.log"), "w") as f:
        f.write(build_log)
    log(f"[build] {len(build.SIGNATURES)} kernels built in {secs:.1f} s "
        f"(sm_90a, nvcc; log in chiprun_out/kernel_build.log)")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line and " 0 bytes spill" not in line:
            log("[build] " + line.strip())

    stamps = [("build", time.perf_counter())]
    stamp = lambda name: stamps.append((name, time.perf_counter()))  # noqa: E731
    summary, detail = phase_kernels(torch.device("cuda"), card)
    stamp("kernels")
    with open(os.path.join(OUT_DIR, "chip_smoke_kernels.json"), "w") as f:
        json.dump({"card": card, "rows": detail}, f, indent=1)
    for base in ("fp32",) + PACKED:
        phase_reduced(base)
    # int8 KV on the paged pool (also on an int8 base) and the dense cache
    int8_paged = phase_reduced("fp32", True, "int8")
    phase_reduced("int8", True, "int8")
    phase_reduced("fp32", False, "fp32")
    int8_dense = phase_reduced("fp32", False, "int8")
    assert int8_paged == int8_dense, "paged and dense int8 KV gave different tokens on the card"
    log("[reduced] paged and dense int8 KV: identical greedy tokens on the card")
    stamp("reduced serving")
    launches, packed_serving = phase_full(card)
    stamp("full serving")
    for base in ("bf16",) + PACKED:
        phase_reduced_train(card, base)
    stamp("reduced training")
    train = {base: phase_train(card, base) for base in ("bf16",) + PACKED}
    stamp("full training")
    torch.cuda.empty_cache()
    phase_reduced_train(card, "bf16", MOE_ARCH)
    phase_reduced("fp32", arch=MOE_ARCH)
    stamp("reduced olmoe")
    train["olmoe"] = phase_train(card, "bf16", MOE_ARCH)
    stamp("olmoe training and serving")
    log("[timing] seconds by phase: " + ", ".join(
        f"{name} {t1 - t0:.1f}" for (_, t0), (name, t1) in zip(stamps, stamps[1:])))
    launches.update(train["bf16"]["launches"])
    launches["sparse_delta"] = train["olmoe"]["launches"]["sparse_delta"]
    for base in PACKED:
        peak, ref_peak = train[base]["peak"], train["bf16"]["peak"]
        assert peak < ref_peak, f"{base} training peak {peak} >= bf16's {ref_peak}"
        log(f"[train-{base}] peak memory {peak / 2**30:.2f} GiB < bf16 base's "
            f"{ref_peak / 2**30:.2f} GiB; step median {train[base]['median_s'] * 1e3:.2f} ms "
            f"against {train['bf16']['median_s'] * 1e3:.2f} ms [{card}]")
    # fused_linear_q's launches on its paths: the packed training runs' measured
    # steps and the packed serving gate runs
    by_phase = {f"train-{b}": train[b]["launches"]["fused_linear_q"] for b in PACKED}
    by_phase.update({f"serve-{b}": n for b, n in packed_serving.items()})
    launches["fused_linear_q"] = sum(by_phase.values())

    olmoe_launches = {**train["olmoe"]["serve_launches"], **train["olmoe"]["launches"]}
    kernels = []
    for name, s in summary.items():
        row = {
            "name": name, "route": "cuda", "source": s["source"],
            "replaces": s["replaces"], "launches": launches[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"], "kernel_ms": s["ms"],
            "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
            "library_ms": s["library_ms"], "shape": s["shape"],
        }
        if name == "fused_linear_q":
            row.update(launches_by_phase=by_phase, cases=s["cases"])
        if "olmoe" in s:
            # olmoe's own shapes and launches: the training run's measured
            # steps for the training kernels, its serving gate run for the rest
            row.update(olmoe=dict(s["olmoe"], launches=olmoe_launches[name]))
        kernels.append(row)
    log(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
