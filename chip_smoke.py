#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one card

Phases, in order, with no fallback anywhere (any failure exits non-zero):

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compile the three hand-written CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (timed);
3. kernels: each kernel against its plain PyTorch version on the card at
   the full-width qwen2-1.5b serving shapes (bf16 and fp32; ragged
   frontiers, shared and sentinel pages), then timed beside its plain
   version, its bound and, for attention, one
   ``F.scaled_dot_product_attention`` call on the pre-gathered cache as a
   yardstick (the port never calls it);
4. reduced: reduced qwen2-1.5b in fp32 through the paged multi-tenant
   engine on the card (kernels) and on the CPU (plain versions): greedy
   tokens must be identical;
5. full: qwen2-1.5b at full published width in bf16, random weights from a
   seed, 3 NeuroAda tenants plus the base, 8 slots, ``max_len`` 1024,
   prompts of 40-700 tokens: every request ends, all three kernels
   launched, no plain version called, one device-to-host transfer per
   step, the block pool fully free at the end; the same run again under
   ``torch.profiler`` (device time by kernel); then a longer,
   decode-dominated window (16 requests x 128 new tokens) served three
   times, for the median and spread of tokens/s and step times.

The second-to-last line of output is the kernels JSON line, the last line
``{"ok": true, "device": {...}}``. Detailed per-shape kernel results go to
``chiprun_out/chip_smoke_kernels.json``, the window's runs to
``chiprun_out/window.json``. Exits non-zero without CUDA, and
outside a checkout of the repository (the package is not importable).
"""

from __future__ import annotations

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

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.adapt import init_adapters  # noqa: E402
from repro_torch.kernels import COUNTERS, build, reset_counters  # noqa: E402
from repro_torch.kernels import decode_attention as dec_mod  # noqa: E402
from repro_torch.kernels import prefill_attention as pre_mod  # noqa: E402
from repro_torch.kernels import sparse_delta as sd_mod  # noqa: E402
from repro_torch.kernels.ref import gather_paged_kv  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import AdapterStore, ServeEngine  # noqa: E402
from repro_torch.tree import map_leaves  # noqa: E402

OUT_DIR = os.path.join(ROOT, "chiprun_out")
# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and dense bf16
# tensor-core rate; fp32 work outside the tensor cores runs at 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

# full-width serving shape of qwen2-1.5b (configs/qwen2_1p5b.py)
SLOTS, MAX_LEN, PAGE, PREFILL_CHUNK, DECODE_CHUNK = 8, 1024, 16, 256, 8
N_TENANTS, K_DELTA = 3, 2


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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(self_device_us(e) for e in device_kernels(prof)) / iters / 1e3


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


def paged_case(gen, q_off, q_len, c, dtype, dev, num_blocks, share_pages=3):
    """q (B, c, 12, 128) against a pool of ``num_blocks`` pages through a
    table with ragged frontiers ``q_off + q_len``; slots 0 and 1 share their
    leading pages, pages past each frontier hold the sentinel
    ``num_blocks``."""
    cfg = get_config("qwen2-1.5b")
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


def sdpa_yardstick(q, kp, vp, table, mask):
    """One SDPA call on the pre-gathered, head-expanded cache (timed only)."""
    h, hkv = q.shape[2], kp.shape[2]
    k = gather_paged_kv(kp, table).repeat_interleave(h // hkv, dim=2).transpose(1, 2)
    v = gather_paged_kv(vp, table).repeat_interleave(h // hkv, dim=2).transpose(1, 2)
    qt = q.transpose(1, 2)
    k, v, qt = k.contiguous(), v.contiguous(), qt.contiguous()
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask)


def phase_kernels(dev) -> tuple[dict, list]:
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
        "mod": sd_mod, "max_abs_err": err_bf16, "ms": layer["ms"],
        "plain_ms": layer["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
        "shape": f"7 projections of one layer, M={m_mixed} bf16 rows, k={K_DELTA}, "
                 f"N={N_TENANTS + 1}",
    }
    log(f"[kernels] sparse_delta_batched ok: max|err| bf16 {err_bf16:.3e}, "
        f"one layer at M={m_mixed}: {layer['ms']:.4f} ms (plain {layer['plain_ms']:.4f} ms, "
        f"bound {b_ms:.4f} ms by {b_by})")

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
            flops = 4.0 * float(vl.sum()) * q.shape[2] * q.shape[3]
            q_rows = int((vl > 0).sum())
            row["bound_ms"], row["bound_by"] = bound(
                attention_bytes(q, kp, table, vl, q_rows, 1), flops, dt)
            summary["paged_decode_attention"] = dict(
                mod=dec_mod, max_abs_err=err, ms=row["ms"], plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=row["library_ms"],
                shape=f"q (8,1,12,128) bf16, pool ({num_blocks},16,2,128), "
                      f"kv_valid_len {dec_vl}")
        detail.append(row)
    r = summary["paged_decode_attention"]
    log(f"[kernels] paged_decode_attention ok: max|err| bf16 {r['max_abs_err']:.3e}, "
        f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, sdpa {r['library_ms']:.4f}, "
        f"bound {r['bound_ms']:.4f} by {r['bound_by']})")

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
            s = table.shape[1] * PAGE
            col = torch.arange(s, device=dev)[None, None, :]
            qpos = qoff[:, None, None] + torch.arange(PREFILL_CHUNK, device=dev)[None, :, None]
            mask = ((col <= qpos) & (col < vl[:, None, None]))[:, None]
            row["library_ms"] = cuda_ms(sdpa_yardstick(q, kp, vp, table, mask))
            visible = mask[:, 0].sum().item()
            flops = 4.0 * visible * q.shape[2] * q.shape[3]
            q_rows = int(mask[:, 0].any(-1).sum())
            row["bound_ms"], row["bound_by"] = bound(
                attention_bytes(q, kp, table, vl, q_rows, 2), flops, dt)
            summary["paged_prefill_attention"] = dict(
                mod=pre_mod, max_abs_err=err, ms=row["ms"], plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=row["library_ms"],
                shape=f"q (8,256,12,128) bf16, pool ({num_blocks},16,2,128), "
                      f"q_offset {pre_off}, q_len {pre_len}")
        detail.append(row)
    r = summary["paged_prefill_attention"]
    log(f"[kernels] paged_prefill_attention ok: max|err| bf16 {r['max_abs_err']:.3e}, "
        f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, sdpa {r['library_ms']:.4f}, "
        f"bound {r['bound_ms']:.4f} by {r['bound_by']})")
    return summary, detail


# --------------------------------------------------------------- engine runs


def random_tenants(params, n, seed, dtype, device):
    """``n`` NeuroAda tenants: magnitude top-k indices, random values."""
    gen = torch.Generator(device=device).manual_seed(seed)
    idx, val0 = init_adapters(params, K_DELTA)
    out = []
    for _ in range(n):
        val = map_leaves(
            lambda v: None if v is None else
            (torch.randn(v.shape, generator=gen, device=device) * 0.05).to(dtype), val0)
        out.append((idx, val))
    return out


def serve(model, params, tenants, prompts, max_new, device, **kw):
    store = AdapterStore(base_params=params)
    for i, (idx, val) in enumerate(tenants):
        store.register(idx, val, name=f"tenant{i + 1}")
    eng = ServeEngine(model, params, adapter_store=store, device=device, **kw)
    for i, p in enumerate(prompts):
        eng.submit(p, max_new=max_new, adapter_id=i % (len(tenants) + 1))
    return eng, eng.run_to_completion()


def phase_reduced() -> None:
    cfg = reduced(get_config("qwen2-1.5b")).replace(dtype="float32")
    model = get_model(cfg)
    params_cpu = model.init(seed=0, device="cpu")
    tenants_cpu = random_tenants(params_cpu, 2, seed=5, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist() for n in (5, 37, 12, 70, 3)]
    kw = dict(slots=3, max_len=128, prefill_chunk=16, decode_chunk=4, page_size=PAGE,
              eos_id=1 << 20)
    _, want = serve(model, params_cpu, tenants_cpu, prompts, 10, "cpu", **kw)
    to_cuda = lambda t: map_leaves(lambda x: None if x is None else x.cuda(), t)  # noqa: E731
    tenants = [(to_cuda(i), to_cuda(v)) for i, v in tenants_cpu]
    reset_counters()
    eng, got = serve(model, to_cuda(params_cpu), tenants, prompts, 10, "cuda", **kw)
    for c in COUNTERS.values():
        assert c.kernel > 0, f"reduced run on the card never launched {c.name}"
        assert c.plain == 0, f"reduced run on the card called plain {c.name}"
    for a, b in zip(want, got):
        assert a.out == b.out, f"rid {a.rid}: cpu {a.out} != cuda {b.out}"
    log(f"[reduced] greedy tokens identical on cpu (plain) and cuda (kernels): "
        f"{len(got)} requests, {sum(len(r.out) for r in got)} tokens")


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
    eng, reqs = serve(model, params, tenants, prompts, max_new, "cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c.kernel for n, c in COUNTERS.items()}
    for name, c in COUNTERS.items():
        assert c.kernel > 0, f"full run never launched {name}"
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
    log(f"[full] launches on the main path: {json.dumps(launches)}")
    profile_serve(lambda: serve(model, params, tenants, prompts, max_new, "cuda", **kw), card)
    phase_window(model, params, tenants, card, kw)
    return launches


# a longer, decode-dominated window, repeated: the run above is a smoke
# figure (20 steps); tokens/s and step times are taken here, with spread
WINDOW_REQUESTS, WINDOW_NEW, WINDOW_REPEATS = 16, 128, 3


def phase_window(model, params, tenants, card: str, kw: dict) -> None:
    rng = np.random.default_rng(13)
    lens = rng.integers(40, 701, size=WINDOW_REQUESTS)
    prompts = [rng.integers(3, model.cfg.vocab_size, size=int(n)).tolist() for n in lens]
    runs = []
    for i in range(WINDOW_REPEATS):
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
        log(f"[window] run {i + 1}/{WINDOW_REPEATS}: {n_tok} tokens in {wall:.3f} s = "
            f"{r['tok_s']:.1f} tok/s; mixed {r['mixed_steps']} x {r['mixed_ms']:.2f} ms, "
            f"decode {r['decode_steps']} x {r['decode_ms']:.2f} ms [{card}]")
    stats = {}
    for key in ("tok_s", "mixed_ms", "decode_ms"):
        vals = [r[key] for r in runs]
        stats[key] = {"median": float(np.median(vals)), "min": min(vals), "max": max(vals)}
    with open(os.path.join(OUT_DIR, "window.json"), "w") as f:
        json.dump({"card": card, "requests": WINDOW_REQUESTS, "prompt_tokens": int(lens.sum()),
                   "max_new": WINDOW_NEW, "runs": runs, "stats": stats}, f, indent=1)
    t, d, m = stats["tok_s"], stats["decode_ms"], stats["mixed_ms"]
    log(f"[window] {WINDOW_REQUESTS} requests ({int(lens.sum())} prompt tokens) x "
        f"{WINDOW_NEW} new, {WINDOW_REPEATS} runs: median {t['median']:.1f} tok/s "
        f"(min {t['min']:.1f}, max {t['max']:.1f}); decode megastep median "
        f"{d['median']:.2f} ms ({d['median'] / DECODE_CHUNK:.2f} ms per token step; min "
        f"{d['min']:.2f}, max {d['max']:.2f}); mixed step median {m['median']:.2f} ms "
        f"(min {m['min']:.2f}, max {m['max']:.2f}) [{card}]")


BUCKETS = (("paged_prefill_attention", ("paged_prefill",)),
           ("paged_decode_attention", ("paged_decode",)),
           ("sparse_delta_batched", ("sparse_delta",)),
           ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "splitk")))


def profile_serve(run, card: str) -> None:
    """The same serve run again under ``torch.profiler``: device time by
    kernel (table in chiprun_out/full_profile.txt), by bucket, and the
    device's busy share of the run's wall time."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = self_device_us
    rows = sorted((e for e in device_kernels(prof) if dev(e) > 0), key=dev, reverse=True)
    total = sum(dev(e) for e in rows)
    with open(os.path.join(OUT_DIR, "full_profile.txt"), "w") as f:
        f.write(f"{card}\nwall {wall_us:.0f} us, device {total:.0f} us\n")
        for e in rows:
            f.write(f"{dev(e):12.0f} us {e.count:7d} x  {e.key}\n")
    buckets = {name: 0.0 for name, _ in BUCKETS}
    for e in rows:
        key = e.key.lower()
        name = next((n for n, pats in BUCKETS if any(p in key for p in pats)), "other")
        buckets[name] = buckets.get(name, 0.0) + dev(e)
    shares = ", ".join(f"{k} {v / total:.1%}" for k, v in buckets.items())
    log(f"[profile] device busy {total / wall_us:.1%} of {wall_us / 1e3:.1f} ms wall "
        f"(profiled run); device time: {shares} [{card}]")


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

    summary, detail = phase_kernels(torch.device("cuda"))
    with open(os.path.join(OUT_DIR, "chip_smoke_kernels.json"), "w") as f:
        json.dump({"card": card, "rows": detail}, f, indent=1)
    phase_reduced()
    launches = phase_full(card)

    kernels = []
    for name, s in summary.items():
        kernels.append({
            "name": name, "route": "cuda", "source": s["mod"].SOURCE,
            "replaces": s["mod"].REPLACES, "launches": launches[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"], "kernel_ms": s["ms"],
            "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
            "library_ms": s["library_ms"], "shape": s["shape"],
        })
    log(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
