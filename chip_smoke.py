#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one card
    python3 chip_smoke.py --reduced-train-distances
    python3 chip_smoke.py --decode-row-variants
    python3 chip_smoke.py --linear-variants
    python3 chip_smoke.py --attention-variants
    python3 chip_smoke.py --delta-variants
    python3 chip_smoke.py --lifecycle
    python3 chip_smoke.py --peft
    python3 chip_smoke.py --serve-lifecycle
    python3 chip_smoke.py --sparse-dx
    python3 chip_smoke.py --families
    python3 chip_smoke.py --tp

The second form only prints how far reduced training moves card vs CPU at
a few batch shapes (the readings behind the reduced runs' bounds); the
third only times the decode-row ``fused_linear_q`` with one part of its
source removed at a time (where its time goes); the fourth does the same
for the TMA + wgmma route of ``fused_linear`` and ``fused_linear_q`` at M
= 2048, and times it at every tile height the plan chooses among; the
fifth times the two attention kernels redesigned for Hopper at their path
shapes under the launch choices their planners pick among (the flash
forward's key tile and stages, and rebuilt without its warpgroups' turns
or with a part removed; the decode kernel's blocks an SM, stages, warps
and heads a block); the sixth times the two bypass kernels redesigned for
Hopper at their path shapes under the plans their planners pick among
(the apply's rows a tile, stages, blocks an SM, column spans and route;
the value gradient's rows a tile, stages, blocks an SM and column spans).
``--sparse-dx`` runs the training backward's sparse-dx check and two
resumes, then times the 4 x 512 step with the ordered dx and with the
``index_add_`` it replaced, in turn. ``--families`` runs only phase 11,
``--tp`` only phase 12.

Phases, in order, with no fallback anywhere (any failure exits non-zero):

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compile the hand-written CUDA kernels from the nine sources in
   ``src/repro_torch/kernels/csrc`` (timed; eighteen C entry points for
   the thirteen kernels, one of them the tensor-map encode timer);
3. kernels: each kernel against its plain PyTorch version on the card at
   the full-width qwen2-1.5b shapes (bf16 and fp32) — the three serving
   kernels at the serving shapes (ragged frontiers, shared and sentinel
   pages; the bypass apply at every projection at M = 8 and 2048 with one
   tenant id a slot, delta only and with the serving epilogue, bit for bit
   against the kernel's delta plus PyTorch's adds, each on its planned
   route, and at edge shapes: unaligned rows and x, ragged d_out, k 1-5),
   the int8 bodies of the paged decode and prefill (int8 pools, an
   all-zero page) at the same shapes, the dense decode over an (8,
   Smax, 2, 128) slot cache with bf16 and int8 KV (frontiers 0, 1 and
   Smax, an fp Smax of 1000), ``fused_linear`` and ``sparse_delta_dval`` on edge shapes
   (row, column and K tails, K 77 and a misaligned x on the WMMA kernel,
   the rest on the TMA + wgmma one: every launch on the route the wrapper
   names, two bf16 calls identical bit for bit) and at every projection of a
   training step (M = 4 x 512 rows, and the value gradient also at the
   1 x 4096 rows of a long-context step, and in the values' dtype, equal
   to the float32 result cast; wdown's K = 8960 included; all on the
   wgmma route, also timed at k = 0, on the WMMA kernel and for the host's
   tensor-map encodes), ``fused_linear_q`` (int8
   and NF4) on edge shapes (scale blocks 2-128 crossing K tiles, k 0-3, the
   route checked as for fused_linear; M = 2048 also timed at k = 0 and on
   the tiled WMMA kernel),
   at the decode rows (M 1/3/8/16 on the split-K kernel, K 78-8960, two
   bf16 calls identical bit for bit) and at every projection at M = 2048
   (training, bypass k = 1) and M = 8 (decode rows, no bypass); the paged
   prefill's bf16 output (both bodies) also as a whole, within three bf16
   roundings of the plain version in float32, at the path shapes and at
   edge cases (offsets off the page, stalled and idle slots, GQA groups 1,
   4 and 6, hd 16-128); ``sparse_delta`` and the batched
   ``sparse_delta_dval`` on ragged shapes (B 1, 3 and 64) and at the
   olmoe-1b-7b training shapes (three expert linears over (64, 320, ·)
   buffers, the untied head over 2048 rows; dval's 2-D call equal to its
   B = 1 call bit for bit), and the earlier kernels at olmoe's shapes
   (paged attention with 16/16 heads, ``fused_linear`` 2048², the batched
   apply over 256 stacked (tenant, expert) adapters); the decode kernel
   (paged and dense, fp and int8, route ``ring``) at its edges: GQA groups
   1-16, hd 64-256, frontiers 0, 1, 15, 16, 17 and the table's full width,
   sentinel entries, a dense Smax of 1000, two calls bit for bit;
   ``flash_attention_fwd`` (out and lse; causal and full, bf16 and fp32, hd
   16/64/128, GQA groups 1 and 6, S 130 and 2000; the wgmma route's edges:
   Sq and Skv off the 128-row tiles, Skv != Sq, q/k/v as strided views of
   one fused projection; every case twice, bit for bit, on the route
   ``route`` names) and at the path shapes, qwen2's (1, 4096, 12/2, 128)
   and olmoe's (1, 2048, 16/16, 128) on the wgmma route (timed beside the
   mma route), with the plain backward timed at qwen2's; ``topk_select`` equal to the sort, indices and order
   (ragged d_in and d_out, k 1-64 and k = d_in, tie-heavy bf16), and over
   every stack qwen2 (7) and olmoe (8) select on; and the four kernels of
   a speculative round at its shapes (the bypass apply with the serving
   epilogue at 40 rows, 5 a tenant id, on ``rows-fused``; the paged
   prefill at a verify chunk of 5; ``fused_linear_q`` int8 and NF4 at 40
   rows on ``wgmma``; the dense decode over a drafter's scratch cache) —
   then timed beside its plain version, its bound and a one-call PyTorch
   yardstick where there is one (the port never calls it);
4. reduced serving: reduced qwen2-1.5b in fp32 through the paged
   multi-tenant engine on the card (kernels) and on the CPU (plain
   versions): greedy tokens must be identical; then the same on an int8
   and on an NF4 base (each engine packs its own copy; every base matmul
   through ``fused_linear_q``, 7 a layer-forward); then with int8 KV on the
   paged pool (also on an int8 base) and with bf16 and int8 KV on the dense
   slot cache, each run launching only its own attention bodies; the paged
   and dense int8 runs' tokens must be identical; then speculative
   decoding with every drafter (ngram, int8, nf4, merged) on the paged
   pool and the dense cache: tokens identical to draft="off" on the card
   and to the CPU's under the same drafter, drafted and accepted counts
   the CPU's;
5. full serving: qwen2-1.5b at full published width in bf16, random
   weights from a seed, 3 NeuroAda tenants plus the base, 8 slots,
   ``max_len`` 1024, prompts of 40-700 tokens: every request ends, all
   three serving kernels launched, no plain version called, every decode
   launch on the ring route, every bypass apply on a fused route (the add
   and the QKV bias in its epilogue: rows at the decode steps, tiles at the
   mixed steps, 7 a layer-forward; so in all seven serving gate runs), one
   device-to-host transfer per step (every
   forward and token draw under ``torch.cuda.set_sync_debug_mode("error")``,
   so no hidden one), the
   block pool fully free at the end;
   the same run again under ``torch.profiler`` (device time by kernel),
   and its host operations (ATen operations dispatched and hand-written
   kernel launches) counted twice, identical, pinned exactly (GATE_OPS);
   then speculative
   decoding, spec_k 4: the gate run with the ngram, int8 and merged
   drafters (only their kernels, no plain version, one transfer a step
   with the rounds' device half under the sync guard, the pool drained;
   the verify's applies ``rows-fused`` at 40 rows, the prefill kernel at
   a chunk of 5, a model drafter's decode attention ``ring`` on its
   scratch, the int8 drafter's linears ``skinny``; every bf16 divergence
   from draft="off" at a near-tie of the teacher-forced logits), the
   ngram run profiled, and the window with off, ngram, int8 and merged
   in turn (tok/s, acceptance, forwards a token);
   then a longer, decode-dominated window (16 requests x 64 new tokens)
   served once (the speculative window's draft="off" run is a second
   reading in the same call); then the
   same tenants, prompts and settings on an int8 and on an NF4 base
   (``ServeEngine(base_dtype=...)``): the gate run (every base matmul
   through ``fused_linear_q``, 7 a layer-forward, decode steps on the
   split-K kernel, mixed steps on the TMA + wgmma one), its profile and one
   window run;
   between them, the same tenants, prompts and settings on the paged pool
   with int8 KV and on the dense slot cache with bf16 and int8 KV: the
   gate run (its attention kernels launched and no other, pool bytes as
   reckoned: 234,881,024 bf16, 117,669,888 int8), the same run profiled
   (busy share, launches per layer-forward) and one window run;
   then the serving production lifecycle (slice 14; also alone with
   ``--serve-lifecycle``) on the same gate run: its host operations counted
   again with metrics off and with a tracer (GATE_OPS each time, op by op,
   the same tokens), the registry and the trace reconciled with the run,
   the gate run timed with metrics off / on / on with a tracer in turn,
   exact TTFT and ITL from the trace of one 16 x 64 window, a hot tenant's
   12 requests before a cold tenant's 4 under fifo and drr, a seeded
   ``ChaosMonkey`` run (every request terminal, survivors' tokens the gate
   run's or parted at a near-tie, the pool drained with nothing stolen,
   only the path's kernels),
   deadlines on the real clock (shed at intake; expired mid-decode), the
   SSE front end over loopback (the 10 gate prompts streamed concurrently,
   one cancelled mid-stream, the others held to the gate run by the same
   tie rule, the engine thread's forwards under the sync guard) and ``launch/serve.py`` with ``--metrics-out``, ``--trace-out``
   and ``--profile-dir`` (``chiprun_out/serve_lifecycle.json``);
6. reduced training: reduced qwen2-1.5b in fp32, the same params and three
   batches trained on the card (kernels) and on the CPU (plain versions),
   on the fp32, an int8 and an NF4 base, and on the fp32 base with every
   layer's attention on the flash path (threshold 32, block 16, seq 64):
   selected indices identical, losses within 1e-5, final values within
   1e-5 relative;
7. full training: qwen2-1.5b at full width and depth in bf16, NeuroAda
   k = 1 (magnitude), task ``lm``, batch 4 x seq 512: 2 warm-up steps, 5
   measured (losses, step time, tokens/s, peak memory, launches per step:
   196 of each training kernel, no plain call, every fused_linear(_q) launch
   on the TMA + wgmma route, every value gradient one launch on the
   ``single`` route, so in every training run), one profiled step (device
   busy share); then the trained adapter is exported and served as a
   tenant beside the base. The same on an int8 and on an NF4 base
   (``fused_linear_q`` in place of ``fused_linear``, the packed base
   unchanged by every step, peak memory below the bf16 base's). Each
   run's selection is timed, with its ``topk_select`` launches (7, one a
   stack; 196 on a packed base, one a layer) and peak memory. Then
   long-context training: full-width qwen2-1.5b, bf16, k = 1, task ``lm``,
   batch 1 x seq 4096, 2 + 5 steps as above with 28 ``flash_attention_fwd``
   launches a step (every one on the wgmma route) beside the 196 of each
   training kernel, one profiled
   step (the flash forward's device time beside the plain backward's);
8. MoE: reduced olmoe-1b-7b in fp32 trained three steps on the card and
   on the CPU (losses within 1e-5, values within 1e-4 relative; again on
   the flash path, values within 1e-5) and served
   with 2 tenants (greedy tokens identical); then full-width olmoe-1b-7b
   in bf16, random weights from a seed: selection at k = 1 over the
   expert stacks and the untied head, 2 warm-up + 5 measured steps at
   batch 4 x seq 512 (64 ``fused_linear``, 49 ``sparse_delta`` and 113
   ``sparse_delta_dval`` launches a step, no plain call, finite losses),
   one profiled step; its adapter served beside 2 random tenants and the
   base with phase 5's settings (every request ends, one transfer a step
   and no hidden one, as in phase 5, the pool drains, pool bytes
   1,073,741,824 as reckoned), profiled, one window run, and one gate run
   on each int8 KV cache (paged and dense: only the int8 bodies, pool bytes
   537,919,488 as reckoned);
9. the training lifecycle and the MoE completions (slice 12; also alone
   with ``--lifecycle``): reduced olmoe trained and served card vs CPU on
   an int8 and an NF4 base and served on int8 KV (paged and dense, each
   equal to the CPU's); full-width olmoe on each packed base (selection one expert
   matrix at a time, 3137 ``topk_select`` launches, its peak below one
   layer's dense expert stack; 2 + 3 steps with 65 ``fused_linear_q``, 49
   ``sparse_delta`` and 113 ``sparse_delta_dval`` launches a step, the base
   unchanged, the peak below the bf16 base's; the gate run with the trained
   tenant and 2 random ones, 4 ``fused_linear_q`` a layer-forward and the
   head's; on int8 the gate run again with the int8 self-drafter, which
   shares the base, greedy tokens equal to draft="off"'s but at near-ties);
   remat: reduced qwen2 and olmoe in fp32 on the card under none / full /
   dots with deterministic algorithms (losses and values bit-equal), then
   full-width qwen2 bf16 at 4 x 512 (2 + 3 steps a mode; the first loss
   bit-equal across modes; ``fused_linear`` 392 / 196 launches a step under
   full / dots, ``sparse_delta_dval`` 196 in every mode; full's peak below
   none's, dots' at most none's) and at 1 x 4096 under full (56 flash
   launches a step, the peak below the same call's none run); checkpoint
   and resume through ``Trainer`` and ``CheckpointManager`` (a save at step
   2 timed as host copy and file write; a fresh Trainer resumes: values and
   moments bit-equal, its step-3 and step-4 losses bit-equal);
   ``launch/train.py --export`` of full-width qwen2 served by
   ``launch/serve.py --params`` (its ``main``, on the card) for the gate
   run against the unmerged tenant on the same base (partings only at
   near-ties), and on reduced fp32 with identical tokens;
10. the PEFT baselines and selection strategies (slice 13; also alone with
    ``--peft``): every method and strategy on reduced models card vs CPU,
    the full-width method table and memory gate against NeuroAda, the
    strategies' selections at full width, LoRA's merged export served;
11. the VLM, SSM and hybrid families (slice 15; also alone with
    ``--families``): the kernels at the shapes these paths first run them
    at, each against its plain version (``fused_linear`` on both routes
    and ``sparse_delta_dval`` at falcon-mamba's and zamba2's projections,
    ``topk_select`` over their stacks, the dense decode at hd 80 group 1,
    the flash forward's mma route at hd 80); the reduced twins card vs
    CPU (three training steps; greedy tokens from prefill + decode with an
    adapter); then qwen2-vl-2b, falcon-mamba-7b and zamba2-2.7b at full
    published width and depth in bf16: selection (k = 1), 2 + 5 NeuroAda
    steps (FAMILY_TRAIN: the VLM's batches a quarter patches with M-RoPE
    positions; only ``fused_linear``, ``sparse_delta_dval`` and, on
    zamba2's 1 x 2048, ``flash_attention_fwd``, as many as reckoned), one
    profiled step, greedy generation with the trained adapter through
    prefill + decode_step (4 x 512 prompt, 64 new tokens; the dense decode
    at every attention site), and on qwen2-vl-2b qwen2's multi-tenant
    paged gate run (``train_<arch>.json``). Slice 16 adds
    seamless-m4t-large-v2, the encoder-decoder, to all of it: its kernels
    (``fused_linear`` and ``sparse_delta_dval`` at M = 4096 / 1024,
    ``topk_select`` over its 18 stacks and head, the dense decode at hd 64
    group 1, the flash forward not causal against 2048 frames), its reduced
    twin with the flash threshold lowered (the non-causal flash kernel
    card vs CPU), 2 x 512 target tokens over 2 x 2048 frames (the encoder's
    and the cross-attention's flash forwards, 48 a step) and generation
    over 2048 frames from a 16-token prompt; ``fused_linear_q`` at the
    packed families' new shapes; qwen2-vl's gate run on an int8 pool and
    its reduced int8 KV engines card vs CPU; then all four families on an
    int8 and an NF4 base: the reduced twins card vs CPU, and at full width
    selection one matrix at a time, 2 + 3 steps (only ``fused_linear_q``,
    ``sparse_delta_dval`` and the flash forward where reckoned; the packed
    bytes unchanged), 16 greedy tokens (``train_<arch>_<base>.json``);
12. tensor-parallel serving (slices 17-18; also alone with ``--tp``): the
    four TP wrappers on one rank's slices at the per-shard shapes of tp 2
    (the paged decode and prefill and the dense decode at qwen2-1.5b's 6 q
    heads over 1 kv-head and at olmoe-1b-7b's 8 over 8, hd 128, fp and int8
    bodies; ``matmul_q_cols_sharded`` on one rank's 75,968 columns of
    qwen3-32b's packed head and 25,152 of olmoe's, int8 and NF4) and the
    bypass apply on one olmoe rank's (N·32, k, 1024) expert stacks with
    combined ids, each against the plain version of the kernel it launches
    and timed beside its bound and a PyTorch call on the same local slice;
    then the path at tp 1 on the card and at tp 2 over 2 spawned ranks
    sharing the card (a gloo device group): full-width qwen2-1.5b on the
    bf16 and on an int8 base, olmoe-1b-7b (32 of its 64 experts a rank) on
    the bf16 and on an int8 base, and qwen2-vl-2b on bf16, each on the paged
    engine with 2 tenants (4 requests x 32 new tokens: the first decode
    step's logits within 2u sqrt(2 L) of tp 1's over the slots whose
    sequences, and on olmoe every token's top-8 experts, still agree, the
    flipped routes counted; the first mixed step and the first decode step
    taught to tp 1 arithmetic on the tp 2 run's own state, olmoe's expert
    choices forced, within the same bound on every slot the step computed
    for; how far the greedy tokens agree, pool bytes a rank = total / 2,
    each rank's base bytes, the apply's combined ids inside a rank's
    stacks, the step wall of two ranks on one card), and the reduced
    float32 twins of the CPU tests (qwen2 paged with tenants and dense, the
    untied head on an int8 base, olmoe paged with tenants and on an int8
    base, qwen2-vl paged with tenants: tokens at tp 2 = tp 1 on the card =
    the CPU's). Each run's counts are set to 0 just before it and read
    just after (warm-ups and the taught steps are not counted): every run
    launched its kernels on every rank (the full-width runs the paged
    wrappers and the apply), and no plain version ran
    (``chiprun_out/tp.json``).

The second-to-last line of output is the kernels JSON line, the last line
``{"ok": true, "device": {...}}``; the kernels line has a row for each of
the thirteen kernels and the four TP wrappers (``topk_select``'s with its smallest-first and
float32-score figures; each TP wrapper's with an ``olmoe`` entry at olmoe's
per-shard shapes and the launches of olmoe's and qwen2-vl's runs, and
``sparse_delta_batched``'s with a ``tp`` entry: one olmoe rank's expert
stacks at tp 2; ``--tp`` alone prints that entry as a fifth row); the rows
of the four kernels a speculative round
reaches carry a ``spec`` entry (its shape's times and bound, the spec gate
runs' launches by drafter); the rows of kernels olmoe also runs carry an
``olmoe`` entry (ms, plain ms and bound at olmoe's shapes, launches in its training
steps or serving gate run). Detailed per-shape kernel results go to
``chiprun_out/chip_smoke_kernels.json``, the windows' runs to
``chiprun_out/window*.json`` (the speculative one to ``window_spec.json``),
every line printed to
``chiprun_out/chip_smoke.log``. Exits non-zero without CUDA, and
outside a checkout of the repository (the package is not importable).
The training phases write ``train*.json`` and ``train*_profile.txt`` to
the same directory (``train_remat.json``, ``train_resume.json`` for phase
9, ``train_methods.json`` and ``selection_strategies.json`` for phase 10),
the MoE serving ``full_profile_olmoe.txt`` and ``window_olmoe.json``.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.autograd.profiler_util import _filter_name, _rewrite_name
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.checkpoint import save_pytree  # noqa: E402
from repro_torch.configs import PeftConfig, TrainConfig, get_config, reduced  # noqa: E402
from repro_torch.core import adapt as adapt_mod  # noqa: E402
from repro_torch.core.adapt import init_adapters, zip_adapters  # noqa: E402
from repro_torch.core.delta import BatchedDelta  # noqa: E402
from repro_torch.data import TASKS, DataLoader  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    ATTENTION,
    COUNTERS,
    LONG_CONTEXT,
    PACKED_BASE,
    SELECTION,
    SERVING,
    SINGLE_TENANT,
    TENSOR_PARALLEL,
    TRAINING,
    build,
    ops,
    ref,
    reset_counters,
)
from repro_torch.kernels import decode_attention as dec_mod  # noqa: E402
from repro_torch.kernels import dense_decode_attention as dd_mod  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import fused_linear as fl_mod  # noqa: E402
from repro_torch.kernels import prefill_attention as pre_mod  # noqa: E402
from repro_torch.kernels import quant_linear as ql_mod  # noqa: E402
from repro_torch.kernels import sparse_delta as sd_mod  # noqa: E402
from repro_torch.kernels import topk_select as ts_mod  # noqa: E402
from repro_torch.kernels.ref import gather_paged_kv  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.attention import flash_attention_bwd  # noqa: E402
from repro_torch.models.layers import adapter_leaf, quant_kv_page  # noqa: E402
from repro_torch.obs import Tracer, percentile  # noqa: E402
from repro_torch.peft import (  # noqa: E402
    export_adapter,
    get_peft,
    load_adapter,
    quantize_base,
    stats,
)
from repro_torch.quant import QuantizedTensor, dequantize, quantize, tree_bytes  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdapterStore,
    ChaosMonkey,
    QueueFullError,
    ServeEngine,
    ServeFrontend,
)
from repro_torch.serve.sampler import Sampler  # noqa: E402
from repro_torch.train import Trainer, TrainState, make_train_step  # noqa: E402
from repro_torch.tree import flatten, map_leaves, unflatten  # noqa: E402

OUT_DIR = os.path.join(ROOT, "chiprun_out")
# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and dense bf16
# tensor-core rate; fp32 work outside the tensor cores runs at 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# flash_attention_fwd beyond TOL: its logsumexp is float32 arithmetic on
# both sides (≈ 9 a row at S 4096), held to 1e-4 absolute in both dtypes;
# bf16 out is also held as a whole against the plain version in float32 on
# the same inputs, ||out - exact|| / ||exact||, to at most
# FLASH_BF16_ROUNDINGS times the control ||bf16(exact) - exact|| / ||exact||
# (one rounding of the exact output). The kernel rounds twice, p before the
# p·v product and out, each about the control. The bf16 paged prefill
# (both bodies) is held the same way (check_prefill).
FLASH_LSE_ATOL, FLASH_BF16_ROUNDINGS = 1e-4, 3.0

# full-width serving shape of qwen2-1.5b (configs/qwen2_1p5b.py)
SLOTS, MAX_LEN, PAGE, PREFILL_CHUNK, DECODE_CHUNK = 8, 1024, 16, 256, 8
N_TENANTS, K_DELTA = 3, 2
# full-width training step: batch x seq rows through every projection
TRAIN_BATCH, TRAIN_SEQ, TRAIN_K, TRAIN_LR = 4, 512, 1, 3e-3
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
# the packed bases, with the launchers' default scale block
PACKED, QUANT_BLOCK = ("int8", "nf4"), 64
# long-context training: full-width qwen2-1.5b at batch 1 x seq 4096 (inside
# its published context), every layer's attention at or above the flash
# threshold (2048). Reduced models reach the flash path at batch 4 x seq 64
# with the threshold and the backward's block lowered to 32 and 16. (At
# batch 2 x seq 128 reduced olmoe's values differ card vs CPU by 1.7e-4
# relative with dense attention and no flash kernel at all — a few expert
# wgate values whose first gradients nearly vanish — so that batch cannot
# hold the MoE bound of 1e-4 for any kernel.)
LONG_BATCH, LONG_SEQ = 1, 4096
REDUCED_FLASH, REDUCED_FLASH_SHAPE = dict(flash_threshold=32, flash_block=16), (4, 64)


# the qwen2 paged bf16 gate run's host operations, counted exactly: every
# ATen operation it dispatches (OpCount) plus every launch of a hand-written
# kernel (COUNTERS; ctypes calls the dispatcher never sees), set-up of its
# store and engine included. The run is greedy on fixed prompts, so the
# count is the same every run (203,006 on an H100 80GB HBM3, 105.08 a
# layer-forward), and it is pinned. It replaces a gate on the kernels
# torch.profiler records: profiles of one run of one tree differed by
# records the profiler lost (at a session's start, and blocks of them in
# its middle), never by a launch. Every profiler session still opens with
# PROFILE_MARKERS uncounted marker kernels, which take the start's losses
GATE_OPS, PROFILE_MARKERS, MARKER_KERNEL = 203006, 8, "spin_kernel"

# speculative decoding: the drafters of the reduced phase and the window,
# those of the full-width gate runs, the drafted tokens a round, and the
# verify chunk's rows (slots x (spec_k + 1), spec_k + 1 rows a tenant id)
SPEC_DRAFTERS, SPEC_GATE, SPEC_K = ("ngram", "int8", "nf4", "merged"), ("ngram", "int8", "merged"), 4
SPEC_ROWS = SLOTS * (SPEC_K + 1)
# a greedy divergence between a spec run and draft="off" in bf16 must sit at
# a near-tie of the teacher-forced logits: the top two (the two tokens the
# runs chose among) at most SPEC_TIE_ULPS bf16 ulps of the top logit apart
SPEC_TIE_ULPS = 4

LOG = []  # every line log() printed, written to chiprun_out/chip_smoke.log at the end
START = time.perf_counter()


def log(msg: str) -> None:
    """Print ``msg``; the log file keeps it behind the seconds since start."""
    print(msg, flush=True)
    LOG.append(f"{time.perf_counter() - START:7.1f} {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def self_device_us(event) -> float:
    if hasattr(event, "self_device_time_total"):
        return event.self_device_time_total
    return event.self_cuda_time_total


# device_kernels reads the session's raw events; the first session of each
# kind (a kernel's timing, a profiled serving or training run) is also read
# through key_averages(), and the two must agree
_RAW_EVENTS_CHECKED = set()


def device_kernels(prof, kind: str) -> list:
    """The session's device operations summed by name: ``key``, ``count``
    and ``self_device_time_total`` (µs), as ``key_averages()`` gives them
    for the device's events. Read from the raw kineto events with the
    profiler's own filter and names (``_filter_name``, hidden events,
    ``_rewrite_name``): ``key_averages()`` first turns every event into a
    Python object and links it to its launch, tens of seconds for a
    serving run's 10^5 kernels, where this takes a fraction of a second.
    The first session of each ``kind`` is checked against
    ``key_averages()``."""
    totals = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA or _filter_name(e.name())
                or getattr(e, "is_hidden_event", bool)()):
            continue
        t = totals.setdefault(_rewrite_name(e.name(), with_wildcard=True), [0, 0])
        t[0] += 1
        t[1] += e.end_ns() - e.start_ns()
    rows = [types.SimpleNamespace(key=k, count=n, self_device_time_total=ns / 1e3)
            for k, (n, ns) in totals.items()]
    if kind not in _RAW_EVENTS_CHECKED:
        want = {e.key: (e.count, self_device_us(e)) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA}
        got = {r.key: (r.count, r.self_device_time_total) for r in rows}
        assert set(got) == set(want) and all(
            got[k][0] == want[k][0] and abs(got[k][1] - want[k][1]) <= 1e-3 * want[k][1] + 0.01
            for k in want), ("raw device events disagree with key_averages()", kind, got, want)
        _RAW_EVENTS_CHECKED.add(kind)
        log(f"[profile] raw device events = key_averages() on the first {kind} session "
            f"({len(rows)} names, {sum(r.count for r in rows)} events)")
    return rows


def cuda_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: the summed durations of the
    kernels it launches (CUPTI, through ``torch.profiler``), averaged over
    ``iters`` calls. Host time between launches is not counted, so a
    small kernel's time is its own and not the Python wrapper's. The
    profiler loses records now and then (a whole session's, once in ~60;
    a session's first ones; blocks in its middle: PERF.md §6), which
    would read low: the session opens with uncounted marker kernels, and
    one in which some kernel was not recorded ``iters`` times over (every
    call launches the same kernels) is taken again. After three such
    sessions the calls are timed with CUDA events instead (back to back,
    so the host's gaps between launches count too; logged)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_MARKERS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in device_kernels(prof, "kernel") if MARKER_KERNEL not in e.key]
        total = sum(self_device_us(e) for e in kernels)
        if total > 0 and all(e.count % iters == 0 for e in kernels):
            return total / iters / 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    log(f"[timing] torch.profiler kept no whole record of {iters} calls in 3 sessions "
        f"(kernels {[(e.key[:40], e.count) for e in kernels]}): timed with CUDA events")
    return start.elapsed_time(end) / iters


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
               arch="qwen2-1.5b", heads=None):
    """q (B, c, H, hd) of ``arch`` (12 and 128 for qwen2-1.5b; or ``heads``
    = (H, Hkv, hd)) against a pool of ``num_blocks`` pages through a table
    with ragged frontiers ``q_off + q_len``; slots 0 and 1 share their
    leading pages, pages past each frontier hold the sentinel
    ``num_blocks``."""
    cfg = get_config(arch)
    h, hkv, hd = heads or (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim)
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


def prefill_mask(qoff, vl, table, dev, c: int = PREFILL_CHUNK):
    """(B, 1, C, S) columns each chunk row sees: causal, below its slot's
    frontier."""
    col = torch.arange(table.shape[1] * PAGE, device=dev)[None, None, :]
    qpos = qoff[:, None, None] + torch.arange(c, device=dev)[None, :, None]
    return ((col <= qpos) & (col < vl[:, None, None]))[:, None]


def decode_cost(q, kp, table, vl) -> tuple[float, float]:
    return (attention_bytes(q, kp, table, vl, int((vl > 0).sum()), 1),
            4.0 * float(vl.sum()) * q.shape[2] * q.shape[3])


def prefill_cost(q, kp, table, qoff, vl, mask) -> tuple[float, float]:
    return (attention_bytes(q, kp, table, vl, int(mask[:, 0].any(-1).sum()), 2),
            4.0 * float(mask[:, 0].sum()) * q.shape[2] * q.shape[3])


def rel_to_exact(out, exact) -> dict:
    """bf16 ``out`` against the float32 ``exact`` as a whole: its relative
    error ||out - exact|| / ||exact||, and the control ||bf16(exact) -
    exact|| / ||exact||, one rounding of the exact result."""
    norm = float(exact.norm())
    return {"rel_err": float((out.float() - exact).norm()) / norm,
            "rounding": float((exact.to(out.dtype).float() - exact).norm()) / norm}


def check_prefill(name: str, q, kp, vp, table, qoff, vl, ks=None, vs=None) -> dict:
    """``paged_prefill_attention`` (the int8 body with ``ks``/``vs``) against
    its plain version on the same inputs, every row compared (pad rows of
    short chunks and stalled slots included): elementwise to TOL, and bf16
    also as a whole, at most FLASH_BF16_ROUNDINGS roundings from the plain
    version in float32 (the kernel rounds p to bf16 for p·v and the output,
    each about one rounding; an elementwise 2e-2 would pass a wrong row
    sum). Idle slots give zeros. Returns the readings."""
    extra = (table, qoff, vl) + ((ks, vs) if ks is not None else ())
    got = pre_mod.paged_prefill_attention(q, kp, vp, *extra)
    want = pre_mod.paged_prefill_attention_plain(q, kp, vp, *extra)
    torch.cuda.synchronize()
    row = {"max_abs_err": max_err(got, want)}
    if q.dtype == torch.bfloat16:
        pools = (kp, vp) if ks is not None else (kp.float(), vp.float())  # int8 codes stay
        exact = pre_mod.paged_prefill_attention_plain(q.float(), *pools, *extra)
        row.update(rel_to_exact(got, exact))
        bound_rel = FLASH_BF16_ROUNDINGS * row["rounding"]
        assert row["rel_err"] <= bound_rel, f"{name}: rel_err {row['rel_err']:.3e} > {bound_rel:.3e}"
    check_close(name, got, want, q.dtype)
    for s in (vl == 0).nonzero().flatten().tolist():
        assert float(got[s].float().abs().max()) == 0.0, f"{name}: idle slot {s} must give zeros"
    return row


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

    # -- sparse_delta_batched: every projection at a mixed step's rows (M =
    #    slots x chunk) and a decode step's (M = slots), with one tenant id a
    #    slot (read with a rows-per-id stride, as the engine passes them),
    #    every (x, values) pair of float32 and bf16 the wrapper accepts
    #    (adapter files keep their own dtype); the delta alone and with the
    #    serving epilogue (y + delta, then the QKV bias, in place), the fused
    #    form bit for bit against the kernel's delta plus PyTorch's adds; each
    #    launch on the route delta_plan names; the bf16 calls timed in both
    #    forms, each beside its bound
    m_mixed = SLOTS * PREFILL_CHUNK
    err_bf16 = 0.0
    layer = {(m, form): {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "flops": 0.0, "launch_ms": []}
             for m in (m_mixed, SLOTS) for form in ("delta", "fused")}
    counter = COUNTERS["sparse_delta_batched"]
    sms = dec_mod.sm_count(dev)
    for name, d_in, d_out in projections:
        for m in (m_mixed, SLOTS):
            for x_dt, v_dt in ((torch.bfloat16, torch.bfloat16),
                               (torch.bfloat16, torch.float32),
                               (torch.float32, torch.bfloat16),
                               (torch.float32, torch.float32)):
                x, idx, val, aid = delta_case(gen, m, d_in, d_out, x_dt, v_dt, dev)
                rpi = m // SLOTS
                seq = aid[::rpi].contiguous()  # one id a slot
                y0 = torch.randn(m, d_out, generator=gen, device=dev).to(x_dt)
                bias = (torch.randn(d_out, generator=gen, device=dev).to(x_dt)
                        if name in ("wq", "wk", "wv") else None)
                route = sd_mod.delta_plan(m, d_in, d_out, x.element_size(), sms).route
                counter.reset()
                got = sd_mod.sparse_delta_batched(x, idx, val, seq, rpi)
                want = sd_mod.sparse_delta_batched_plain(x, idx, val, aid)
                fused = sd_mod.sparse_delta_batched(x, idx, val, seq, rpi, y0.clone(), bias)
                torch.cuda.synchronize()
                what = f"sparse_delta {name} M={m} {x_dt}/{v_dt}"
                err = check_close(what, got, want, x_dt)
                three = y0 + got
                if bias is not None:
                    three = three + bias
                assert torch.equal(fused, three), f"{what}: the epilogue differs from the adds"
                assert torch.equal(got, sd_mod.sparse_delta_batched(x, idx, val, seq, rpi)), \
                    f"{what}: two launches differ"
                assert counter.routes == {route: 2, route + "-fused": 1}, (what, counter.routes)
                row = {"kernel": "sparse_delta_batched", "proj": name, "M": m, "d_in": d_in,
                       "d_out": d_out, "x": str(x_dt), "val": str(v_dt), "route": route,
                       "bias": bias is not None, "max_abs_err": err}
                if x_dt == torch.bfloat16 and v_dt == torch.bfloat16:
                    err_bf16 = max(err_bf16, err)
                    yb = y0.clone()
                    row["ms"] = cuda_ms(lambda: sd_mod.sparse_delta_batched(x, idx, val, seq, rpi))
                    row["fused_ms"] = cuda_ms(
                        lambda: sd_mod.sparse_delta_batched(x, idx, val, seq, rpi, yb, bias))
                    row["plain_ms"] = cuda_ms(
                        lambda: sd_mod.sparse_delta_batched_plain(x, idx, val, aid), iters=3)
                    nbytes, flops = delta_cost(x, idx, val, aid, d_out)
                    # the epilogue also reads y (and the bias) once
                    fbytes = nbytes + m * d_out * x.element_size() + (
                        0 if bias is None else d_out * x.element_size())
                    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, x_dt)
                    row["fused_bound_ms"], row["fused_bound_by"] = bound(fbytes, flops, x_dt)
                    for form, ms, nb in (("delta", row["ms"], nbytes),
                                         ("fused", row["fused_ms"], fbytes)):
                        acc = layer[(m, form)]
                        acc["ms"] += ms
                        acc["plain_ms"] += row["plain_ms"]
                        acc["bytes"] += nb
                        acc["flops"] += flops
                        acc["launch_ms"].append(ms)
                detail.append(row)
    detail.extend(apply_edge_cases(gen, dev))
    res = {}
    for (m, form), acc in layer.items():
        b_ms, b_by = bound(acc["bytes"], acc["flops"], torch.bfloat16)
        res[(m, form)] = dict(ms=acc["ms"], plain_ms=acc["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                              launch_ms=(min(acc["launch_ms"]), max(acc["launch_ms"])))
    mix, dec = res[(m_mixed, "delta")], res[(SLOTS, "delta")]
    summary["sparse_delta_batched"] = {
        "source": sd_mod.SOURCE, "replaces": sd_mod.REPLACES, "max_abs_err": err_bf16,
        "ms": mix["ms"], "plain_ms": mix["plain_ms"], "bound_ms": mix["bound_ms"],
        "bound_by": mix["bound_by"],
        "library_ms": None,
        "shape": f"7 projections of one layer, M={m_mixed} bf16 rows, k={K_DELTA}, "
                 f"N={N_TENANTS + 1}, delta only",
        "fused": res[(m_mixed, "fused")], "decode": dec, "decode_fused": res[(SLOTS, "fused")],
    }
    for (m, form), r in res.items():
        log(f"[kernels] sparse_delta_batched one layer at M={m} ({form}): {r['ms']:.4f} ms "
            f"(a launch {r['launch_ms'][0] * 1e3:.2f}-{r['launch_ms'][1] * 1e3:.2f} us; plain "
            f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} by {r['bound_by']}) [{card}]")
    log(f"[kernels] sparse_delta_batched ok: max|err| bf16 {err_bf16:.3e}; the epilogue bit for "
        f"bit against the delta plus PyTorch's adds, two launches bit for bit, every launch on "
        f"the planned route (rows at M={SLOTS}, tiles at M={m_mixed}) [{card}]")

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
        readings = check_prefill("paged_prefill_attention", q, kp, vp, table, qoff, vl)
        err = readings["max_abs_err"]
        row = {"kernel": "paged_prefill_attention", "dtype": str(dt), "q_offset": pre_off,
               "q_len": pre_len, **readings}
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
    detail.extend(prefill_cases(gen, dev, num_blocks))
    kv_kernels(gen, dev, summary, detail, card, num_blocks, dec_vl, pre_off, pre_len)
    detail.extend(decode_cases(gen, dev, num_blocks))
    train_kernels(gen, projections, dev, summary, detail, card)
    detail.extend(dval_long(gen, projections, dev, summary, card))
    packed_kernels(gen, projections, dev, summary, detail, card)
    moe_kernels(gen, dev, summary, detail, card, num_blocks, dec_vl, pre_off, pre_len)
    lifecycle_kernels(gen, dev, summary, detail, card, num_blocks, dec_vl)
    long_context_kernels(gen, dev, summary, detail, card)
    selection_kernels(gen, dev, summary, detail, card)
    selection_modes(gen, dev, summary, detail, card)
    spec_kernels(gen, projections, dev, summary, detail, card, num_blocks)
    return summary, detail


# the bypass apply's edge cases: (M, d_in, d_out, k, x offset in elements,
# rows a tenant id covers). d_in 77 makes bf16 rows of 154 bytes (the
# staged run's ends move by plain loads), an offset of 1 misaligns x itself,
# d_out 5 / 36 / 129 / 260 leave a ragged last column group (element by
# element), M 65 and 2047 take the tiles route off its tile height
APPLY_EDGE = ((8, 77, 36, 1, 0, 1), (8, 300, 129, 3, 1, 2), (65, 1000, 5, 1, 1, 5),
              (300, 77, 36, 3, 1, 1), (130, 1000, 264, 2, 0, 10), (2047, 300, 260, 2, 1, 23),
              (2048, 77, 1536, 5, 0, 256))


def apply_edge_cases(gen, dev) -> list:
    """The apply at APPLY_EDGE, every (x, values) dtype pair: against the
    plain version, the epilogue bit for bit against the adds, two launches
    bit for bit, on the route delta_plan names."""
    rows, counter = [], COUNTERS["sparse_delta_batched"]
    sms = dec_mod.sm_count(dev)
    for m, d_in, d_out, kk, off, rpi in APPLY_EDGE:
        for x_dt in (torch.bfloat16, torch.float32):
            for v_dt in (torch.bfloat16, torch.float32):
                x = torch.randn(m * d_in + off, generator=gen, device=dev).to(x_dt)[off:].view(
                    m, d_in)
                idx = torch.randint(0, d_in, (N_TENANTS + 1, kk, d_out), generator=gen,
                                    device=dev, dtype=torch.int32)
                val = (torch.randn(N_TENANTS + 1, kk, d_out, generator=gen, device=dev)
                       * 0.05).to(v_dt)
                seq = torch.randint(0, N_TENANTS + 1, (m // rpi,), generator=gen, device=dev,
                                    dtype=torch.int32)
                y0 = torch.randn(m, d_out, generator=gen, device=dev).to(x_dt)
                bias = torch.randn(d_out, generator=gen, device=dev).to(x_dt)
                route = sd_mod.delta_plan(m, d_in, d_out, x.element_size(), sms).route
                counter.reset()
                got = sd_mod.sparse_delta_batched(x, idx, val, seq, rpi)
                want = sd_mod.sparse_delta_batched_plain(x, idx, val, seq, rpi)
                fused = sd_mod.sparse_delta_batched(x, idx, val, seq, rpi, y0.clone(), bias)
                torch.cuda.synchronize()
                what = (f"sparse_delta edge M={m} d_in={d_in} d_out={d_out} k={kk} offset {off} "
                        f"{x_dt}/{v_dt}")
                err = check_close(what, got, want, x_dt)
                assert torch.equal(fused, (y0 + got) + bias), f"{what}: epilogue differs"
                assert torch.equal(got, sd_mod.sparse_delta_batched(x, idx, val, seq, rpi)), what
                assert counter.routes == {route: 2, route + "-fused": 1}, (what, counter.routes)
                rows.append({"kernel": "sparse_delta_batched", "case": "edge", "M": m,
                             "d_in": d_in, "d_out": d_out, "k": kk, "x_offset": off,
                             "rows_per_id": rpi, "x": str(x_dt), "val": str(v_dt),
                             "route": route, "max_abs_err": err})
    log(f"[kernels] sparse_delta_batched ok on edge shapes ({len(rows)} cases: M 8-2048 on both "
        f"routes, d_in 77/300/1000 (unaligned rows), d_out 5-1536, k 1-5, x 4/2 bytes off, "
        f"rows an id 1-256; bf16 2e-2, fp32 2e-5; epilogue and repeats bit for bit)")
    return rows


# the paged prefill's edge cases beside the path shape: chunk offsets off the
# page (the diagonal tile crosses pages), frontiers mid-page, a stalled
# slot (q_len 0, frontier > 0), idle slots, a chunk ending at the cache's
# last row; GQA groups 6 (qwen2-1.5b), 1 (olmoe-1b-7b) and 4 at hd 64 and 16
PREFILL_EDGE = ([5, 33, 1000, 0, 300, 16, 0, 767], [200, 17, 23, 0, 0, 256, 0, 1])
PREFILL_HEADS = ((12, 2, 128), (16, 16, 128), (8, 2, 64), (4, 1, 16))


def prefill_cases(gen, dev, num_blocks) -> list:
    """``check_prefill`` on the edge cases at every head layout of
    PREFILL_HEADS, bf16 and fp32, fp and int8 pools (one int8 page all
    zero: scale 0)."""
    q_off, q_len = PREFILL_EDGE
    rows = []
    for heads in PREFILL_HEADS:
        hkv, hd = heads[1], heads[2]
        for dt in (torch.bfloat16, torch.float32):
            q, kp, vp, table, qoff, vl = paged_case(gen, q_off, q_len, PREFILL_CHUNK, dt, dev,
                                                    num_blocks, heads=heads)
            name = f"paged_prefill_attention {heads} {dt}"
            readings = check_prefill(name, q, kp, vp, table, qoff, vl)
            rows.append({"kernel": "paged_prefill_attention", "case": "edge", "heads": heads,
                         "dtype": str(dt), **readings})
            kc, ks = quantized(gen, (num_blocks, PAGE, hkv, hd), dev, zero_group=int(table[0, 2]))
            vc, vs = quantized(gen, (num_blocks, PAGE, hkv, hd), dev, zero_group=int(table[0, 2]))
            readings = check_prefill(name.replace("attention", "attention_q"), q, kc, vc,
                                        table, qoff, vl, ks, vs)
            rows.append({"kernel": "paged_prefill_attention_q", "case": "edge", "heads": heads,
                         "dtype": str(dt), **readings})
    bf16 = [r for r in rows if "rel_err" in r]
    log(f"[kernels] paged_prefill_attention (fp and int8 pools) ok at {len(rows)} edge cases "
        f"(q_offset {q_off}, q_len {q_len}; heads/kv heads/hd {list(PREFILL_HEADS)}; bf16 and "
        f"fp32): bf16 relative error at most "
        f"{max(r['rel_err'] / r['rounding'] for r in bf16):.2f} roundings (bound "
        f"{FLASH_BF16_ROUNDINGS}), max|err| {max(r['max_abs_err'] for r in bf16):.3e} (2e-2); "
        f"fp32 max|err| {max(r['max_abs_err'] for r in rows if 'rel_err' not in r):.3e} (2e-5)")
    return rows


def quantized(gen, shape, dev, zero_group=None):
    """Random float32 rows quantized per (leading index, kv-head) by the
    port's writer arithmetic (``quant_kv_page``): (codes int8, scales f32).
    ``zero_group`` names a leading index whose rows are all zero (scale 0)."""
    x = torch.randn(shape, generator=gen, device=dev)
    if zero_group is not None:
        x[zero_group] = 0.0
    return quant_kv_page(x)


def int8_attention_cost(q, hkv, table, vl, n_vis: float, q_rows: int,
                        n_lengths: int) -> tuple[float, float]:
    """Bytes and flops of a paged attention over int8 pools on this data:
    the ``q_rows`` query positions that see a column, one code byte of k and
    of v at each distinct pool position below a frontier, the two scales of
    each distinct page, the table entries up to each frontier, the
    ``n_lengths`` (B,) int32 vectors, the output written once; 4·hd flops
    for each of the ``n_vis`` visible (row, column) pairs a head."""
    h, hd, es = q.shape[2], q.shape[3], q.element_size()
    tab, lens = table.cpu().tolist(), vl.cpu().tolist()
    positions = {(tab[s][t // PAGE], t % PAGE) for s, n in enumerate(lens) for t in range(n)}
    pages = {tab[s][t // PAGE] for s, n in enumerate(lens) for t in range(n)}
    nbytes = (q_rows * h * hd * es + 2 * len(positions) * hkv * hd + 2 * len(pages) * hkv * 4
              + 4 * sum(-(-n // PAGE) for n in lens) + n_lengths * 4 * q.shape[0]
              + q.numel() * es)
    return nbytes, 4.0 * n_vis * h * hd


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
            if kind == "decode":
                got, want = fn(*args), plain(*args)
                torch.cuda.synchronize()
                readings = {"max_abs_err": check_close(name, got, want, dt)}
                assert float(got[5].float().abs().max()) == 0.0, "idle slot must give zeros"
            else:
                readings = check_prefill(name, *args)
            err = readings["max_abs_err"]
            row = {"kernel": name, "dtype": str(dt), "q_offset": q_off, "q_len": q_len,
                   **readings}
            if dt == torch.bfloat16:
                row["ms"] = cuda_ms(lambda: fn(*args))
                row["plain_ms"] = cuda_ms(lambda: plain(*args), iters=3)
                if kind == "decode":
                    n_vis = float(vl.sum())
                    q_rows = int((vl > 0).sum())
                else:
                    col = torch.arange(table.shape[1] * PAGE, device=dev)[None, None, :]
                    qpos = qoff[:, None, None] + torch.arange(c, device=dev)[None, :, None]
                    mask = (col <= qpos) & (col < vl[:, None, None])
                    n_vis = float(mask.sum())
                    q_rows = int(mask.any(-1).sum())
                row["bound_ms"], row["bound_by"] = bound(*int8_attention_cost(
                    q, hkv, table, vl, n_vis, q_rows, 1 if kind == "decode" else 2), dt)
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


# the decode kernel's edges beside the path shapes: GQA groups 1, 2, 3, 6, 8
# and 16 (H, Hkv, hd; hd 64, 80 and 256 beside 128), frontiers 0, 1, 15, 16,
# 17 and the table's full width (MAX_LEN), sentinel entries past every
# other frontier
DECODE_HEADS = ((16, 16, 128), (4, 2, 128), (12, 2, 128), (8, 1, 64), (32, 2, 128),
                (6, 2, 80), (8, 4, 256))
DECODE_EDGE_VL = [0, 1, 15, 16, 17, MAX_LEN, 300, 33]
DENSE_EDGE_SMAX = ((1000, False), (MAX_LEN, True))  # (Smax, int8): fp 1000 is no multiple of 16


def decode_cases(gen, dev, num_blocks) -> list:
    """The decode kernel (route ``ring``) against its plain version at
    DECODE_HEADS x DECODE_EDGE_VL: the paged fp and int8 bodies (one int8
    page all zero) and the dense ones (DENSE_EDGE_SMAX, frontiers capped at
    Smax), bf16 within 2e-2 and fp32 within 2e-5; the idle slot gives
    zeros, two calls on the same inputs the same bits, every launch the
    ring route."""
    rows = []
    for heads in DECODE_HEADS:
        h, hkv, hd = heads
        for dt in (torch.bfloat16, torch.float32):
            q, kp, vp, table, _, vl = paged_case(gen, [0] * SLOTS, DECODE_EDGE_VL, 1, dt, dev,
                                                 num_blocks, heads=heads)
            kc, ks = quantized(gen, (num_blocks, PAGE, hkv, hd), dev, zero_group=int(table[5, 1]))
            vc, vs = quantized(gen, (num_blocks, PAGE, hkv, hd), dev)
            cases = [("paged_decode_attention", f"paged {heads}", dec_mod.paged_decode_attention,
                      dec_mod.paged_decode_attention_plain, (q, kp, vp, table, vl)),
                     ("paged_decode_attention_q", f"paged int8 {heads}",
                      dec_mod.paged_decode_attention, dec_mod.paged_decode_attention_plain,
                      (q, kc, vc, table, vl, ks, vs))]
            for smax, quant in DENSE_EDGE_SMAX:
                dvl = vl.clamp(max=smax).contiguous()
                if quant:
                    shape = (SLOTS, smax // dd_mod.TILE, dd_mod.TILE, hkv, hd)
                    dk, dks = quantized(gen, shape, dev, zero_group=(1, 0))
                    dv, dvs = quantized(gen, shape, dev)
                    args = (q, dk.reshape(SLOTS, smax, hkv, hd), dv.reshape(SLOTS, smax, hkv, hd),
                            dvl, dks, dvs)
                else:
                    dk, dv = (torch.randn(SLOTS, smax, hkv, hd, generator=gen, device=dev).to(dt)
                              for _ in range(2))
                    args = (q, dk, dv, dvl)
                cases.append(("decode_attention_q" if quant else "decode_attention",
                              f"dense Smax {smax} {heads}", dd_mod.decode_attention,
                              dd_mod.decode_attention_plain, args))
            for name, tag, fn, plain, args in cases:
                counter = COUNTERS[name]
                counter.reset()
                got = fn(*args)
                want = plain(*args)
                torch.cuda.synchronize()
                label = f"{name} {tag} {dt}"
                err = check_close(label, got, want, dt)
                assert torch.equal(got, fn(*args)), f"{label}: two calls differ"
                expect_route(counter, dec_mod.ROUTE, 2, label)
                idle = (args[4] if name.startswith("paged") else args[3]) == 0
                for s_ in idle.nonzero().flatten().tolist():
                    assert float(got[s_].float().abs().max()) == 0.0, f"{label}: idle slot {s_}"
                rows.append({"kernel": name, "case": "edge", "layout": tag, "dtype": str(dt),
                             "max_abs_err": err})
    errs = {dt: max(r["max_abs_err"] for r in rows if r["dtype"] == dt)
            for dt in ("torch.bfloat16", "torch.float32")}
    log(f"[kernels] decode (paged and dense, fp and int8) ok at {len(rows)} edge cases (H/Hkv/hd "
        f"{list(DECODE_HEADS)}; kv_valid_len {DECODE_EDGE_VL}; dense Smax 1000 fp and 1024 int8): "
        f"max|err| bf16 {errs['torch.bfloat16']:.3e} (2e-2), fp32 {errs['torch.float32']:.3e} "
        f"(2e-5); idle slots zero; two calls identical bit for bit; every launch on the "
        f"{dec_mod.ROUTE} route")
    return rows


# ------------------------------------------------------------------- MoE
# full-width olmoe-1b-7b (configs/olmoe_1b_7b.py): 64 experts top-8, d_ff
# 1024 per expert, an untied head of 50304; a training step routes its
# batch x seq = 2048 tokens in 32 groups of 64 with capacity 10, so every
# expert buffer holds 32 x 10 = 320 rows
MOE_ARCH = "olmoe-1b-7b"
# the paged pool of full-width olmoe at SLOTS x MAX_LEN, reckoned by hand:
# 2 (k, v) x 16 layers x 512 blocks x 16 rows x 16 kv heads x 128 x 2 bytes
MOE_POOL_BYTES = 1_073_741_824
# ... and on int8 KV: codes 536,870,912 + float32 scales 1,048,576 (paged: a
# scale per (block, kv-head); dense: per (slot, 16 rows, kv-head); the same)
MOE_POOL_BYTES_INT8 = 537_919_488


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

    def timed(kernel, tag, fn, plain, dt, cost, check=None, lib=None):
        if check is None:
            got, want = fn(), plain()
            torch.cuda.synchronize()
            readings = {"max_abs_err": check_close(f"{kernel} olmoe {tag}", got, want, dt)}
        else:
            readings = check()
        row = {"kernel": kernel, "arch": MOE_ARCH, "case": tag, "dtype": str(dt), **readings}
        if dt == torch.bfloat16:
            row["ms"] = cuda_ms(fn)
            row["plain_ms"] = cuda_ms(plain, iters=3)
            row["bound_ms"], row["bound_by"] = bound(*cost(), dt)
            row["library_ms"] = cuda_ms(lib) if lib is not None else None
            out[kernel] = row
            summary[kernel]["olmoe"] = {key: row[key] for key in (
                "case", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")}
        detail.append(row)

    for dt in (torch.bfloat16, torch.float32):
        q, kp, vp, table, _, vl = paged_case(gen, [0] * SLOTS, dec_vl, 1, dt, dev, num_blocks,
                                             arch=MOE_ARCH)
        s_len = table.shape[1] * PAGE
        dmask = (torch.arange(s_len, device=dev)[None, :] < vl[:, None])[:, None, None, :]
        timed(
            "paged_decode_attention", "q (8,1,16,128), group 1",
            lambda: dec_mod.paged_decode_attention(q, kp, vp, table, vl),
            lambda: dec_mod.paged_decode_attention_plain(q, kp, vp, table, vl), dt,
            lambda: decode_cost(q, kp, table, vl),
            lib=sdpa_yardstick(q, kp, vp, table, dmask))
        q, kp, vp, table, qoff, vl = paged_case(gen, pre_off, pre_len, PREFILL_CHUNK, dt, dev,
                                                num_blocks, arch=MOE_ARCH)
        mask = prefill_mask(qoff, vl, table, dev)
        timed(
            "paged_prefill_attention", "q (8,256,16,128), group 1",
            lambda: pre_mod.paged_prefill_attention(q, kp, vp, table, qoff, vl),
            lambda: pre_mod.paged_prefill_attention_plain(q, kp, vp, table, qoff, vl), dt,
            lambda: prefill_cost(q, kp, table, qoff, vl, mask),
            check=lambda: check_prefill("paged_prefill_attention olmoe", q, kp, vp, table,
                                        qoff, vl),
            lib=sdpa_yardstick(q, kp, vp, table, mask))
        # the int8 body at olmoe's heads (a kernel case: olmoe serves fp KV)
        hkv, hd = kp.shape[2], kp.shape[3]
        kc, ks = quantized(gen, (num_blocks, PAGE, hkv, hd), dev, zero_group=int(table[4, 1]))
        vc, vs = quantized(gen, (num_blocks, PAGE, hkv, hd), dev)
        qargs = (q, kc, vc, table, qoff, vl, ks, vs)
        timed(
            "paged_prefill_attention_q", "q (8,256,16,128), group 1, int8 pools",
            lambda: pre_mod.paged_prefill_attention(*qargs),
            lambda: pre_mod.paged_prefill_attention_plain(*qargs), dt,
            lambda: int8_attention_cost(q, hkv, table, vl, float(mask.sum()),
                                        int(mask[:, 0].any(-1).sum()), 2),
            check=lambda: check_prefill("paged_prefill_attention_q olmoe", *qargs))
        x = torch.randn(m_tok, d, generator=gen, device=dev).to(dt)
        w = (torch.randn(d, d, generator=gen, device=dev) * d**-0.5).to(dt)
        idx = torch.randint(0, d, (TRAIN_K, d), generator=gen, device=dev, dtype=torch.int32)
        val = (torch.randn(TRAIN_K, d, generator=gen, device=dev) * 0.05).to(torch.bfloat16)
        reset_counters()
        timed(
            "fused_linear", "2048 x 2048 x 2048, no bias, k=1",
            lambda: fl_mod.fused_linear(x, w, idx, val, None),
            lambda: fl_mod.fused_linear_plain(x, w, idx, val, None), dt,
            lambda: linear_cost(x, w, idx, val, None), lib=lambda: torch.mm(x, w))
        want_route = "wgmma" if dt == torch.bfloat16 else "f32"
        assert set(COUNTERS["fused_linear"].routes) == {want_route}, COUNTERS["fused_linear"].routes
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


# the shapes this slice's paths run the earlier kernels at: fused_linear_q
# on an olmoe-1b-7b packed base — an attention projection (K = N = 2048,
# bypass k = 1 in training) and the untied head (2048 -> 50304, no bypass:
# the head's delta is sparse_delta's) at a training step's 2048 rows and a
# decode step's 8 — and the int8 attention bodies at olmoe's 16/16 heads
LIFECYCLE_LINEAR = (("attention", 2048, 2048, 1), ("attention", 2048, 2048, 0),
                    ("head", 2048, 50304, 0))


def lifecycle_kernels(gen, dev, summary, detail, card: str, num_blocks: int, dec_vl) -> None:
    """``fused_linear_q`` (int8 and NF4, bf16 and fp32) at olmoe's packed
    shapes on the route ``quant_linear.route`` names (M = 2048 ``wgmma``,
    M = 8 ``skinny``), two bf16 calls bit for bit, the bf16 calls timed
    beside the bound and ``torch.mm`` on the dense weight; the int8 paged
    decode body at q (8, 1, 16, 128) over an int8 pool (16 kv-heads, one
    page all zero) and the dense int8 decode over an (8, 1024, 16, 128)
    slot cache (one 16-row group all zero), bf16 and fp32, bf16 timed. Each
    goes into its kernel's ``olmoe`` entry of the summary."""
    cfg = get_config(MOE_ARCH)
    counter = COUNTERS["fused_linear_q"]
    cases = {}
    for qd in PACKED:
        for name, k_dim, n_dim, kk in LIFECYCLE_LINEAR:
            w = torch.randn(k_dim, n_dim, generator=gen, device=dev) * k_dim**-0.5
            for m in ((TRAIN_BATCH * TRAIN_SEQ,) if kk else (TRAIN_BATCH * TRAIN_SEQ, SLOTS)):
                for dt in (torch.bfloat16, torch.float32):
                    wd = w.to(dt)
                    qt = quantize(wd, qd, QUANT_BLOCK)
                    x = torch.randn(m, k_dim, generator=gen, device=dev).to(dt)
                    idx = val = None
                    if kk:
                        idx = torch.randint(0, k_dim, (kk, n_dim), generator=gen, device=dev,
                                            dtype=torch.int32)
                        val = (torch.randn(kk, n_dim, generator=gen, device=dev) * 0.05).to(
                            torch.bfloat16)
                    args = (x, qt.data, qt.scales, idx, val, None)
                    fn = lambda: ql_mod.fused_linear_q(*args, qdtype=qd, block=QUANT_BLOCK)  # noqa: E731
                    plain = lambda: ql_mod.fused_linear_q_plain(*args, qdtype=qd,  # noqa: E731
                                                                block=QUANT_BLOCK)
                    tag = f"fused_linear_q {qd} olmoe {name} M={m} K={k_dim} N={n_dim} k={kk}"
                    counter.reset()
                    got, want = fn(), plain()
                    torch.cuda.synchronize()
                    err = check_close(tag, got, want, dt)
                    route = ql_mod.route(m, k_dim, n_dim, dt, (x.data_ptr(), qt.data.data_ptr(),
                                                               qt.scales.data_ptr()))
                    assert route == ("f32" if dt == torch.float32 else
                                     "skinny" if m == SLOTS else "wgmma"), (tag, route)
                    expect_route(counter, route, 1, tag)
                    row = {"kernel": "fused_linear_q", "arch": MOE_ARCH, "qdtype": qd,
                           "proj": name, "M": m, "K": k_dim, "N": n_dim, "k": kk,
                           "dtype": str(dt), "route": route, "max_abs_err": err}
                    del got, want
                    if dt == torch.bfloat16:
                        assert torch.equal(fn(), fn()), f"{tag}: two calls differ"
                        row["ms"] = cuda_ms(fn)
                        row["plain_ms"] = cuda_ms(plain, iters=3)
                        row["bound_ms"], row["bound_by"] = bound(
                            *packed_cost(x, qt, kk, val, None), dt)
                        row["library_ms"] = cuda_ms(lambda: torch.mm(x, wd))
                        cases[f"{qd} {name} M={m} k={kk}"] = {
                            key: row[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                      "library_ms", "max_abs_err", "route")}
                        log(f"[kernels] {tag} ({route}): {row['ms']:.4f} ms (plain "
                            f"{row['plain_ms']:.4f}, torch.mm dense bf16 "
                            f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f} by "
                            f"{row['bound_by']}); max|err| {err:.3e} [{card}]")
                    detail.append(row)
    summary["fused_linear_q"]["olmoe"] = {
        "case": "olmoe-1b-7b packed: attention K = N = 2048 (k = 1 at M = 2048, k = 0 at "
                "M = 8) and the untied head 2048 -> 50304 (k = 0), block "
                f"{QUANT_BLOCK}", "cases": cases,
        **{key: cases["int8 attention M=2048 k=1"][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "max_abs_err": max(c["max_abs_err"] for c in cases.values())}

    # -- the int8 attention bodies at olmoe's heads (group 1)
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    for dt in (torch.bfloat16, torch.float32):
        q, _, _, table, _, vl = paged_case(gen, [0] * SLOTS, dec_vl, 1, dt, dev, num_blocks,
                                           arch=MOE_ARCH)
        kc, ks = quantized(gen, (num_blocks, PAGE, hkv, hd), dev, zero_group=int(table[4, 1]))
        vc, vs = quantized(gen, (num_blocks, PAGE, hkv, hd), dev)
        args = (q, kc, vc, table, vl, ks, vs)
        got = dec_mod.paged_decode_attention(*args)
        want = dec_mod.paged_decode_attention_plain(*args)
        torch.cuda.synchronize()
        err = check_close("paged_decode_attention_q olmoe", got, want, dt)
        assert float(got[5].float().abs().max()) == 0.0, "idle slot must give zeros"
        row = {"kernel": "paged_decode_attention_q", "arch": MOE_ARCH, "dtype": str(dt),
               "case": "q (8,1,16,128), group 1, int8 pools", "max_abs_err": err}
        if dt == torch.bfloat16:
            row["ms"] = cuda_ms(lambda: dec_mod.paged_decode_attention(*args))
            row["plain_ms"] = cuda_ms(lambda: dec_mod.paged_decode_attention_plain(*args),
                                      iters=3)
            row["bound_ms"], row["bound_by"] = bound(*int8_attention_cost(
                q, hkv, table, vl, float(vl.sum()), int((vl > 0).sum()), 1), dt)
            row["library_ms"] = None
            summary["paged_decode_attention_q"]["olmoe"] = {key: row[key] for key in (
                "case", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")}
        detail.append(row)
        vl = torch.tensor([0, 1, MAX_LEN, 300, 17, MAX_LEN - 1, 640, 33], dtype=torch.int32,
                          device=dev)
        g = MAX_LEN // dd_mod.TILE
        kc, ks = quantized(gen, (SLOTS, g, dd_mod.TILE, hkv, hd), dev, zero_group=(1, 0))
        vc, vs = quantized(gen, (SLOTS, g, dd_mod.TILE, hkv, hd), dev)
        qd_ = torch.randn(SLOTS, 1, h, hd, generator=gen, device=dev).to(dt)
        args = (qd_, kc.reshape(SLOTS, MAX_LEN, hkv, hd), vc.reshape(SLOTS, MAX_LEN, hkv, hd),
                vl, ks, vs)
        got = dd_mod.decode_attention(*args)
        want = dd_mod.decode_attention_plain(*args)
        torch.cuda.synchronize()
        err = check_close("decode_attention_q olmoe", got, want, dt)
        assert float(got[0].float().abs().max()) == 0.0, "kv_valid_len 0 must give zeros"
        row = {"kernel": "decode_attention_q", "arch": MOE_ARCH, "dtype": str(dt),
               "case": f"q (8,1,16,128), cache (8,{MAX_LEN},16,128) int8, group 1",
               "max_abs_err": err}
        if dt == torch.bfloat16:
            row["ms"] = cuda_ms(lambda: dd_mod.decode_attention(*args))
            row["plain_ms"] = cuda_ms(lambda: dd_mod.decode_attention_plain(*args), iters=3)
            rows = int(vl.sum())
            tiles = sum(-(-n // dd_mod.TILE) for n in vl.tolist())
            es = qd_.element_size()
            nbytes = (int((vl > 0).sum()) * h * hd * es + 2 * rows * hkv * hd
                      + 2 * tiles * hkv * 4 + 4 * SLOTS + qd_.numel() * es)
            row["bound_ms"], row["bound_by"] = bound(nbytes, 4.0 * rows * h * hd, dt)
            row["library_ms"] = None
            summary["decode_attention_q"]["olmoe"] = {key: row[key] for key in (
                "case", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")}
        detail.append(row)
    for name in ("paged_decode_attention_q", "decode_attention_q"):
        r = summary[name]["olmoe"]
        log(f"[kernels] {name} at olmoe's heads ok: {r['case']}: {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.5f} by {r['bound_by']}); max|err| bf16 "
            f"{r['max_abs_err']:.3e} [{card}]")


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


def old_fused_linear(x, w, idx, val, bias):
    """The WMMA kernel that bf16 took at every shape before the TMA + wgmma
    route (the wrapper now sends it only shapes TMA cannot describe):
    called directly, timed beside the new route in the same run."""
    m, kd = x.shape
    y = torch.empty((m, w.shape[1]), dtype=x.dtype, device=x.device)

    def run():
        build.check(build.library().rt_fused_linear(
            x.data_ptr(), w.data_ptr(), idx.data_ptr(), val.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(), m, w.shape[1], kd,
            idx.shape[0], 1, 1 if val.dtype == torch.bfloat16 else 0,
            torch.cuda.current_stream().cuda_stream), "fused_linear (WMMA)")
        return y
    return run


def expect_route(counter, want: str, n: int, what: str) -> None:
    """Every one of the last ``n`` launches counted by ``counter`` (reset
    before them) took route ``want``."""
    assert counter.routes == {want: n}, f"{what}: routes {counter.routes}, want {want} x {n}"


DECODE_NAMES = ("paged_decode_attention", "paged_decode_attention_q", "decode_attention",
                "decode_attention_q")


def decode_routes(what: str) -> dict:
    """Every decode launch since the counters were reset (at least one)
    took the decode kernel's route; returns the launches by kernel."""
    n = {}
    for name in DECODE_NAMES:
        c = COUNTERS[name]
        if c.kernel:
            expect_route(c, dec_mod.ROUTE, c.kernel, f"{what}: {name}")
            n[name] = c.kernel
    assert n, f"{what}: no decode launch"
    log(f"[{what}] every decode launch on the {dec_mod.ROUTE} route: {json.dumps(n)}")
    return n


def apply_routes(what: str, per_forward: int = 0, forwards: int = 0) -> dict:
    """Every bypass-apply launch since the counters were reset (at least
    one) took a fused route: the serving epilogue added the bypass (and the
    bias) into the base product. With ``per_forward``, there were that many
    a layer-forward. Returns the launches by route (``rows``: decode steps,
    ``tiles``: mixed steps)."""
    c = COUNTERS["sparse_delta_batched"]
    routes = dict(c.routes)
    assert c.kernel > 0 and sum(routes.values()) == c.kernel, (what, routes)
    assert all(r.endswith("-fused") for r in routes), f"{what}: apply routes {routes}"
    assert not per_forward or c.kernel == per_forward * forwards, \
        (what, c.kernel, per_forward, forwards)
    log(f"[{what}] every bypass apply on a fused route: {json.dumps(routes)}")
    return routes


# edge shapes of the TMA + wgmma route beside the WMMA kernel's ragged ones:
# (M, K, N, k, x offset in elements). K 77 / 4500, N 129 and an x that
# starts 4 elements (8 bytes) into its buffer take the WMMA kernel; rows
# past a 32-row tile (130, 2047), K = 1000 (a partial last K tile), N = 264
# (a partial last column tile) take the new one
LINEAR_EDGE = ((130, 77, 129, 1, 0), (200, 1000, 264, 2, 0), (7, 4500, 520, 3, 0),
               (130, 1000, 256, 1, 0), (2047, 1536, 256, 2, 0), (200, 1000, 264, 1, 4))


def train_kernels(gen, projections, dev, summary, detail, card: str) -> None:
    """``fused_linear`` and ``sparse_delta_dval`` at every projection of a
    full-width training step (M = batch x seq rows; qkv carry a bias; k =
    1 magnitude selection gives one distinct index per column), bf16 and
    fp32; the bf16 calls timed, summed over the layer's 7 projections, with
    fused_linear's k = 0 time (the bypass's share), the WMMA kernel's on
    the same inputs and the host time of the launch's tensor-map encodes."""
    # edge shapes first (untimed): row, column and K tails, K not a multiple
    # of 8 and a misaligned x (the WMMA kernel), k > 1, both value dtypes;
    # every launch on the route the wrapper names, two bf16 calls the same bits
    counter = COUNTERS["fused_linear"]
    for rm, rk, rn, kk, off in LINEAR_EDGE:
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(rm * rk + off, generator=gen, device=dev).to(dt)[off:].view(rm, rk)
            w = (torch.randn(rk, rn, generator=gen, device=dev) * rk**-0.5).to(dt)
            idx = torch.randint(0, rk, (kk, rn), generator=gen, device=dev, dtype=torch.int32)
            b = torch.randn(rn, generator=gen, device=dev).to(dt)
            dy = (torch.randn(rm, rn, generator=gen, device=dev) * rm**-0.5).to(dt)
            want_route = fl_mod.route(rm, rk, rn, dt, (x.data_ptr(), w.data_ptr()))
            for vdt in (torch.bfloat16, torch.float32):
                val = (torch.randn(kk, rn, generator=gen, device=dev) * 0.05).to(vdt)
                for bias in (b, None):
                    counter.reset()
                    got = fl_mod.fused_linear(x, w, idx, val, bias)
                    want = fl_mod.fused_linear_plain(x, w, idx, val, bias)
                    torch.cuda.synchronize()
                    name = f"fused_linear edge M={rm} K={rk} N={rn} k={kk} offset {off} {dt}"
                    check_close(name, got, want, dt)
                    expect_route(counter, want_route, 1, name)
                    if dt == torch.bfloat16:
                        assert torch.equal(got, fl_mod.fused_linear(x, w, idx, val, bias)), \
                            f"{name}: two calls differ"
            if off == 0:
                got = sd_mod.sparse_delta_dval(x, idx, dy)
                want = sd_mod.sparse_delta_dval_plain(x, idx, dy)
                torch.cuda.synchronize()
                check_close(f"sparse_delta_dval ragged M={rm} d_in={rk} d_out={rn}", got, want,
                            dt)
    log(f"[kernels] fused_linear and sparse_delta_dval ok on edge shapes (M 7/130/200/2047, "
        f"K 77/1000/1536/4500, N 129/256/264/520, k 1-3, an x 8 bytes off; each on the "
        f"route fused_linear.route names: wgmma, wmma or f32; bf16 2e-2, fp32 2e-5; two bf16 "
        f"calls identical bit for bit)")
    m = TRAIN_BATCH * TRAIN_SEQ
    layer = {n: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "flops": 0.0, "lib": 0.0,
                 "err": 0.0, "k0_ms": 0.0, "old_ms": 0.0, "encode_us": 0.0} for n in TRAINING}
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
            counter.reset()
            COUNTERS["sparse_delta_dval"].reset()
            got = fl_mod.fused_linear(x, w, idx, val, bias)
            want = fl_mod.fused_linear_plain(x, w, idx, val, bias)
            gd = sd_mod.sparse_delta_dval(x, idx, dy)
            wd = sd_mod.sparse_delta_dval_plain(x, idx, dy)
            torch.cuda.synchronize()
            e_fl = check_close(f"fused_linear {name} K={d_in} N={d_out}", got, want, dt)
            e_dv = check_close(f"sparse_delta_dval {name}", gd, wd, dt)
            expect_route(counter, "wgmma" if dt == torch.bfloat16 else "f32", 1,
                         f"fused_linear {name}")
            assert torch.equal(gd, sd_mod.sparse_delta_dval(x, idx, dy)), \
                f"sparse_delta_dval {name}: two launches on the same inputs differ"
            # in the values' dtype: one rounding of the same float32 sums
            assert torch.equal(sd_mod.sparse_delta_dval(x, idx, dy, val.dtype),
                               gd.to(val.dtype)), f"sparse_delta_dval {name} in {val.dtype}"
            expect_route(COUNTERS["sparse_delta_dval"], sd_mod.DVAL_ROUTE, 3,
                         f"sparse_delta_dval {name}")
            rows = [{"kernel": "fused_linear", "proj": name, "M": m, "K": d_in, "N": d_out,
                     "bias": bias is not None, "dtype": str(dt), "max_abs_err": e_fl},
                    {"kernel": "sparse_delta_dval", "proj": name, "M": m, "d_in": d_in,
                     "d_out": d_out, "dtype": str(dt), "max_abs_err": e_dv}]
            if dt == torch.bfloat16:
                assert torch.equal(got, fl_mod.fused_linear(x, w, idx, val, bias)), \
                    f"fused_linear {name}: two calls differ"
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
                # the bypass's share: the same call with no bypass entries
                idx0, val0 = idx[:0], val[:0]
                rows[0]["k0_ms"] = cuda_ms(lambda: fl_mod.fused_linear(x, w, idx0, val0, bias))
                rows[0]["old_ms"] = cuda_ms(old_fused_linear(x, w, idx, val, bias))
                rows[0]["tile_rows"] = fl_mod.linear_plan(m, d_out, d_in,
                                                          dec_mod.sm_count(x.device))[1]
                rows[0]["encode_us"] = fl_mod.encode_ns(x, w, rows[0]["tile_rows"]) / 1e3
                fl_acc = layer["fused_linear"]
                for key in ("k0_ms", "old_ms", "encode_us"):
                    fl_acc[key] += rows[0][key]
                fl_acc["lib"] += rows[0]["library_ms"]
                r0, r1 = rows
                log(f"[kernels] {name} K={d_in} N={d_out}: fused_linear {r0['ms']:.4f} ms "
                    f"(k=0 {r0['k0_ms']:.4f}, WMMA kernel {r0['old_ms']:.4f}, plain "
                    f"{r0['plain_ms']:.4f}, torch.addmm dense part {r0['library_ms']:.4f}, "
                    f"bound {r0['bound_ms']:.4f} by {r0['bound_by']}; {r0['tile_rows']}-row "
                    f"tiles, tensor-map encode {r0['encode_us']:.3f} us on the host); "
                    f"sparse_delta_dval {r1['ms']:.4f} ms (plain {r1['plain_ms']:.4f}, bound "
                    f"{r1['bound_ms']:.4f} by {r1['bound_by']}) [{card}]")
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
        extra = ""
        if name == "fused_linear":
            summary[name].update(launch_route="wgmma", k0_ms=acc["k0_ms"],
                                 old_ms=acc["old_ms"], encode_us=acc["encode_us"])
            extra = (f", k=0 {acc['k0_ms']:.4f}, WMMA kernel {acc['old_ms']:.4f}, torch.addmm/mm "
                     f"dense part {acc['lib']:.4f}, tensor-map encodes {acc['encode_us']:.3f} us "
                     f"of host time")
        log(f"[kernels] {name} ok (bf16 2e-2, fp32 2e-5 at all 7 shapes): max|err| bf16 "
            f"{acc['err']:.3e}; one layer {acc['ms']:.4f} ms (plain {acc['plain_ms']:.4f}"
            f"{extra}, bound {b_ms:.4f} by {b_by}) [{card}]")


def dval_long(gen, projections, dev, summary, card: str) -> list:
    """``sparse_delta_dval`` at every projection of a long-context step (M
    = 1 x 4096 rows, k = 1), bf16: against its plain version, timed beside
    its bound, summed over the layer into the kernel's ``m4096`` entry."""
    m = LONG_BATCH * LONG_SEQ
    rows, acc = [], {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "flops": 0.0, "err": 0.0}
    for name, d_in, d_out in projections:
        x = torch.randn(m, d_in, generator=gen, device=dev).to(torch.bfloat16)
        idx = torch.randint(0, d_in, (TRAIN_K, d_out), generator=gen, device=dev,
                            dtype=torch.int32)
        dy = (torch.randn(m, d_out, generator=gen, device=dev) * m**-0.5).to(torch.bfloat16)
        got = sd_mod.sparse_delta_dval(x, idx, dy)
        err = check_close(f"sparse_delta_dval {name} M={m}", got,
                          sd_mod.sparse_delta_dval_plain(x, idx, dy), torch.bfloat16)
        row = {"kernel": "sparse_delta_dval", "proj": name, "M": m, "d_in": d_in, "d_out": d_out,
               "dtype": str(torch.bfloat16), "max_abs_err": err,
               "ms": cuda_ms(lambda: sd_mod.sparse_delta_dval(x, idx, dy)),
               "plain_ms": cuda_ms(lambda: sd_mod.sparse_delta_dval_plain(x, idx, dy), iters=3)}
        cost = dval_cost(x, idx, dy)
        row["bound_ms"], row["bound_by"] = bound(*cost, torch.bfloat16)
        for key, v in (("ms", row["ms"]), ("plain_ms", row["plain_ms"]), ("bytes", cost[0]),
                       ("flops", cost[1])):
            acc[key] += v
        acc["err"] = max(acc["err"], err)
        rows.append(row)
    b_ms, b_by = bound(acc["bytes"], acc["flops"], torch.bfloat16)
    summary["sparse_delta_dval"]["m4096"] = {
        "ms": acc["ms"], "plain_ms": acc["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": acc["err"], "shape": f"7 projections of one layer, M={m} bf16 rows, k=1"}
    log(f"[kernels] sparse_delta_dval one layer at M={m}: {acc['ms']:.4f} ms (plain "
        f"{acc['plain_ms']:.4f}, bound {b_ms:.4f} by {b_by}; max|err| {acc['err']:.3e}) [{card}]")
    return rows


def flash_cost(q, k, causal: bool) -> tuple[float, float]:
    """q, k and v read once, out and the float32 lse written once; 4·hd
    flops (q kᵀ and p v) for every (query, key) pair a head sees."""
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    n = min(sq, skv)
    pairs = n * (n + 1) // 2 + (sq - n) * skv if causal else sq * skv
    nbytes = (2 * q.numel() + 2 * b * skv * hkv * hd) * q.element_size() + b * h * sq * 4
    return nbytes, 4.0 * b * h * hd * pairs


def check_flash(name: str, q, k, v, causal: bool, out, lse) -> dict:
    """``flash_attention_fwd``'s (out, lse) against its plain version on the
    same inputs: lse to FLASH_LSE_ATOL, bf16 out's relative error to
    FLASH_BF16_ROUNDINGS roundings, out elementwise to TOL. Every reading is
    taken before any is held, and a failure names them all."""
    want, want_lse = fa_mod.flash_attention_fwd_plain(q, k, v, causal=causal)
    row = {"max_abs_err": max_err(out, want), "lse_max_abs_err": max_err(lse, want_lse)}
    bounds = {"lse_max_abs_err": FLASH_LSE_ATOL}
    if q.dtype == torch.bfloat16:
        exact = fa_mod.flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                                 causal=causal)[0]
        row.update(rel_to_exact(out, exact))
        bounds["rel_err"] = FLASH_BF16_ROUNDINGS * row["rounding"]
    for key, b in bounds.items():
        assert row[key] <= b, f"{name}: {key} {row[key]:.3e} > {b:.3e} ({row})"
    check_close(name, out, want, q.dtype)
    return row


# the wgmma route's edges: (B, Sq, Skv, H, Hkv, hd, causal, q/k/v as strided
# views of one fused (B, S, (H + 2 Hkv) hd) projection); Sq and Skv off the
# 128-row tiles, Skv != Sq (full and causal), Sq below one tile
FLASH_WGMMA_EDGE = ((1, 200, 200, 4, 2, 64, True, False), (2, 300, 300, 12, 2, 128, True, True),
                    (1, 130, 333, 6, 6, 128, False, False), (1, 517, 517, 8, 2, 64, False, True),
                    (1, 64, 1000, 4, 1, 128, False, False), (1, 333, 200, 4, 2, 128, True, False))


def flash_call(name, q, k, v, causal: bool) -> tuple:
    """``flash_attention_fwd`` twice on the same inputs: the same bits, both
    launches on the route ``route`` names. Returns (out, lse)."""
    counter = COUNTERS["flash_attention_fwd"]
    counter.reset()
    out, lse = fa_mod.flash_attention_fwd(q, k, v, causal=causal)
    out2, lse2 = fa_mod.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2), f"{name}: two calls differ"
    expect_route(counter, fa_mod.route(q, k, v), 2, name)
    return out, lse


def flash_cases(gen, dev) -> tuple[list, dict]:
    """``flash_attention_fwd`` against its plain version (``check_flash``),
    every case called twice (``flash_call``: the same bits, the route
    ``route`` names): causal and full, bf16 and fp32, hd 16 / 64 / 128, GQA
    groups 1 and 6, ragged S (130, 2000); the wgmma route's edges
    (FLASH_WGMMA_EDGE); then the path shapes, bf16 causal — qwen2-1.5b's
    (1, 4096, 12/2, 128) and olmoe-1b-7b's (1, 2048, 16/16, 128), both on
    the wgmma route. Returns every case's readings and, by arch, the path
    shape's (q, k, v, out, lse, readings)."""
    def qkv(b, s, h, hkv, hd, dt):
        return (torch.randn(b, s, n, hd, generator=gen, device=dev).to(dt) for n in (h, hkv, hkv))

    checked, path = [], {}
    cases = ((1, 130, 4, 4, 16), (1, 130, 6, 1, 16), (2, 2000, 12, 2, 64),
             (1, 2000, 16, 16, 128), (1, 130, 12, 2, 128))
    for b, s, h, hkv, hd in cases:
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = qkv(b, s, h, hkv, hd, dt)
            for causal in (True, False):
                name = f"flash_attention_fwd {(b, s, h, hkv, hd)} {dt} causal={causal}"
                out, lse = flash_call(name, q, k, v, causal)
                checked.append({"kernel": "flash_attention_fwd", "shape": [b, s, h, hkv, hd],
                                "dtype": str(dt), "causal": causal,
                                "route": fa_mod.route(q, k, v),
                                **check_flash(name, q, k, v, causal, out, lse)})
    for b, sq, skv, h, hkv, hd, causal, fused in FLASH_WGMMA_EDGE:
        if fused:
            qkv_ = torch.randn(b, sq, (h + 2 * hkv) * hd, generator=gen, device=dev).to(
                torch.bfloat16)
            q, k, v = (qkv_[..., a * hd:(a + n) * hd].unflatten(-1, (n, hd))
                       for a, n in ((0, h), (h, hkv), (h + hkv, hkv)))
        else:
            q = torch.randn(b, sq, h, hd, generator=gen, device=dev).to(torch.bfloat16)
            k, v = (torch.randn(b, skv, hkv, hd, generator=gen, device=dev).to(torch.bfloat16)
                    for _ in range(2))
        name = f"flash_attention_fwd wgmma edge {(b, sq, skv, h, hkv, hd)} causal={causal}" + (
            " fused qkv" if fused else "")
        assert fa_mod.route(q, k, v) == "wgmma", name
        out, lse = flash_call(name, q, k, v, causal)
        checked.append({"kernel": "flash_attention_fwd", "case": "wgmma edge",
                        "shape": [b, sq, skv, h, hkv, hd], "fused": fused,
                        "dtype": "torch.bfloat16", "causal": causal, "route": "wgmma",
                        **check_flash(name, q, k, v, causal, out, lse)})
    for arch, (b, s, h, hkv, hd) in (("qwen2-1.5b", (LONG_BATCH, LONG_SEQ, 12, 2, 128)),
                                     (MOE_ARCH, (1, 2048, 16, 16, 128))):
        cfg = get_config(arch)
        assert (h, hkv, hd) == (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim)
        q, k, v = qkv(b, s, h, hkv, hd, torch.bfloat16)
        assert fa_mod.route(q, k, v) == "wgmma", arch
        out, lse = flash_call(f"flash_attention_fwd {arch}", q, k, v, True)
        row = {"kernel": "flash_attention_fwd", "arch": arch, "shape": [b, s, h, hkv, hd],
               "dtype": "torch.bfloat16", "causal": True, "route": "wgmma",
               **check_flash(f"flash_attention_fwd {arch}", q, k, v, True, out, lse)}
        checked.append(row)
        path[arch] = (q, k, v, out, lse, row)
    bf16 = [r for r in checked if "rel_err" in r]
    log(f"[kernels] flash_attention_fwd ok on out and lse at {len(checked)} cases (causal and "
        f"full, bf16 and fp32, hd 16/64/128, GQA groups 1 and 6, S 130 and 2000, the wgmma "
        f"route's edges {[c[:7] for c in FLASH_WGMMA_EDGE]} (fused qkv views among them), both "
        f"path shapes; two calls identical bit for bit, each on the route route() names): lse "
        f"max|err| {max(r['lse_max_abs_err'] for r in checked):.3e} (bound "
        f"{FLASH_LSE_ATOL}); bf16 out relative error at most "
        f"{max(r['rel_err'] / r['rounding'] for r in bf16):.2f} roundings (bound "
        f"{FLASH_BF16_ROUNDINGS}), max|err| {max(r['max_abs_err'] for r in bf16):.3e} (2e-2); "
        f"fp32 out max|err| "
        f"{max(r['max_abs_err'] for r in checked if r['dtype'] == 'torch.float32'):.3e} (2e-5)")
    return checked, path


def long_context_kernels(gen, dev, summary, detail, card: str) -> None:
    """``flash_attention_fwd`` held against its plain version (``flash_cases``);
    at the path shapes timed beside the plain version, the bound and one SDPA
    call (the port never calls it), and the plain backward
    (``flash_attention_bwd``, block 512) at qwen2's shape."""
    checked, path = flash_cases(gen, dev)
    detail.extend(checked)
    rows = {}
    for arch, (q, k, v, out, lse, row) in path.items():
        cfg = get_config(arch)
        b, s, h, hkv, hd = row["shape"]
        row["ms"] = cuda_ms(lambda: fa_mod.flash_attention_fwd(q, k, v, causal=True))
        row["mma_ms"] = cuda_ms(mma_flash(q, k, v, True))
        row["plain_ms"] = cuda_ms(lambda: fa_mod.flash_attention_fwd_plain(q, k, v, causal=True),
                                  iters=3)
        row["bound_ms"], row["bound_by"] = bound(*flash_cost(q, k, True), torch.bfloat16)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        row["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        if arch == "qwen2-1.5b":
            dout = torch.randn(out.shape, generator=gen, device=dev).to(out.dtype)
            row["backward_plain_ms"] = cuda_ms(lambda: flash_attention_bwd(
                q, k, v, out, lse, dout, causal=True, block=cfg.flash_block), iters=3)
        rows[arch] = row
        log(f"[kernels] flash_attention_fwd {arch} {(b, s, h, hkv, hd)} bf16 causal: max|err| "
            f"{row['max_abs_err']:.3e}, relative {row['rel_err']:.3e} "
            f"({row['rel_err'] / row['rounding']:.2f} roundings), lse {row['lse_max_abs_err']:.3e}; {row['ms']:.4f} ms "
            f"(mma route {row['mma_ms']:.4f}, plain {row['plain_ms']:.4f}, sdpa "
            f"{row['library_ms']:.4f}, bound "
            f"{row['bound_ms']:.4f} by {row['bound_by']})"
            + (f"; plain backward {row['backward_plain_ms']:.4f} ms"
               if "backward_plain_ms" in row else "") + f" [{card}]")
    r, o = rows["qwen2-1.5b"], rows[MOE_ARCH]
    summary["flash_attention_fwd"] = {
        "source": fa_mod.SOURCE, "replaces": fa_mod.REPLACES, "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "backward_plain_ms": r["backward_plain_ms"],
        "shape": f"one layer of qwen2-1.5b: q ({LONG_BATCH}, {LONG_SEQ}, 12, 128), k/v "
                 f"({LONG_BATCH}, {LONG_SEQ}, 2, 128) bf16, causal",
        "launch_route": "wgmma", "mma_ms": r["mma_ms"],
        "olmoe": {k: o[k] for k in ("ms", "mma_ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "max_abs_err")},
    }


def weight_stacks(cfg) -> list:
    """(name, shape) of every stack magnitude selection runs on: the
    adapted projections' (L[, E], d_in, d_out) leaves and an untied head."""
    L, d, hd = cfg.num_layers, cfg.d_model, cfg.resolved_head_dim
    dq, dkv, f = cfg.num_heads * hd, cfg.num_kv_heads * hd, cfg.d_ff
    e = (cfg.num_experts,) if cfg.num_experts else ()
    out = [("wq", (L, d, dq)), ("wk", (L, d, dkv)), ("wv", (L, d, dkv)), ("wo", (L, dq, d)),
           ("wgate", (L, *e, d, f)), ("wup", (L, *e, d, f)), ("wdown", (L, *e, f, d))]
    if not cfg.tie_embeddings:
        out.append(("head", (d, cfg.padded_vocab)))
    return out


def selection_kernels(gen, dev, summary, detail, card: str) -> None:
    """``topk_select`` against its plain version, indices and order
    exactly: ragged shapes (d_in 100 / 1536 / 8960, d_out 1 / 127 / 50304),
    k of 1, 2, 7 and 64 and k = d_in on a small matrix, tie-heavy bf16
    stacks (small integers), in bf16 and fp32; then every stack qwen2-1.5b
    (7) and olmoe-1b-7b (8: attention, the three expert stacks, the head)
    select on, bf16 at k = 1, each timed beside the sort, the bound (the
    stack read once, the indices written once) and one ``torch.topk`` of
    |w| (whose order among ties may differ; the port never calls it)."""
    n = 0
    for b, d_in, d_out, ks in ((1, 100, 1, (1, 2, 7, 64, 100)), (3, 1536, 127, (1, 2, 7, 64)),
                               (1, 8960, 256, (1, 7, 64)), (2, 1536, 50304, (1, 2))):
        for dt in (torch.bfloat16, torch.float32):
            w = torch.randn(b, d_in, d_out, generator=gen, device=dev).to(dt)
            for kk in ks:
                got, want = ts_mod.topk_select(w, kk), ts_mod.topk_select_plain(w, kk)
                assert torch.equal(got, want), f"topk_select {(b, d_in, d_out)} {dt} k={kk}"
                n += 1
    for b, d_in, d_out, ks in ((4, 100, 130, (1, 2, 7, 64, 100)), (2, 1536, 256, (1, 7))):
        w = torch.randint(-3, 4, (b, d_in, d_out), generator=gen, device=dev).to(torch.bfloat16)
        for kk in ks:
            assert torch.equal(ts_mod.topk_select(w, kk), ts_mod.topk_select_plain(w, kk)), \
                f"topk_select ties {(b, d_in, d_out)} k={kk}"
            n += 1
    log(f"[kernels] topk_select equal to the sort (indices and order) in {n} ragged and "
        f"tie-heavy cases (d_in 100/1536/8960, d_out 1/127/50304, k 1/2/7/64/d_in)")
    totals = {}
    for arch in ("qwen2-1.5b", MOE_ARCH):
        acc = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0}
        for name, shape in weight_stacks(get_config(arch)):
            w = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
            got, want = ops.topk_select(w, TRAIN_K), ts_mod.topk_select_plain(w, TRAIN_K)
            assert torch.equal(got, want), f"topk_select {arch} {name} {shape}"
            row = {"kernel": "topk_select", "arch": arch, "stack": name, "shape": list(shape),
                   "k": TRAIN_K, "dtype": "torch.bfloat16", "max_abs_err": 0.0,
                   "ms": cuda_ms(lambda: ops.topk_select(w, TRAIN_K)),
                   "plain_ms": cuda_ms(lambda: ts_mod.topk_select_plain(w, TRAIN_K), iters=1,
                                       warmup=1),
                   "library_ms": cuda_ms(lambda: torch.topk(w.abs(), TRAIN_K, dim=-2))}
            nbytes = w.numel() * w.element_size() + got.numel() * 4
            row["bound_ms"], row["bound_by"] = bound(nbytes, 0.0, torch.bfloat16)
            detail.append(row)
            for key in ("ms", "plain_ms", "library_ms"):
                acc[key] += row[key]
            acc["bytes"] += nbytes
            del w, got, want
        acc["bound_ms"], acc["bound_by"] = bound(acc["bytes"], 0.0, torch.bfloat16)
        totals[arch] = acc
        log(f"[kernels] topk_select over {arch}'s {len(weight_stacks(get_config(arch)))} stacks (bf16, "
            f"k={TRAIN_K}, {acc['bytes'] / 1e9:.2f} GB): {acc['ms']:.4f} ms (plain sort "
            f"{acc['plain_ms']:.4f}, torch.topk {acc['library_ms']:.4f}, bound "
            f"{acc['bound_ms']:.4f} by {acc['bound_by']}) [{card}]")
    torch.cuda.empty_cache()
    q, o = totals["qwen2-1.5b"], totals[MOE_ARCH]
    summary["topk_select"] = {
        "source": ts_mod.SOURCE, "replaces": ts_mod.REPLACES, "max_abs_err": 0.0,
        "ms": q["ms"], "plain_ms": q["plain_ms"], "bound_ms": q["bound_ms"],
        "bound_by": q["bound_by"], "library_ms": q["library_ms"],
        "shape": f"qwen2-1.5b's 7 stacks (L = 28) in bf16, k = {TRAIN_K}, one launch each",
        "olmoe": {k: o[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    }


# the smallest-first mode's edge cases (b, d_in, d_out, kind), each in bf16
# and float32, both modes, at every k of SELECT_EDGE_K (9 and 17 take the
# k > 8 passes): d_out 1 / 127 / 300 / 130 / 200 off a block's 64 (bf16) or
# 32 (float32) columns; small integers (ties everywhere); zeros at row 0 and
# every third row of the top half (row 0's zero is the mode's largest key);
# an NF4-dequantized matrix (16 codes a 64-row block)
SELECT_EDGE = ((1, 100, 1, "normal"), (3, 1536, 127, "normal"), (2, 96, 300, "ties"),
               (2, 1536, 200, "zeros"), (2, 1536, 130, "nf4"))
SELECT_EDGE_K = (1, 2, 5, 9, 17)


def select_edge_matrix(gen, b: int, d_in: int, d_out: int, kind: str, dev) -> torch.Tensor:
    w = torch.randn(b, d_in, d_out, generator=gen, device=dev)
    if kind == "ties":
        w = torch.randint(-3, 4, (b, d_in, d_out), generator=gen, device=dev).float()
    elif kind == "zeros":
        w[:, :d_in // 2:3] = 0.0
    elif kind == "nf4":
        w = dequantize(quantize(w, "nf4", QUANT_BLOCK)).float()
    return w


def selection_modes(gen, dev, summary, detail, card: str) -> None:
    """``topk_select`` in the smallest-first mode (the ``reverse``
    strategy) and on float32 scores (the ``gradient`` and ``random``
    strategies' inputs), indices and order equal to the plain version: the
    edge cases of SELECT_EDGE in both modes, then qwen2-1.5b's 7 and
    olmoe-1b-7b's 8 stacks smallest-first in bf16 and qwen2's 7 as float32
    uniforms, each timed beside the plain sort, the bound (the stack read
    once, the indices written once) and one ``torch.topk`` of |w| (the
    port never calls it)."""
    n = 0
    for b, d_in, d_out, kind in SELECT_EDGE:
        base = select_edge_matrix(gen, b, d_in, d_out, kind, dev)
        for dt in (torch.bfloat16, torch.float32):
            w = base.to(dt)
            for kk in SELECT_EDGE_K:
                for largest in (False, True):
                    got = ts_mod.topk_select(w, kk, largest)
                    want = ts_mod.topk_select_plain(w, kk, largest)
                    assert torch.equal(got, want), \
                        f"topk_select {(b, d_in, d_out)} {kind} {dt} k={kk} largest={largest}"
                    n += 1
    log(f"[kernels] topk_select smallest-first and largest-first equal to the sort (indices "
        f"and order) in {n} edge cases (d_out 1/127/300/130/200, k {SELECT_EDGE_K}, ties, "
        f"zeros at row 0, NF4-dequantized; bf16 and float32)")
    modes = {}
    for tag, arch, dt, largest in (("smallest_first", "qwen2-1.5b", torch.bfloat16, False),
                                   ("smallest_first", MOE_ARCH, torch.bfloat16, False),
                                   ("f32_scores", "qwen2-1.5b", torch.float32, True)):
        acc = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0}
        stacks = weight_stacks(get_config(arch))
        for name, shape in stacks:
            if dt == torch.float32:  # uniforms: random's scores (|grad| alike, non-negative)
                w = torch.rand(shape, generator=gen, device=dev)
            else:
                w = torch.randn(shape, generator=gen, device=dev, dtype=dt)
            got = ops.topk_select(w, TRAIN_K, largest)
            want = ts_mod.topk_select_plain(w, TRAIN_K, largest)
            assert torch.equal(got, want), f"topk_select {tag} {arch} {name} {shape}"
            row = {"kernel": "topk_select", "mode": tag, "arch": arch, "stack": name,
                   "shape": list(shape), "k": TRAIN_K, "dtype": str(dt), "max_abs_err": 0.0,
                   "ms": cuda_ms(lambda: ops.topk_select(w, TRAIN_K, largest)),
                   "plain_ms": cuda_ms(lambda: ts_mod.topk_select_plain(w, TRAIN_K, largest),
                                       iters=1, warmup=1),
                   "library_ms": cuda_ms(lambda: torch.topk(w.abs(), TRAIN_K, dim=-2,
                                                            largest=largest))}
            nbytes = w.numel() * w.element_size() + got.numel() * 4
            row["bound_ms"], row["bound_by"] = bound(nbytes, 0.0, dt)
            detail.append(row)
            for key in ("ms", "plain_ms", "library_ms"):
                acc[key] += row[key]
            acc["bytes"] += nbytes
            del w, got, want
        acc["bound_ms"], acc["bound_by"] = bound(acc["bytes"], 0.0, dt)
        modes.setdefault(tag, {})[arch] = {k: acc[k] for k in ("ms", "plain_ms", "bound_ms",
                                                              "bound_by", "library_ms")}
        log(f"[kernels] topk_select {tag.replace('_', '-')} over {arch}'s {len(stacks)} stacks "
            f"({str(dt).split('.')[-1]}, k={TRAIN_K}, {acc['bytes'] / 1e9:.2f} GB): "
            f"{acc['ms']:.4f} ms (plain sort {acc['plain_ms']:.4f}, torch.topk "
            f"{acc['library_ms']:.4f}, bound {acc['bound_ms']:.4f} by {acc['bound_by']}) "
            f"[{card}]")
    torch.cuda.empty_cache()
    summary["topk_select"].update(modes)


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


# decode rows of fused_linear_q (the split-K kernel below ql_mod.SKINNY_ROWS):
# (M, K, N, k, block), every M, K, N, block and k of the ragged set at least
# once; K 4500 and 8960 split in several chunks, blocks 2 and 6 cross steps
SKINNY_CASES = ((1, 78, 48, 0, 2), (3, 4500, 129, 3, 6), (8, 8960, 256, 1, 64),
                (16, 4500, 520, 2, 128), (8, 78, 129, 2, 6), (16, 8960, 48, 0, 2),
                (1, 4500, 520, 1, 64), (3, 8960, 256, 0, 128))


def skinny_cases(gen, dev) -> None:
    """``fused_linear_q`` at decode rows against its plain version: every
    case of SKINNY_CASES, int8 and NF4, bf16 (the split-K kernel, and a
    second call identical bit for bit: the K chunks sum in a fixed order)
    and fp32, bias and none, both value dtypes."""
    counter = COUNTERS["fused_linear_q"]
    counter.reset()
    n_bf16 = 0
    for rm, rk, rn, kk, block in SKINNY_CASES:
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
                        name = (f"fused_linear_q {qd} decode rows M={rm} K={rk} N={rn} k={kk} "
                                f"block={block} {dt}")
                        check_close(name, got, want, dt)
                        if dt == torch.bfloat16:
                            again = ql_mod.fused_linear_q(*args, qdtype=qd, block=block)
                            assert torch.equal(got, again), f"{name}: two calls differ"
                            n_bf16 += 2
    assert counter.routes.get("skinny", 0) == n_bf16 and counter.plain == len(SKINNY_CASES) * 16, \
        counter
    log(f"[kernels] fused_linear_q decode rows ok (split-K kernel, {n_bf16} bf16 launches; M "
        f"1/3/8/16, K 78/4500/8960, N 48/129/256/520, blocks 2/6/64/128, k 0-3; bf16 2e-2, fp32 "
        f"2e-5; two bf16 calls identical bit for bit)")


def old_fused_linear_q(x, qt, idx, val, bias, qd):
    """The tiled WMMA kernel that bf16 took past the decode rows before the
    TMA + wgmma route (now only for shapes TMA cannot describe): called
    directly, timed beside the new route in the same run."""
    m, kd = x.shape
    n = qt.shape[-1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    k = 0 if idx is None else idx.shape[0]

    def run():
        build.check(build.library().rt_fused_linear_q(
            x.data_ptr(), qt.data.data_ptr(), qt.scales.data_ptr(),
            None if idx is None else idx.data_ptr(), None if val is None else val.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(), m, n, kd, k, qt.block,
            0 if qd == "int8" else 1, 1, 1 if val is None or val.dtype == torch.bfloat16 else 0,
            torch.cuda.current_stream().cuda_stream), "fused_linear_q (tiled)")
        return y
    return run


# (M, K, N, k, block): rows, columns and K off every tile. K 78 and 1002
# and N 129 and 264 take the tiled WMMA kernel (K = 1002 leaves NF4 an odd
# 21 packed rows in its last tile: the TMA route's K % 8 == 0 never does),
# the rest past the decode rows the TMA + wgmma one: blocks 48 and 2 cross
# K tiles (scale rows from global memory), K = 1064 leaves 20 packed rows in
# the last tile, N = 48 one column chunk, M = 2047 a 63-row last tile
PACKED_EDGE = ((130, 78, 129, 2, 32), (7, 4500, 520, 3, 128), (200, 1000, 264, 0, 6),
               (33, 96, 48, 1, 2), (130, 1000, 256, 1, 48), (2047, 1064, 272, 2, 64),
               (200, 1000, 48, 0, 2), (130, 1002, 256, 1, 2))


def packed_kernels(gen, projections, dev, summary, detail, card: str) -> None:
    """``fused_linear_q`` (int8 and NF4) against its plain version: edge
    shapes first (row, column and K tails, scale blocks that cross K tiles,
    k 0-3; each launch on the route ``quant_linear.route`` names, two bf16
    calls identical bit for bit), then every projection at the training
    rows (M = batch x seq, bypass k = 1, qkv bias; also timed at k = 0 and
    on the tiled WMMA kernel) and at the decode
    rows (M = slots, no bypass: the serving base matmul), bf16 and fp32; the
    bf16 calls timed and summed over the layer's 7 projections per (scheme,
    M)."""
    counter = COUNTERS["fused_linear_q"]
    for rm, rk, rn, kk, block in PACKED_EDGE:
        for qd in PACKED:
            for dt in (torch.bfloat16, torch.float32):
                w = torch.randn(rk, rn, generator=gen, device=dev) * rk**-0.5
                qt = quantize(w.to(dt), qd, block)
                x = torch.randn(rm, rk, generator=gen, device=dev).to(dt)
                b = torch.randn(rn, generator=gen, device=dev).to(dt)
                idx = torch.randint(0, rk, (kk, rn), generator=gen, device=dev,
                                    dtype=torch.int32) if kk else None
                want_route = ql_mod.route(rm, rk, rn, dt, (x.data_ptr(), qt.data.data_ptr(),
                                                           qt.scales.data_ptr()))
                for vdt in (torch.bfloat16, torch.float32):
                    val = (torch.randn(kk, rn, generator=gen, device=dev) * 0.05).to(vdt) \
                        if kk else None
                    for bias in (b, None):
                        args = (x, qt.data, qt.scales, idx, val, bias)
                        counter.reset()
                        got = ql_mod.fused_linear_q(*args, qdtype=qd, block=block)
                        want = ql_mod.fused_linear_q_plain(*args, qdtype=qd, block=block)
                        torch.cuda.synchronize()
                        name = (f"fused_linear_q {qd} edge M={rm} K={rk} N={rn} k={kk} "
                                f"block={block} {dt}")
                        check_close(name, got, want, dt)
                        expect_route(counter, want_route, 1, name)
                        if dt == torch.bfloat16:
                            again = ql_mod.fused_linear_q(*args, qdtype=qd, block=block)
                            assert torch.equal(got, again), f"{name}: two calls differ"
    log("[kernels] fused_linear_q ok on edge shapes, int8 and NF4 (M 7/33/130/200/2047, "
        "K 78/96/1000/1002/1064/4500, N 48/129/256/264/272/520, blocks 2/6/32/48/64/128, k 0-3; "
        "each on the route quant_linear.route names: wgmma, tiled or f32; bf16 2e-2, fp32 "
        "2e-5; two bf16 calls identical bit for bit)")
    skinny_cases(gen, dev)
    m_train, m_dec = TRAIN_BATCH * TRAIN_SEQ, SLOTS
    cases = {}
    for qd in PACKED:
        for m in (m_train, m_dec):
            acc = {"ms": 0.0, "plain_ms": 0.0, "lib": 0.0, "bytes": 0.0, "flops": 0.0,
                   "err": 0.0, "k0_ms": 0.0, "old_ms": 0.0}
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
                    counter.reset()
                    got, want = fn(), plain()
                    torch.cuda.synchronize()
                    err = check_close(f"fused_linear_q {qd} {name} M={m}", got, want, dt)
                    route = ("f32" if dt == torch.float32 else
                             "skinny" if m == m_dec else "wgmma")
                    expect_route(counter, route, 1, f"fused_linear_q {qd} {name} M={m}")
                    if dt == torch.bfloat16:
                        assert torch.equal(got, fn()), f"fused_linear_q {qd} {name}: two calls differ"
                    row = {"kernel": "fused_linear_q", "qdtype": qd, "proj": name, "M": m,
                           "K": d_in, "N": d_out, "k": k, "bias": bias is not None,
                           "dtype": str(dt), "route": route, "max_abs_err": err}
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
                        if m == m_train:  # the bypass's share, the tiled kernel
                            row["k0_ms"] = cuda_ms(lambda: ql_mod.fused_linear_q(
                                x, qt.data, qt.scales, None, None, bias, qdtype=qd,
                                block=QUANT_BLOCK))
                            row["old_ms"] = cuda_ms(old_fused_linear_q(x, qt, idx, val, bias, qd))
                            for key in ("k0_ms", "old_ms"):
                                acc[key] += row[key]
                        for key, v in (("ms", row["ms"]), ("plain_ms", row["plain_ms"]),
                                       ("lib", row["library_ms"]), ("bytes", cost[0]),
                                       ("flops", cost[1])):
                            acc[key] += v
                        acc["err"] = max(acc["err"], err)
                    detail.append(row)
            b_ms, b_by = bound(acc["bytes"], acc["flops"], torch.bfloat16)
            case = {"ms": acc["ms"], "plain_ms": acc["plain_ms"], "library_ms": acc["lib"],
                    "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": acc["err"],
                    "launch_route": "wgmma" if m == m_train else "skinny"}
            extra = ""
            if m == m_train:
                case.update(k0_ms=acc["k0_ms"], old_ms=acc["old_ms"])
                extra = f", k=0 {acc['k0_ms']:.4f}, tiled WMMA kernel {acc['old_ms']:.4f}"
            cases[f"{qd} M={m}"] = case
            log(f"[kernels] fused_linear_q {qd} one layer at M={m} (k={TRAIN_K if m == m_train else 0}, "
                f"{case['launch_route']} route): {acc['ms']:.4f} ms (plain {acc['plain_ms']:.4f}, "
                f"torch.mm dense bf16 part {acc['lib']:.4f}{extra}, bound {b_ms:.4f} by {b_by}); "
                f"max|err| bf16 {acc['err']:.3e} [{card}]")
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
        f"M={m_train} on the wgmma route and M={m_dec} on the split-K route; two bf16 calls "
        f"identical bit for bit) [{card}]")


# positions of the 8 slots at a speculative round of the full-width gate runs
# (prompts of 40-700 tokens, a few rounds in), the frontiers the four spec
# shapes below are held at
SPEC_POS = [45, 706, 137, 262, 517, 70, 306, 626]


def spec_kernels(gen, projections, dev, summary, detail, card: str, num_blocks: int) -> None:
    """The four kernels of a speculative round at the shapes it gives them,
    against their plain versions, timed beside their bounds and (where
    there is one) a one-call PyTorch yardstick: the verify's bypass apply
    with the serving epilogue at M = slots x (spec_k + 1) = 40 rows, 5 a
    tenant id (route ``rows-fused``); the paged prefill with a verify chunk
    of C = 5 columns (one slot cut to 3 at its cache's end, one idle; SDPA
    on the pre-gathered cache as the yardstick); ``fused_linear_q`` int8 and
    NF4 at M = 40 (a verify on a packed base, no bypass; ``wgmma``;
    ``torch.mm`` on the dense weight); the dense decode attention on a model
    drafter's scratch (the (slots + 1, max_len, 2, 128) bf16 cache without
    its trash slot; ``ring``; SDPA). Each lands under its kernel's row as
    ``spec``."""
    sms = dec_mod.sm_count(dev)
    c = SPEC_K + 1

    # -- the verify's apply: 7 projections, bf16, one id a slot, the epilogue
    counter = COUNTERS["sparse_delta_batched"]
    acc = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "flops": 0.0, "err": 0.0}
    for name, d_in, d_out in projections:
        x, idx, val, aid = delta_case(gen, SPEC_ROWS, d_in, d_out, torch.bfloat16,
                                      torch.bfloat16, dev)
        seq = aid[::c].contiguous()
        y0 = torch.randn(SPEC_ROWS, d_out, generator=gen, device=dev).to(torch.bfloat16)
        bias = (torch.randn(d_out, generator=gen, device=dev).to(torch.bfloat16)
                if name in ("wq", "wk", "wv") else None)
        assert sd_mod.delta_plan(SPEC_ROWS, d_in, d_out, 2, sms).route == "rows"
        counter.reset()
        got = sd_mod.sparse_delta_batched(x, idx, val, seq, c)
        fused = sd_mod.sparse_delta_batched(x, idx, val, seq, c, y0.clone(), bias)
        want = sd_mod.sparse_delta_batched_plain(x, idx, val, aid)
        torch.cuda.synchronize()
        what = f"sparse_delta spec {name} M={SPEC_ROWS}"
        err = check_close(what, got, want, torch.bfloat16)
        three = y0 + got if bias is None else y0 + got + bias
        assert torch.equal(fused, three), f"{what}: the epilogue differs from the adds"
        assert counter.routes == {"rows": 1, "rows-fused": 1}, (what, counter.routes)
        yb = y0.clone()
        ms = cuda_ms(lambda: sd_mod.sparse_delta_batched(x, idx, val, seq, c, yb, bias))
        plain_ms = cuda_ms(lambda: sd_mod.sparse_delta_batched_plain(x, idx, val, aid), iters=3)
        nbytes, flops = delta_cost(x, idx, val, aid, d_out)
        nbytes += SPEC_ROWS * d_out * 2 + (0 if bias is None else d_out * 2)  # y (and bias) read
        detail.append({"kernel": "sparse_delta_batched", "spec": True, "proj": name,
                       "M": SPEC_ROWS, "rows_per_id": c, "route": "rows-fused",
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bytes", nbytes), ("flops", flops)):
            acc[key] += v
        acc["err"] = max(acc["err"], err)
    b_ms, b_by = bound(acc["bytes"], acc["flops"], torch.bfloat16)
    summary["sparse_delta_batched"]["spec"] = dict(
        shape=f"7 projections of one layer, M={SPEC_ROWS} bf16 rows ({c} an id), k={K_DELTA}, "
              f"N={N_TENANTS + 1}, with the serving epilogue",
        max_abs_err=acc["err"], ms=acc["ms"], plain_ms=acc["plain_ms"], bound_ms=b_ms,
        bound_by=b_by, library_ms=None, launch_route="rows-fused")
    log(f"[kernels] spec sparse_delta_batched one layer at M={SPEC_ROWS} ({c} rows an id, "
        f"rows-fused): {acc['ms']:.4f} ms (plain {acc['plain_ms']:.4f}, bound {b_ms:.4f} by "
        f"{b_by}); max|err| {acc['err']:.3e}; the epilogue bit for bit [{card}]")

    # -- the verify chunk through the paged prefill, bf16 (and fp32 checked)
    q_len = [c, c, 3, c, 0, c, c, c]
    for dt in (torch.float32, torch.bfloat16):  # the bf16 case last: it is timed
        qb, kb, vb, table, qoff, vl = paged_case(gen, SPEC_POS, q_len, c, dt, dev, num_blocks)
        readings = check_prefill("paged_prefill_attention spec", qb, kb, vb, table, qoff, vl)
        detail.append({"kernel": "paged_prefill_attention", "spec": True, "dtype": str(dt),
                       "q_offset": SPEC_POS, "q_len": q_len, **readings})
    ms = cuda_ms(lambda: pre_mod.paged_prefill_attention(qb, kb, vb, table, qoff, vl))
    plain_ms = cuda_ms(lambda: pre_mod.paged_prefill_attention_plain(qb, kb, vb, table, qoff, vl),
                       iters=3)
    mask = prefill_mask(qoff, vl, table, dev, c)
    lib = cuda_ms(sdpa_yardstick(qb, kb, vb, table, mask))
    b_ms, b_by = bound(*prefill_cost(qb, kb, table, qoff, vl, mask), torch.bfloat16)
    err = max(r["max_abs_err"] for r in detail[-2:])
    summary["paged_prefill_attention"]["spec"] = dict(
        shape=f"q ({SLOTS},{c},12,128) bf16, pool ({num_blocks},16,2,128), q_offset {SPEC_POS}, "
              f"q_len {q_len}", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib)
    log(f"[kernels] spec paged_prefill_attention at C={c}: {ms:.4f} ms (plain {plain_ms:.4f}, "
        f"sdpa {lib:.4f}, bound {b_ms:.5f} by {b_by}); max|err| {err:.3e} [{card}]")

    # -- fused_linear_q at the verify's rows on a packed base, no bypass
    counter = COUNTERS["fused_linear_q"]
    for qd in PACKED:
        acc = {"ms": 0.0, "plain_ms": 0.0, "lib": 0.0, "bytes": 0.0, "flops": 0.0, "err": 0.0}
        for name, d_in, d_out in projections:
            wd = (torch.randn(d_in, d_out, generator=gen, device=dev) * d_in**-0.5).bfloat16()
            qt = quantize(wd, qd, QUANT_BLOCK)
            x = torch.randn(SPEC_ROWS, d_in, generator=gen, device=dev).bfloat16()
            fn = lambda: ql_mod.fused_linear_q(x, qt.data, qt.scales, qdtype=qd,  # noqa: E731
                                               block=QUANT_BLOCK)
            plain = lambda: ql_mod.fused_linear_q_plain(x, qt.data, qt.scales, qdtype=qd,  # noqa: E731
                                                        block=QUANT_BLOCK)
            counter.reset()
            got, want = fn(), plain()
            torch.cuda.synchronize()
            what = f"fused_linear_q spec {qd} {name} M={SPEC_ROWS}"
            err = check_close(what, got, want, torch.bfloat16)
            expect_route(counter, "wgmma", 1, what)
            assert torch.equal(got, fn()), f"{what}: two calls differ"
            row = {"kernel": "fused_linear_q", "spec": True, "qdtype": qd, "proj": name,
                   "M": SPEC_ROWS, "route": "wgmma", "max_abs_err": err, "ms": cuda_ms(fn),
                   "plain_ms": cuda_ms(plain, iters=3),
                   "library_ms": cuda_ms(lambda: torch.mm(x, wd))}
            detail.append(row)
            nbytes, flops = packed_cost(x, qt, 0, None, None)
            for key, v in (("ms", row["ms"]), ("plain_ms", row["plain_ms"]),
                           ("lib", row["library_ms"]), ("bytes", nbytes), ("flops", flops)):
                acc[key] += v
            acc["err"] = max(acc["err"], err)
        b_ms, b_by = bound(acc["bytes"], acc["flops"], torch.bfloat16)
        summary["fused_linear_q"].setdefault("spec", {})[qd] = dict(
            shape=f"7 projections of one layer, {qd} base (block {QUANT_BLOCK}), M={SPEC_ROWS} "
                  f"bf16 rows, no bypass", max_abs_err=acc["err"], ms=acc["ms"],
            plain_ms=acc["plain_ms"], bound_ms=b_ms, bound_by=b_by, library_ms=acc["lib"],
            launch_route="wgmma")
        log(f"[kernels] spec fused_linear_q {qd} one layer at M={SPEC_ROWS} (wgmma): "
            f"{acc['ms']:.4f} ms (plain {acc['plain_ms']:.4f}, torch.mm dense bf16 "
            f"{acc['lib']:.4f}, bound {b_ms:.4f} by {b_by}); max|err| {acc['err']:.3e} [{card}]")

    # -- the drafter's step: dense decode over its scratch (trash slot cut)
    cfg = get_config("qwen2-1.5b")
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    vl = torch.tensor([p + 2 for p in SPEC_POS], dtype=torch.int32, device=dev)
    vl[4] = 0  # an idle slot reads nothing
    q = torch.randn(SLOTS, 1, h, hd, generator=gen, device=dev).bfloat16()
    scratch = torch.randn(2, SLOTS + 1, MAX_LEN, hkv, hd, generator=gen, device=dev).bfloat16()
    k, v = scratch[0, :SLOTS], scratch[1, :SLOTS]
    counter = COUNTERS["decode_attention"]
    counter.reset()
    got = dd_mod.decode_attention(q, k, v, vl)
    want = dd_mod.decode_attention_plain(q, k, v, vl)
    torch.cuda.synchronize()
    err = check_close("decode_attention spec", got, want, torch.bfloat16)
    expect_route(counter, dec_mod.ROUTE, 1, "decode_attention spec")
    ms = cuda_ms(lambda: dd_mod.decode_attention(q, k, v, vl))
    plain_ms = cuda_ms(lambda: dd_mod.decode_attention_plain(q, k, v, vl), iters=3)
    rows = int(vl.sum())
    nbytes = (int((vl > 0).sum()) * h * hd * 2 + 2 * rows * hkv * hd * 2 + 4 * SLOTS
              + q.numel() * 2)
    b_ms, b_by = bound(nbytes, 4.0 * rows * h * hd, torch.bfloat16)
    mask = (torch.arange(MAX_LEN, device=dev)[None, :] < vl[:, None])[:, None, None, :]
    kt = k.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous()
    qt = q.transpose(1, 2).contiguous()
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
    summary["decode_attention"]["spec"] = dict(
        shape=f"q ({SLOTS},1,12,128) bf16, a drafter's scratch ({SLOTS + 1},{MAX_LEN},2,128) "
              f"without its trash slot, kv_valid_len {vl.tolist()}", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        launch_route=dec_mod.ROUTE)
    detail.append({"kernel": "decode_attention", "spec": True, "kv_valid_len": vl.tolist(),
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    log(f"[kernels] spec decode_attention on a drafter's scratch: {ms:.4f} ms (plain "
        f"{plain_ms:.4f}, sdpa {lib:.4f}, bound {b_ms:.5f} by {b_by}); max|err| {err:.3e} "
        f"[{card}]")


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
    """Every forward of ``model`` (mixed chunk, decode step, verify chunk,
    a drafter's chunk), every token draw and distribution, and the whole
    device half of a speculative megastep (``ServeEngine._spec_rounds``:
    the drafter's steps, the verify, the accept rule, the ngram lookup)
    run under ``torch.cuda.set_sync_debug_mode("error")``: one that waits
    for the device (``.item()``, a device-to-host copy, ``bincount``'s
    range read) raises, so the engine's fetch stays a step's only
    transfer."""
    def guarded(fn):
        def call(*args, **kw):
            before = torch.cuda.get_sync_debug_mode()  # nested guards restore it
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(before)
        return call

    try:  # the mode must catch what it is here for
        guarded(torch.bincount)(torch.zeros(1, dtype=torch.int64, device="cuda"))
    except RuntimeError:
        pass
    else:
        raise AssertionError("sync debug mode let bincount's host read through")
    names = ("prefill_chunk", "decode_step", "verify_chunk", "ingest_chunk")
    classes = ((Sampler, "__call__"), (Sampler, "probs"), (ServeEngine, "_spec_rounds"))
    saved = [getattr(cls, name) for cls, name in classes]
    for name in names:
        setattr(model, name, guarded(getattr(model, name)))
    for (cls, name), fn in zip(classes, saved):
        setattr(cls, name, guarded(fn))
    try:
        yield
    finally:
        for name in names:
            delattr(model, name)
        for (cls, name), fn in zip(classes, saved):
            setattr(cls, name, fn)


def engine_for(model, params, tenants, prompts, max_new, device, **kw):
    """An engine with ``tenants`` registered and ``prompts`` submitted, the
    requests cycling over the base and the tenants."""
    store = AdapterStore(base_params=params)
    for i, (idx, val) in enumerate(tenants):
        store.register(idx, val, name=f"tenant{i + 1}")
    eng = ServeEngine(model, params, adapter_store=store, device=device, **kw)
    for i, p in enumerate(prompts):
        eng.submit(p, max_new=max_new, adapter_id=i % (len(tenants) + 1))
    return eng


def serve(model, params, tenants, prompts, max_new, device, **kw):
    eng = engine_for(model, params, tenants, prompts, max_new, device, **kw)
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
    # every projection of a layer-forward (7 dense; 4 attention on MoE, whose
    # expert stacks dequantize per call) and an untied head once a forward
    per_fwd = 4 if cfg.num_experts else 7
    heads = 0 if cfg.tie_embeddings else forwards // cfg.num_layers
    assert n_q == (per_fwd * forwards + heads if base in PACKED else 0), (base, n_q, forwards)
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


def gate_inputs() -> tuple:
    """The gate run's model, weights (seed 0), 3 tenants (seed 7), 10
    prompts of 40-700 tokens, max_new and engine settings."""
    cfg = get_config("qwen2-1.5b")
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    tenants = random_tenants(params, N_TENANTS, seed=7, dtype=torch.bfloat16,
                             device="cuda")
    torch.cuda.synchronize()
    log(f"[full] qwen2-1.5b bf16 init + {N_TENANTS} tenants: "
        f"{time.perf_counter() - t0:.1f} s")
    return model, params, tenants, gate_prompts(cfg.vocab_size), 32, gate_kw()


def gate_prompts(vocab: int) -> list:
    """The gate run's 10 prompts of 40-700 tokens (seed 11)."""
    rng = np.random.default_rng(11)
    lens = [40, 700, 130, 256, 511, 64, 300, 620, 90, 410]
    return [rng.integers(3, vocab, size=n).tolist() for n in lens]


def gate_kw() -> dict:
    return dict(slots=SLOTS, max_len=MAX_LEN, prefill_chunk=PREFILL_CHUNK,
                decode_chunk=DECODE_CHUNK, page_size=PAGE)


def phase_full(card: str) -> tuple:
    model, params, tenants, prompts, max_new, kw = gate_inputs()
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
    decode_routes("full")
    # decode steps (M = slots rows) on the rows route, mixed steps (M = slots
    # x chunk) on the tiles route, 7 projections a layer-forward
    apply_by_route = apply_routes("full", 7, forwards_of(eng))
    assert apply_by_route == {"rows-fused": 7 * launches["paged_decode_attention"],
                              "tiles-fused": 7 * launches["paged_prefill_attention"]}, \
        apply_by_route
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
    counted = [host_ops(lambda: serve(model, params, tenants, prompts, max_new, "cuda", **kw))
               for _ in range(2)]
    (n_ops, tally, _), (n_again, again, _) = counted
    moved = {k: (tally.get(k, 0), again.get(k, 0)) for k in set(tally) | set(again)
             if tally.get(k, 0) != again.get(k, 0)}
    assert not moved, f"two counts of the gate run's host operations differ: {moved}"
    forwards = forwards_of(peng)
    log(f"[full] gate run: {n_ops} host operations, twice, op by op the same ({n_ops / forwards:.4f} "
        f"a layer-forward: {n_ops - sum(COUNTERS[n].kernel for n in SERVING)} ATen operations "
        f"and {json.dumps({n: COUNTERS[n].kernel for n in SERVING})} hand-written launches; "
        f"pinned at {GATE_OPS}); the profile recorded {n_launch} device operations "
        f"({n_launch / forwards:.2f} a layer-forward, a lower bound) [{card}]")
    with open(os.path.join(OUT_DIR, "gate_ops.json"), "w") as f:
        json.dump({"card": card, "host_ops": n_ops, "by_op": tally}, f, indent=1)
    assert n_ops == GATE_OPS, (n_ops, GATE_OPS)
    off_outs = [r.out for r in reqs]
    launches["spec"] = phase_full_spec(model, params, tenants, prompts, max_new, kw, card,
                                       off_outs)
    phase_window(model, params, tenants, card, kw)
    for paged, kv_dtype in KV_CONFIGS:
        launches.update(phase_full_kv(model, params, tenants, prompts, max_new, kw, card, paged,
                                      kv_dtype))
    packed = {qd: phase_full_packed(model, params, tenants, prompts, max_new, kw, card, qd)
              for qd in PACKED}
    launches["apply_by_route"] = apply_by_route
    gate = dict(model=model, params=params, tenants=tenants, prompts=prompts,
                max_new=max_new, kw=kw, tally=tally, off_outs=off_outs)
    return launches, packed, gate


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
    decode_routes(f"full-{name}")
    apply_routes(f"full-{name}", 7, forwards_of(eng))
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
    # decode steps (M = slots rows) on the split-K kernel, mixed steps (M = 8
    # slots x 256 rows) on the TMA + wgmma one
    routes = COUNTERS["fused_linear_q"].routes
    assert routes == {"skinny": 7 * n["paged_decode_attention"],
                      "wgmma": 7 * n["paged_prefill_attention"]}, routes
    decode_routes(f"full-{qd}")
    assert apply_routes(f"full-{qd}", 7, forwards) == {
        "rows-fused": 7 * n["paged_decode_attention"],
        "tiles-fused": 7 * n["paged_prefill_attention"]}
    assert n["fused_linear"] == 0, n
    for r in reqs:
        assert r.done and r.reason in ("eos", "max_new"), (r.rid, r.reason, len(r.out))
    assert eng.transfers == eng.steps, (eng.transfers, eng.steps)
    assert eng.kv.drained(), "block pool not fully free after the run"
    n_tok = sum(len(r.out) for r in reqs)
    log(f"[full-{qd}] {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s: {n_tok / wall:.1f} "
        f"tok/s; steps {eng.steps}; launches {json.dumps(n)} (fused_linear_q = 7 x "
        f"{forwards} layer-forwards: {json.dumps(routes)}), plain 0 [{card}]")
    profile_run(lambda: serve(model, packed, tenants, prompts, max_new, "cuda", base_dtype=qd,
                              quant_block=QUANT_BLOCK, **kw),
                card, f"profile-{qd}", f"full_profile_{qd}.txt")
    phase_window(model, packed, tenants, card, dict(kw, base_dtype=qd, quant_block=QUANT_BLOCK),
                 repeats=1, tag=f"window-{qd}", fname=f"window_{qd}.json",
                 extra={"base_dtype": qd, "base_bytes": base_bytes})
    return n["fused_linear_q"]


# a longer, decode-dominated window: the run above is a smoke figure (20
# steps); tokens/s and step times are taken here. One run of 64 new tokens a
# request: the speculative window's draft="off" run serves the same window
# in the same call, and the short run keeps the script's time
WINDOW_REQUESTS, WINDOW_NEW, WINDOW_REPEATS = 16, 64, 1


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


# ----------------------------------------------------- speculative decoding


@contextlib.contextmanager
def launch_shapes():
    """Tally the shape every launch of the four kernels a speculative round
    reaches was given (the paged prefill's q, the apply's rows and rows a
    tenant id, the dense decode's q and cache, the packed linear's rows),
    by wrapping the names ``kernels.ops`` calls them through."""
    seen = {"prefill": {}, "apply": {}, "decode": {}, "linear_q": {}}
    sites = ((ops, "_prefill", "prefill", lambda q, *a: tuple(q.shape)),
             (ops, "sparse_delta_batched", "apply", lambda x, i, v, aid, rpi, *a: (x.shape[0], rpi)),
             (ops, "_dense_decode", "decode", lambda q, k, *a: (tuple(q.shape), tuple(k.shape))),
             (ql_mod, "fused_linear_q", "linear_q", lambda x, *a, **kw: x.shape[0]))
    real = [getattr(mod, name) for mod, name, _, _ in sites]

    def tally(fn, key, shape_of):
        def call(*args, **kw):
            shape = shape_of(*args, **kw)
            seen[key][shape] = seen[key].get(shape, 0) + 1
            return fn(*args, **kw)
        return call

    for (mod, name, key, shape_of), fn in zip(sites, real):
        setattr(mod, name, tally(fn, key, shape_of))
    try:
        yield seen
    finally:
        for (mod, name, _, _), fn in zip(sites, real):
            setattr(mod, name, fn)


def spec_forwards(eng) -> dict:
    """A run's forwards. ``per_token``: a slot's forwards for each token its
    decode or spec steps emitted, the reckoning's unit (plain decode 1; a
    spec round one verify row, and for a model drafter spec_k + 1 drafter
    steps, for 1 + a tokens). ``passes_per_token``: whole-batch passes over
    those tokens (every round of a megastep runs, live slots or not).
    ``served`` / ``drafter``: whole-batch passes of the served model (a
    mixed step, a decode step or a verify round each) and of a model
    drafter (its head-free chunk steps not counted)."""
    st, r, k = eng.step_times, eng.decode_chunk, eng.spec_k
    kind = "spec" if eng.draft != "off" else "decode"
    emitted = eng.emitted[kind]
    per_round = 1 + (k + 1 if eng.draft_kv is not None else 0)
    slot_rounds = eng.spec_drafted / k if kind == "spec" else emitted
    batch = r * len(st[kind])
    return {"served": len(st["mixed"]) + batch, "drafter": batch * (per_round - 1),
            "emitted": emitted, "per_token": per_round * slot_rounds / max(emitted, 1),
            "passes_per_token": batch * per_round / max(emitted, 1)}


def phase_reduced_spec() -> None:
    """Reduced qwen2-1.5b in fp32, two tenants, the same prompts for every
    drafter on the paged pool and on the dense cache: greedy tokens on the
    card identical to draft="off" on the card and to the CPU run's under
    the same drafter, with the CPU's drafted and accepted counts (a drafter
    gone wrong would keep the tokens and lose acceptance), one transfer a
    step, the cache drained, no plain version called on the card."""
    cfg = reduced(get_config("qwen2-1.5b")).replace(dtype="float32")
    model = get_model(cfg)
    params_cpu = model.init(seed=0, device="cpu")
    tenants_cpu = random_tenants(params_cpu, 2, seed=5, dtype=torch.float32, device="cpu")
    to_cuda = lambda t: map_leaves(lambda x: None if x is None else x.cuda(), t)  # noqa: E731
    params, tenants = to_cuda(params_cpu), [(to_cuda(i), to_cuda(v)) for i, v in tenants_cpu]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist() for n in (5, 37, 12, 70, 3)]
    for paged in (True, False):
        kw = dict(slots=3, max_len=128, prefill_chunk=16, decode_chunk=4, eos_id=1 << 20,
                  paged=paged, spec_k=SPEC_K)
        _, off = serve(model, params, tenants, prompts, 10, "cuda", **kw)
        off = [r.out for r in off]
        rates = {}
        for draft in SPEC_DRAFTERS:
            ceng, want = serve(model, params_cpu, tenants_cpu, prompts, 10, "cpu", draft=draft,
                               **kw)
            reset_counters()
            eng, got = serve(model, params, tenants, prompts, 10, "cuda", draft=draft, **kw)
            where = f"reduced spec {draft} {'paged' if paged else 'dense'}"
            assert [r.out for r in got] == [r.out for r in want], f"{where}: cuda != cpu"
            assert (eng.spec_drafted, eng.spec_accepted) == (ceng.spec_drafted,
                                                             ceng.spec_accepted), where
            assert [r.out for r in got] == off, f"{where}: != draft='off'"
            assert all(c.plain == 0 for c in COUNTERS.values()), f"{where}: a plain call"
            assert eng.transfers == eng.steps and eng.kv.drained(), where
            rates[draft] = f"{eng.spec_accepted}/{eng.spec_drafted}"
        log(f"[reduced-spec-{'paged' if paged else 'dense'}] greedy tokens identical for "
            f"{', '.join(SPEC_DRAFTERS)} on cuda (kernels), on cpu (plain) and draft='off' on "
            f"cuda: {len(prompts)} requests, {sum(map(len, off))} tokens; accepted/drafted "
            f"{json.dumps(rates)}; one transfer a step, cache drained, plain 0")


def bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def divergence_gaps(model, eng, reqs, off_outs, prompts) -> list:
    """For each request whose greedy tokens differ from draft="off"'s:
    prompt + the common prefix teacher-forced through ``prefill_chunk`` on
    a one-slot dense cache (the request's tenant), and the logits there of
    the two tokens the runs chose, against the top logit. Returns (rid,
    index, top-2 gap, the gap in bf16 ulps of the top logit, both tokens
    within SPEC_TIE_ULPS ulps of the top)."""
    out = []
    for r, want in zip(reqs, off_outs):
        if r.out == want:
            continue
        i = next((j for j, (a, b) in enumerate(zip(r.out, want)) if a != b), None)
        if i is None:  # one stopped earlier: EOS where the other did not
            i = min(len(r.out), len(want))
        toks = prompts[r.rid] + want[:i]
        cache = model.init_cache(1, MAX_LEN, "cuda")
        n = len(toks)
        batch = {"tokens": torch.tensor([toks], dtype=torch.int32, device="cuda"),
                 "q_offset": torch.zeros(1, dtype=torch.int32, device="cuda"),
                 "q_len": torch.tensor([n], dtype=torch.int32, device="cuda"),
                 "last_idx": torch.tensor([n - 1], dtype=torch.int32, device="cuda")}
        adapters = eng._adapters(np.array([r.adapter_id], np.int32))
        lg = model.prefill_chunk(eng.params, adapters, cache, batch)[0, :model.cfg.vocab_size]
        lg = lg.float().cpu()
        top2 = torch.topk(lg, 2).values.tolist()
        ulp = bf16_ulp(top2[0])
        pair = [t for t in (r.out[i] if i < len(r.out) else None,
                            want[i] if i < len(want) else None) if t is not None]
        near = all(top2[0] - float(lg[t]) <= SPEC_TIE_ULPS * ulp for t in pair)
        out.append((r.rid, i, top2[0] - top2[1], (top2[0] - top2[1]) / ulp, near))
    return out


def phase_full_spec(model, params, tenants, prompts, max_new, kw, card: str,
                    off_outs) -> dict:
    """Full-width qwen2-1.5b in bf16 with phase 5's tenants, prompts and
    settings, speculative with spec_k = SPEC_K on the paged bf16 pool: the
    gate run for each drafter of SPEC_GATE (every request ends, only the
    path's kernels and no plain version, one transfer a step with every
    forward and the rounds' device half under the sync guard, the pool
    drains; routes: the verify's applies ``rows-fused`` at M = 40, the
    mixed steps' ``tiles-fused``; the prefill kernel at C = 5 for every
    verify; a model drafter's decode attention on ``ring`` over its
    scratch; the int8 drafter's linears ``skinny`` at its steps), its greedy
    tokens held against draft="off"'s (identical, or diverged at a stated
    near-tie of the teacher-forced logits), one profiled ngram gate run,
    then the window with off, ngram, int8 and merged in turn. Returns the
    gate runs' launches of the four spec-path kernels by drafter."""
    cfg = model.cfg
    L, H, KV, hd = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    kw = dict(kw, spec_k=SPEC_K)
    launches = {}
    for draft in SPEC_GATE:
        serve(model, params, tenants, prompts[:2], 2, "cuda", draft=draft, **kw)  # warm-up
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        with forwards_never_wait(model), launch_shapes() as shapes:
            eng, reqs = serve(model, params, tenants, prompts, max_new, "cuda", draft=draft, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tag = f"full-spec-{draft}"
        n = {name: c.kernel for name, c in COUNTERS.items()}
        for name, c in COUNTERS.items():
            assert c.plain == 0, f"{tag}: the plain version of {name} ran {c.plain} times"
        mixed, spec = len(eng.step_times["mixed"]), len(eng.step_times["spec"])
        assert spec > 0 and not eng.step_times["decode"], eng.step_times
        rounds, model_drafter = DECODE_CHUNK * spec, draft != "ngram"
        c = SPEC_K + 1
        want_n = {"paged_prefill_attention": L * (mixed + rounds),
                  "sparse_delta_batched": 7 * L * (mixed + rounds),
                  "decode_attention": L * c * rounds if model_drafter else 0,
                  "fused_linear_q": ((7 * L * c * rounds + (7 * (L - 1) + 3) * mixed)
                                     if draft in PACKED else 0)}
        assert {k: n[k] for k in want_n} == want_n, (tag, n, want_n)
        assert all(v == 0 for k, v in n.items() if k not in want_n), (tag, n)
        apply = dict(COUNTERS["sparse_delta_batched"].routes)
        assert apply == {"tiles-fused": 7 * L * mixed, "rows-fused": 7 * L * rounds}, apply
        assert shapes["apply"] == {(SLOTS * PREFILL_CHUNK, PREFILL_CHUNK): 7 * L * mixed,
                                   (SPEC_ROWS, c): 7 * L * rounds}, shapes["apply"]
        assert shapes["prefill"] == {(SLOTS, PREFILL_CHUNK, H, hd): L * mixed,
                                     (SLOTS, c, H, hd): L * rounds}, shapes["prefill"]
        if model_drafter:
            expect_route(COUNTERS["decode_attention"], dec_mod.ROUTE, want_n["decode_attention"],
                         f"{tag}: the drafter's decode attention")
            assert shapes["decode"] == {((SLOTS, 1, H, hd), (SLOTS, MAX_LEN, KV, hd)):
                                        want_n["decode_attention"]}, shapes["decode"]
        if draft in PACKED:
            assert COUNTERS["fused_linear_q"].routes == {
                "skinny": 7 * L * c * rounds, "wgmma": (7 * (L - 1) + 3) * mixed}, \
                COUNTERS["fused_linear_q"].routes
            assert shapes["linear_q"] == {SLOTS: 7 * L * c * rounds,
                                          SLOTS * PREFILL_CHUNK: (7 * (L - 1) + 3) * mixed}
        for r in reqs:
            assert r.done and r.reason in ("eos", "max_new"), (r.rid, r.reason, len(r.out))
        assert eng.transfers == eng.steps, (eng.transfers, eng.steps)
        assert eng.kv.drained(), f"{tag}: block pool not fully free after the run"
        if model_drafter:
            assert eng.draft_kv.pool_bytes() == POOL_BYTES["fp32"], eng.draft_kv.pool_bytes()
        gaps = divergence_gaps(model, eng, reqs, off_outs, prompts)
        same = len(reqs) - len(gaps)
        fw = spec_forwards(eng)
        n_tok = sum(len(r.out) for r in reqs)
        log(f"[{tag}] {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s: {n_tok / wall:.1f} "
            f"tok/s; steps {eng.steps} (mixed {mixed}, spec {spec}); accepted "
            f"{eng.spec_accepted}/{eng.spec_drafted} drafts; {fw['per_token']:.3f} forwards a "
            f"slot a spec token (batch passes: served {fw['served']}, drafter "
            f"{fw['drafter']}); launches {json.dumps({k: n[k] for k in want_n})}; "
            f"apply {json.dumps(apply)}; shapes prefill "
            f"{ {str(k): v for k, v in shapes['prefill'].items()} }; plain 0; "
            f"{same}/{len(reqs)} requests token-identical to draft='off' [{card}]")
        for rid, i, gap, ulps, near in gaps:
            log(f"[{tag}] rid {rid} diverges from draft='off' at token {i}: teacher-forced "
                f"top-2 gap {gap:.5f} = {ulps:.2f} bf16 ulps of the top logit; both tokens within "
                f"{SPEC_TIE_ULPS} ulps: {near}")
        assert all(near for *_, near in gaps), f"{tag}: a divergence off a near-tie: {gaps}"
        launches[draft] = {k: n[k] for k in want_n}
    busy, n_launch, (peng, preqs) = profile_run(
        lambda: serve(model, params, tenants, prompts, max_new, "cuda", draft="ngram", **kw),
        card, "profile-spec-ngram", "full_profile_spec_ngram.txt")
    n_tok = sum(len(r.out) for r in preqs)
    log(f"[full-spec-ngram] profiled gate run: busy {busy:.1%}, {n_launch} device operations, "
        f"{n_launch / n_tok:.1f} per emitted token ({n_tok} tokens) [{card}]")
    phase_spec_window(model, params, tenants, card, kw)
    return launches


def phase_spec_window(model, params, tenants, card: str, kw: dict) -> None:
    """The 16 x 128 window of phase_window served with draft off, ngram,
    int8 and merged in turn inside this call: tokens/s, acceptance, whole-
    model passes per token emitted at spec (or decode) steps, and ms of
    spec (or decode) step time per token they emitted."""
    rng = np.random.default_rng(13)
    lens = rng.integers(40, 701, size=WINDOW_REQUESTS)
    prompts = [rng.integers(3, model.cfg.vocab_size, size=int(n)).tolist() for n in lens]
    runs = []
    for draft in ("off",) + SPEC_GATE:
        t0 = time.perf_counter()
        eng, reqs = serve(model, params, tenants, prompts, WINDOW_NEW, "cuda", draft=draft, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert all(r.done for r in reqs) and eng.kv.drained()
        assert eng.transfers == eng.steps, (eng.transfers, eng.steps)
        kind = "decode" if draft == "off" else "spec"
        fw, n_tok = spec_forwards(eng), sum(len(r.out) for r in reqs)
        run = {"draft": draft, "tok_s": n_tok / wall, "wall_s": wall, "tokens": n_tok,
               "acceptance": eng.spec_accepted / eng.spec_drafted if eng.spec_drafted else None,
               "mixed_steps": len(eng.step_times["mixed"]), f"{kind}_steps": len(eng.step_times[kind]),
               "forwards_per_token": fw["per_token"], "passes_per_token": fw["passes_per_token"],
               "ms_per_token": 1e3 * sum(eng.step_times[kind]) / fw["emitted"],
               "mixed_ms": float(np.mean(eng.step_times["mixed"])) * 1e3,
               "step_ms": float(np.mean(eng.step_times[kind])) * 1e3}
        runs.append(run)
        acc = "" if run["acceptance"] is None else f"acceptance {run['acceptance']:.3f}, "
        log(f"[window-spec] {draft}: {n_tok} tokens in {wall:.3f} s = {run['tok_s']:.1f} tok/s; "
            f"{acc}{run['forwards_per_token']:.3f} forwards a slot ({run['passes_per_token']:.3f} "
            f"batch passes) and {run['ms_per_token']:.2f} ms of {kind} step a token emitted at "
            f"{kind} steps ({len(eng.step_times[kind])} x {run['step_ms']:.2f} ms); mixed "
            f"{run['mixed_steps']} x {run['mixed_ms']:.2f} ms [{card}]")
    with open(os.path.join(OUT_DIR, "window_spec.json"), "w") as f:
        json.dump({"card": card, "requests": WINDOW_REQUESTS, "prompt_tokens": int(lens.sum()),
                   "max_new": WINDOW_NEW, "spec_k": SPEC_K, "runs": runs}, f, indent=1)


BUCKETS = (("paged_prefill_attention", ("paged_prefill",)),
           # the ring decode kernel serves the paged and the dense cache
           ("decode attention (paged or dense)", ("decode_ring",)),
           ("sparse_delta_batched", ("idsfromarray",)),
           ("sparse_delta", ("idsfromrow",)),
           # the TMA + wgmma kernel carries its weight policy in its name
           ("fused_linear_q", ("fused_linear_q", "packedw")),
           ("fused_linear", ("fused_linear", "densew")),
           ("sparse_delta_dval", ("dval_",)),
           ("flash_attention_fwd", ("flash_fwd",)),
           ("topk_select", ("topk_kernel",)),
           ("sparse dx (segment sum)", ("segment_reduce",)),
           ("index ops (index_add_, gathers)", ("index",)),
           ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "splitk")))


class OpCount(TorchDispatchMode):
    """Counts every ATen operation dispatched while it is on, by name."""

    def __init__(self):
        super().__init__()
        self.counts: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def host_ops(run) -> tuple[int, dict, object]:
    """``run()``'s host operations, exactly: its ATen operations (OpCount)
    and its hand-written kernels' launches (COUNTERS, reset here), by name;
    returns (their total, the tally, what ``run`` returned)."""
    reset_counters()
    with OpCount() as ops_seen:
        out = run()
    tally = dict(ops_seen.counts)
    tally.update({f"kernel {c.name}": c.kernel for c in COUNTERS.values() if c.kernel})
    return sum(tally.values()), tally, out


def profile_run(run, card: str, tag: str, fname: str,
                buckets_out: dict | None = None) -> tuple[float, int, object]:
    """``run`` under ``torch.profiler``: device time by kernel (a table in
    the output directory's ``fname``), by bucket (into ``buckets_out``, in
    µs, when given); returns the device's busy share of the run's wall time,
    the number of kernels recorded and what ``run`` returned. Only the
    device is traced: nothing here reads the host's op trace, and with 10^5
    kernels a run its post-processing takes minutes. The session opens with
    PROFILE_MARKERS uncounted marker kernels (a session may lose its first
    records); a long session may also lose records in its middle, so the
    count recorded is a lower bound (``host_ops`` counts exactly)."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_MARKERS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = self_device_us
    kernels = [e for e in device_kernels(prof, "run") if MARKER_KERNEL not in e.key]
    rows = sorted((e for e in kernels if dev(e) > 0), key=dev, reverse=True)
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
    if buckets_out is not None:
        buckets_out.update(buckets)
    n_launch = sum(e.count for e in rows)
    log(f"[{tag}] device busy {total / wall_us:.1%} of {wall_us / 1e3:.1f} ms wall "
        f"(profiled run; device {total / 1e3:.1f} ms, {n_launch} kernels); device time: "
        f"{shares} [{card}]")
    return total / wall_us, n_launch, out


# ---------------------------------------------------------------- training


def train_run(model, params, pcfg, tcfg, batches):
    """Train on ``batches`` (numpy) from ``params``; (losses, values, the
    selected indices)."""
    trainer = Trainer(model, get_peft(pcfg), tcfg, params)
    hist = trainer.run(iter(batches))
    return [h["loss"] for h in hist], trainer.state.trainable, trainer.aux


def packed_fingerprint(params) -> list:
    """Per packed leaf: its bytes summed (codes, and scales as int32 bits),
    on the card — a change of any byte shows up with high odds."""
    return [torch.stack([x.data.view(torch.uint8).sum(dtype=torch.int64),
                         x.scales.view(torch.int32).sum(dtype=torch.int64)])
            for _, x in flatten(params) if isinstance(x, QuantizedTensor)]


def path_kernels(base: str, cfg, long: bool = False) -> tuple[tuple, tuple]:
    """(kernels a training step must launch, kernels it must not) on a base;
    the single-tenant bypass runs only where the model has an untied head
    or expert stacks to adapt (the MoE family), the flash forward only at
    sequence lengths from the flash threshold on (``long``)."""
    moe = bool(cfg.num_experts)
    single = (SINGLE_TENANT, ()) if moe else ((), SINGLE_TENANT)
    flash = (LONG_CONTEXT, ()) if long else ((), LONG_CONTEXT)
    if base == "bf16":
        return TRAINING + single[0] + flash[0], PACKED_BASE + single[1] + flash[1]
    return (PACKED_BASE + ("sparse_delta_dval",) + single[0] + flash[0],
            ("fused_linear",) + single[1] + flash[1])


def step_launches(cfg, base: str, long: bool = False) -> dict:
    """Launches of each path kernel in one training step: every adapted
    matrix once forward (its kernel) and once backward (dval), and at a
    long sequence one flash forward a layer. Dense: 7 projections a layer;
    MoE: 4 attention projections through fused_linear (fused_linear_q on a
    packed base, with the head's base matmul), 3 expert stacks and the
    untied head through sparse_delta."""
    L = cfg.num_layers
    flash = {"flash_attention_fwd": L} if long else {}
    if cfg.num_experts:  # on a packed base the head's matmul is fused_linear_q's too (k = 0)
        linear = {"fused_linear": 4 * L} if base == "bf16" else {"fused_linear_q": 4 * L + 1}
        return {**linear, "sparse_delta": 3 * L + 1, "sparse_delta_dval": 7 * L + 1, **flash}
    return {n: 7 * L for n in path_kernels(base, cfg)[0]} | flash


def select_launches(cfg, base: str) -> int:
    """``topk_select`` launches of selection: one a stack (7 dense, 8 MoE
    with its head); a packed stack dequantizes and selects one matrix at a
    time (a layer, or an expert of a layer: 196 on qwen2, 3137 on olmoe)."""
    stacks = weight_stacks(cfg)
    if base == "bf16":
        return len(stacks)
    return sum(math.prod(shape[:-2]) for _, shape in stacks)


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
# magnitude). Losses are held to 1e-5 for both. The flash-path runs (batch 4
# x seq 64) hold both families to the dense bound: reduced olmoe reads
# 3.5e-6 there on an H100 (``--reduced-train-distances``). Reduced
# seamless-m4t on an NF4 base is the same kind of case: on the CPU alone its
# flash path and its dense path (one function, two orders of float32 sums)
# part by 1.55e-5, 99.9 % of it one dec_blocks/wgate value whose first
# gradient nearly vanishes (its bf16 and int8 bases: 7.6e-7 / 6.5e-7), so it
# is held to about three times that witness.
VALUE_TOL = {"dense": 1e-5, "moe": 1e-4, "flash": 1e-5, "encdec-nf4": 5e-5}
# (batch, seq, flash threshold, flash block) of ``--reduced-train-distances``;
# a threshold above seq keeps every layer on dense attention
DISTANCE_SHAPES = ((2, 128, 64, 32), (2, 128, 4096, 32), (4, 64, 32, 16), (4, 16, 2048, 512))


def reduced_train_case(arch: str, base: str, batch: int, seq: int, **cfg_kw):
    """Reduced ``arch`` in fp32 with ``cfg_kw``, its params made on the CPU
    from seed 0 (packed to ``base`` unless bf16) and three batches."""
    cfg = reduced(get_config(arch)).replace(dtype="float32", **cfg_kw)
    model = get_model(cfg)
    params = model.init(seed=0, device="cpu")
    if base != "bf16":
        params = quantize_base(params, base, block=QUANT_BLOCK)
    batches = [TASKS["reasoning"](cfg.vocab_size, batch, seq, 0, i) for i in range(3)]
    if cfg.family == "encdec":  # 2 x seq frames: the cross-attention's Sq != Skv
        rng = np.random.default_rng(0)
        for b in batches:
            b["frames"] = rng.standard_normal((batch, 2 * seq, cfg.d_model)).astype(np.float32)
    return cfg, model, params, batches


def reduced_train(model, params, batches, device: str):
    """Three AdamW steps (k = 2, fp32 values) on ``device``."""
    params = map_leaves(lambda x: None if x is None else x.to(device), params)
    return train_run(model, params, PeftConfig(k=2, delta_dtype="float32"),
                     TrainConfig(steps=3, learning_rate=TRAIN_LR), batches)


def value_distance(want, got) -> tuple[float, list]:
    """||got - want|| / ||want|| over two value trees, and per leaf its path,
    largest |difference| and share of the squared distance."""
    leaves = [("/".join(p), a, b.cpu()) for (p, a), (_, b) in zip(flatten(want), flatten(got))
              if a is not None]
    sq = [float((b - a).double().square().sum()) for _, a, b in leaves]
    norm = sum(float(a.double().square().sum()) for _, a, _ in leaves) ** 0.5
    dist = sum(sq) ** 0.5
    return dist / norm, [(p, float((b - a).abs().max()), d / dist**2 if dist else 0.0)
                         for (p, a, b), d in zip(leaves, sq)]


def reduced_train_distances(card: str) -> None:
    """How far reduced training moves card vs CPU at each of
    DISTANCE_SHAPES, and, on the CPU alone, the flash path against dense
    attention at the first (the same function in two orders of float32
    sums): losses, the value tree's relative distance and its share by
    leaf. Readings only; ``phase_reduced_train`` holds its runs to bounds."""
    def report(label, a, b):
        rel, leaves = value_distance(a[1], b[1])
        log(f"[distances] {label}: losses {[f'{x:.7f}' for x in a[0]]} / "
            f"{[f'{x:.7f}' for x in b[0]]}; values relative distance {rel:.3e} [{card}]")
        for path, worst, share in leaves:
            log(f"[distances]     {path}: max |diff| {worst:.3e}, share {share:.3f}")

    for arch in ("qwen2-1.5b", MOE_ARCH):
        for batch, seq, threshold, block in DISTANCE_SHAPES:
            _, model, params, batches = reduced_train_case(
                arch, "bf16", batch, seq, flash_threshold=threshold, flash_block=block)
            kind = f"flash (threshold {threshold}, block {block})" if seq >= threshold else "dense"
            report(f"{arch} batch {batch} x seq {seq}, {kind}, cpu / cuda",
                   reduced_train(model, params, batches, "cpu"),
                   reduced_train(model, params, batches, "cuda"))
        batch, seq, threshold, block = DISTANCE_SHAPES[0]
        runs = [reduced_train(*reduced_train_case(arch, "bf16", batch, seq, flash_threshold=t,
                                                  flash_block=block)[1:], "cpu")
                for t in (threshold, 1 << 20)]
        report(f"{arch} batch {batch} x seq {seq}, cpu alone: flash / dense", *runs)


# where the decode-row fused_linear_q's time goes: its source rebuilt with
# one part removed (each marker must be found in csrc/fused_linear_q.cu)
_DEQ = "{\n  if (QT == RT_Q_NF4) {\n    const uint32_t b = (word(lo, c >> 2)"
_NEXT = "    if (s + kSkWarps < steps)  // the next step's loads fly while this one is dequantized"
_STEP = "    sk_step<QT, MT, UNIFORM, VEC>(cur, acc, scales, k0, nt, N, K, block, nf4);"
_SUM = "  cg::cluster_group cluster = cg::this_cluster();\n  cluster.sync();"
DECODE_ROW_VARIANTS = {
    "as built": (),
    "no dequantize": ((_DEQ, "{\n  return word(lo, c >> 2) + __float_as_uint(s) + (nf4 == nullptr);"
                             + _DEQ[1:]),),
    "no loads after the first step": ((_NEXT, "    if (false)"),),
    "no dequantize or products": ((_STEP, "    acc[0][0][0] += __uint_as_float(cur.code[0].x ^ "
                                          "cur.code[1].y ^ cur.xb[0][0]);"),),
    "no cluster sum": ((_SUM, "  if (gridDim.z > 0) return;\n" + _SUM),),
}


def decode_row_variants(card: str) -> None:
    """``fused_linear_q`` at qwen2-1.5b's decode rows (M = 8, the 7
    projections of one layer, block 64, int8 and NF4) timed with its
    source as built and with one part removed at a time (the dequantize,
    the loads after each warp's first step, the dequantize and the
    products, the cluster's sum), all built here in one call; the time a
    part takes is the difference. Only the unchanged build is checked
    against the plain version (the others are wrong by construction).
    Writes ``chiprun_out/decode_row_variants.json``."""
    import ctypes
    src = (build.CSRC / "fused_linear_q.cu").read_text()
    nvcc = build.nvcc_path()
    procs, libs = {}, {}
    for name, edits in DECODE_ROW_VARIANTS.items():
        text = src
        for old, new in edits:
            assert old in text, f"marker of {name!r} not in fused_linear_q.cu"
            text = text.replace(old, new)
        d = build.BUILD_DIR / "variants" / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        (d / "fused_linear_q.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-shared", "-I", str(build.CSRC), "-o", str(d / "v.so"),
             str(d / "fused_linear_q.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        assert proc.returncode == 0, f"variant {name!r} did not build:\n{out[-3000:]}"
        fn = ctypes.CDLL(str(build.BUILD_DIR / "variants" / name.replace(" ", "_") / "v.so"))
        fn = fn.rt_fused_linear_q_skinny
        fn.argtypes, fn.restype = build.SIGNATURES["rt_fused_linear_q_skinny"], ctypes.c_int
        libs[name] = fn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    cfg = get_config("qwen2-1.5b")
    d, dkv, dff = cfg.d_model, cfg.num_kv_heads * cfg.resolved_head_dim, cfg.d_ff
    projections = [("wq", d, d), ("wk", d, dkv), ("wv", d, dkv), ("wo", d, d),
                   ("wgate", d, dff), ("wup", d, dff), ("wdown", dff, d)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    result = {"card": card}
    for qd in PACKED:
        rows = {name: [] for name in libs}
        for pname, k_in, n_out in projections:
            w = torch.randn(k_in, n_out, generator=gen, device=dev) * k_in**-0.5
            qt = quantize(w.to(torch.bfloat16), qd, QUANT_BLOCK)
            x = torch.randn(SLOTS, k_in, generator=gen, device=dev).to(torch.bfloat16)
            y = torch.empty(SLOTS, n_out, dtype=torch.bfloat16, device=dev)
            _, k_chunk, n_split = ql_mod.skinny_split(n_out, k_in, sms)
            for name, fn in libs.items():
                def run(fn=fn):
                    rc = fn(x.data_ptr(), qt.data.data_ptr(), qt.scales.data_ptr(), None, None,
                            None, y.data_ptr(), SLOTS, n_out, k_in, 0, QUANT_BLOCK,
                            0 if qd == "int8" else 1, 1, k_chunk, n_split, stream)
                    build.check(rc, f"fused_linear_q variant {name}")
                run()
                if name == "as built":
                    check_close(f"fused_linear_q {qd} {pname} as built", y, ql_mod.fused_linear_q_plain(
                        x, qt.data, qt.scales, qdtype=qd, block=QUANT_BLOCK), torch.bfloat16)
                rows[name].append(cuda_ms(run, iters=20) * 1e3)
        result[qd] = {name: {"layer_us": sum(r), "per_projection_us": r} for name, r in rows.items()}
        for name, r in rows.items():
            log(f"[decode-row variants] {qd} {name}: {sum(r):.2f} us a layer (" + ", ".join(
                f"{p[0]} {v:.2f}" for p, v in zip(projections, r)) + f") [{card}]")
    with open(os.path.join(OUT_DIR, "decode_row_variants.json"), "w") as f:
        json.dump(result, f, indent=1)


# where the TMA + wgmma kernels' time goes: csrc/ rebuilt with one part
# removed (each marker must be found in the file it names)
_GATHER_COPY = "#pragma unroll\n            for (int q = 0; q < R / 32; ++q) dst["
_FRAGMENTS = "          W::fragments(fa[h], ring"
LINEAR_VARIANTS = {
    "as built": (),
    "no bypass gather copies": (("linear.cuh", _GATHER_COPY,
                                 "            for (int q = 0; q < 0; ++q) dst["),),
    "no dequantize": (("linear.cuh", _FRAGMENTS, "          if (t < 0) W::fragments(fa[h], ring"),),
}


def linear_variants(card: str) -> None:
    """``fused_linear`` and ``fused_linear_q`` (int8, NF4) on the TMA +
    wgmma route at qwen2-1.5b's M = 2048 path shapes (wq, wk, wgate, wdown),
    with k = 1 and k = 0, timed with ``csrc/`` as built and with one part
    removed at a time (the gather warps' copies of the bypass columns; the
    packed kernel's dequantize), all built here in one call: the time a part
    takes is the difference. Then the as-built kernels at every tile height
    of ``fused_linear.TMA_ROWS``, beside the one ``linear_plan`` picks. Only
    the unchanged build is checked against the plain versions (the others
    are wrong by construction). Writes ``chiprun_out/linear_variants.json``."""
    import ctypes
    import shutil
    nvcc = build.nvcc_path()
    procs, libs = {}, {}
    for name, edits in LINEAR_VARIANTS.items():
        d = build.BUILD_DIR / "variants" / name.replace(" ", "_")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        for fname, old, new in edits:
            text = (d / fname).read_text()
            assert old in text, f"marker of {name!r} not in {fname}"
            (d / fname).write_text(text.replace(old, new))
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(d / "v.so"), str(d / "fused_linear.cu"),
             str(d / "fused_linear_q.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        assert proc.returncode == 0, f"variant {name!r} did not build:\n{out[-3000:]}"
        lib = ctypes.CDLL(str(build.BUILD_DIR / "variants" / name.replace(" ", "_") / "v.so"))
        for fn_name in ("rt_fused_linear_wgmma", "rt_fused_linear_q_wgmma"):
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = build.SIGNATURES[fn_name], ctypes.c_int
        libs[name] = lib
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    cfg = get_config("qwen2-1.5b")
    d_model, dkv, dff = cfg.d_model, cfg.num_kv_heads * cfg.resolved_head_dim, cfg.d_ff
    shapes = (("wq", d_model, d_model), ("wk", d_model, dkv), ("wgate", d_model, dff),
              ("wdown", dff, d_model))
    m = TRAIN_BATCH * TRAIN_SEQ
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    bf = torch.bfloat16
    result = {"card": card, "M": m}
    for weight in ("bf16",) + PACKED:
        table = {}
        for pname, k_in, n_out in shapes:
            w = torch.randn(k_in, n_out, generator=gen, device=dev) * k_in**-0.5
            x = torch.randn(m, k_in, generator=gen, device=dev).to(bf)
            idx = torch.randint(0, k_in, (TRAIN_K, n_out), generator=gen, device=dev,
                                dtype=torch.int32)
            val = (torch.randn(TRAIN_K, n_out, generator=gen, device=dev) * 0.05).to(bf)
            y = torch.empty(m, n_out, dtype=bf, device=dev)
            plan_rows = fl_mod.linear_plan(m, n_out, k_in, sms)[1]
            if weight == "bf16":
                wd = w.to(bf)
                want = fl_mod.fused_linear_plain(x, wd, idx, val)

                def call(lib, k, rows, wd=wd, x=x, idx=idx, val=val, y=y, n_out=n_out, k_in=k_in):
                    build.check(lib.rt_fused_linear_wgmma(
                        x.data_ptr(), wd.data_ptr(), idx.data_ptr(), val.data_ptr(), None,
                        y.data_ptr(), m, n_out, k_in, k, rows, 1, stream), "fused_linear variant")
            else:
                qt = quantize(w.to(bf), weight, QUANT_BLOCK)
                want = ql_mod.fused_linear_q_plain(x, qt.data, qt.scales, idx, val, qdtype=weight,
                                                   block=QUANT_BLOCK)

                def call(lib, k, rows, qt=qt, x=x, idx=idx, val=val, y=y, n_out=n_out, k_in=k_in,
                         qd=weight):
                    build.check(lib.rt_fused_linear_q_wgmma(
                        x.data_ptr(), qt.data.data_ptr(), qt.scales.data_ptr(), idx.data_ptr(),
                        val.data_ptr(), None, y.data_ptr(), m, n_out, k_in, k, QUANT_BLOCK,
                        0 if qd == "int8" else 1, 1, rows, stream), "fused_linear_q variant")
            row = {"tile_rows": plan_rows}
            for name, lib in libs.items():
                if weight == "bf16" and name == "no dequantize":
                    continue
                for k in (TRAIN_K, 0):
                    if name == "as built" and k:
                        call(lib, k, plan_rows)
                        torch.cuda.synchronize()
                        check_close(f"{weight} {pname} as built", y, want, bf)
                    row[f"{name}, k={k}"] = cuda_ms(lambda: call(lib, k, plan_rows))
            for rows in fl_mod.TMA_ROWS:  # the tile heights the plan chooses among
                row[f"tile_rows={rows}, k={TRAIN_K}"] = cuda_ms(
                    lambda: call(libs["as built"], TRAIN_K, rows))
            table[pname] = row
            log(f"[linear variants] {weight} {pname} K={k_in} N={n_out} M={m}: " + ", ".join(
                f"{key} {v:.4f}" if isinstance(v, float) else f"{key} {v}"
                for key, v in row.items()) + f" ms [{card}]")
        result[weight] = table
    with open(os.path.join(OUT_DIR, "linear_variants.json"), "w") as f:
        json.dump(result, f, indent=1)


def mma_flash(q, k, v, causal: bool):
    """The mma.sync kernel that bf16 took at every head dim before the wgmma
    route (the wrapper now sends it the other head dims): called directly,
    timed beside the new route in the same run."""
    b, sq, h, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)

    def run():
        build.check(build.library().rt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, sq,
            k.shape[1], h, k.shape[2], hd, int(causal), 1, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], torch.cuda.current_stream().cuda_stream), "flash (mma route)")
        return out, lse
    return run


# the launch choices --attention-variants times beside the chosen ones
FLASH_VARIANTS = ((128, 2), (128, 3), (64, 2), (64, 3))  # (key tile, stages)
DECODE_VARIANTS = tuple((bps, st, w, nh) for bps in (4, 8, 16) for st in (1, 2, 4)
                        for w in (2, 4) for nh in (1, 2, 4))
# the flash wgmma kernel rebuilt with one part changed: name -> (whether it
# still computes the function, (marker, replacement), ...). Without its
# warpgroups' turns (named barriers 1 and 2) each warpgroup issues its
# products when it is ready; the others remove the exponentials, the P V
# products or the Q K^T products (where the time goes)
_TURN = "  auto turn_begin = [&] { rt::named_bar(bar_mine, 256); };\n"
_PASS = '    if (cw == 0 || u < T) asm volatile("bar.arrive %0, 256;\\n" ::"r"(bar_other) : "memory");\n'
_FIRST = '  if (cw == 1) asm volatile("bar.arrive %0, 256;\\n" ::"r"(bar_other) : "memory");\n'
_EX2 = '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n'
_PV = "      rt::WgmmaRS<HD>::template mma<1>(o, pa[kk],"
_QK = "      rt::Wgmma<BK>::template mma<0, 0>("
FLASH_SOURCE_VARIANTS = {
    "no turns": (True, ((_TURN, "  auto turn_begin = [&] {};\n"), (_PASS, ""), (_FIRST, ""))),
    "no exp2": (False, ((_EX2, "  y = x;\n"),)),
    "no P V products": (False, ((_PV, "      if (kk < 0) " + _PV.lstrip()),)),
    "no Q K^T products": (False, ((_QK, "      if (ks < 0) " + _QK.lstrip()),)),
}


def flash_source_variants() -> dict:
    """FLASH_SOURCE_VARIANTS built (flash_attention.cu alone, each marker
    found), in parallel: name -> the variant's rt_flash_attention_fwd_wgmma."""
    import ctypes
    import shutil
    nvcc = build.nvcc_path()
    procs, fns = {}, {}
    for name, (_, edits) in FLASH_SOURCE_VARIANTS.items():
        d = build.BUILD_DIR / "variants" / name.replace(" ", "_").replace("^", "")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        text = (d / "flash_attention.cu").read_text()
        for old, new in edits:
            assert old in text, f"marker of {name!r} not in flash_attention.cu: {old!r}"
            text = text.replace(old, new)
        (d / "flash_attention.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(d / "v.so"),
             str(d / "flash_attention.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        assert proc.returncode == 0, f"variant {name!r} did not build:\n{out[-3000:]}"
        fn = ctypes.CDLL(str(build.BUILD_DIR / "variants" / name.replace(" ", "_").replace("^", "")
                             / "v.so"))
        fn = fn.rt_flash_attention_fwd_wgmma
        fn.argtypes = build.SIGNATURES["rt_flash_attention_fwd_wgmma"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def attention_variants(card: str) -> None:
    """The two redesigned kernels at their path shapes (bf16) with the
    launch choices their planners pick among: ``flash_attention_fwd``'s
    wgmma route at every (key tile, stages) of FLASH_VARIANTS and rebuilt
    per FLASH_SOURCE_VARIANTS (without the warpgroups' turns, checked; with
    a part removed, timed only), beside the mma route and one SDPA call; the decode kernel at
    qwen2's and olmoe's serving shapes under every distinct plan of
    DECODE_VARIANTS (blocks an SM, most stages, warps and heads a block;
    each checked). Writes ``chiprun_out/attention_variants.json``."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    build.library()
    rebuilt = flash_source_variants()
    result = {"card": card, "flash": {}, "decode": {}}
    for arch, (b, s, h, hkv, hd) in (("qwen2-1.5b", (LONG_BATCH, LONG_SEQ, 12, 2, 128)),
                                     (MOE_ARCH, (1, 2048, 16, 16, 128))):
        q, k, v = (torch.randn(b, s, n, hd, generator=gen, device=dev).to(torch.bfloat16)
                   for n in (h, hkv, hkv))
        out = torch.empty_like(q)
        lse = torch.empty((b, h, s), dtype=torch.float32, device=dev)

        def wgmma(fn, bk=fa_mod.BLOCK_KEYS, st=fa_mod.STAGES):
            """The wgmma route's C entry point ``fn`` at (key tile, stages)."""
            return lambda: build.check(fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), b,
                s, s, h, hkv, hd, 1, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], bk,
                st, torch.cuda.current_stream().cuda_stream), "flash_attention_fwd (wgmma)")

        row = {}
        for bk, st in FLASH_VARIANTS:
            run = wgmma(build.library().rt_flash_attention_fwd_wgmma, bk, st)
            run()
            check_flash(f"flash {arch} key tile {bk} stages {st}", q, k, v, True, out, lse)
            key = f"block_keys={bk}, stages={st}" + (
                " (chosen)" if (bk, st) == (fa_mod.BLOCK_KEYS, fa_mod.STAGES) else "")
            row[key] = cuda_ms(run)
        row["mma route"] = cuda_ms(mma_flash(q, k, v, True))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        row["sdpa (yardstick)"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        for name, fn in rebuilt.items():
            run = wgmma(fn)
            run()
            if FLASH_SOURCE_VARIANTS[name][0]:  # a schedule change: still the function
                check_flash(f"flash {arch} {name}", q, k, v, True, out, lse)
            row[name] = cuda_ms(run)
        result["flash"][arch] = row
        log(f"[attention variants] flash {arch} {(b, s, h, hkv, hd)} causal: " + ", ".join(
            f"{key} {ms:.4f}" for key, ms in row.items()) + f" ms [{card}]")
    num_blocks = SLOTS * (-(-MAX_LEN // PAGE))
    sms = dec_mod.sm_count(dev)
    dec_vl = [1, 17, 300, MAX_LEN - 1, 512, 0, 640, 33]
    for arch in ("qwen2-1.5b", MOE_ARCH):
        q, kp, vp, table, _, vl = paged_case(gen, [0] * SLOTS, dec_vl, 1, torch.bfloat16, dev,
                                             num_blocks, arch=arch)
        h, hkv, hd = q.shape[2], kp.shape[2], q.shape[3]
        want = dec_mod.paged_decode_attention_plain(q, kp, vp, table, vl)
        chosen = dec_mod.decode_plan(SLOTS, hkv, h // hkv, table.shape[1], sms, kp.dtype, hd)
        row, seen = {}, set()
        for bps, st, w, nh in DECODE_VARIANTS:
            plan = dec_mod.decode_plan(SLOTS, hkv, h // hkv, table.shape[1], sms, kp.dtype, hd,
                                       blocks_per_sm=bps, max_stages=st, max_warps=w,
                                       max_heads=nh)
            if plan in seen:
                continue
            seen.add(plan)
            got = dec_mod.launch(q, kp, vp, table, vl, None, None, plan)
            torch.cuda.synchronize()
            check_close(f"decode {arch} plan {plan}", got, want, torch.bfloat16)
            key = (f"{plan.threads // 32} warps, {plan.heads} heads a block, {plan.ranges} "
                   f"ranges of {plan.per} pages, {plan.stages} stages"
                   + (" (chosen)" if plan == chosen else ""))
            row[key] = cuda_ms(lambda: dec_mod.launch(q, kp, vp, table, vl, None, None, plan))
        result["decode"][arch] = row
        best = min(row, key=row.get)
        log(f"[attention variants] decode {arch} q {tuple(q.shape)}: fastest {best} "
            f"{row[best]:.4f} ms; chosen {[f'{k_} {v_:.4f}' for k_, v_ in row.items() if 'chosen' in k_]} "
            f"[{card}]")
    with open(os.path.join(OUT_DIR, "attention_variants.json"), "w") as f:
        json.dump(result, f, indent=1)


# the launch choices --delta-variants times beside the chosen plans (the
# planners' keywords; {} is the chosen plan). Columns a thread are 8, fixed
# by the kernels' 16-byte vectors, and are not varied.
APPLY_VARIANTS = ({}, {"tile_rows": 1}, {"tile_rows": 2}, {"tile_rows": 8}, {"tile_rows": 16},
                  {"stages": 1}, {"blocks_per_sm": 1}, {"blocks_per_sm": 3},
                  {"blocks_per_sm": 4}, {"max_threads": 128}, {"rows_max": 1 << 30},
                  {"rows_max": 0})
DVAL_VARIANTS = ({}, {"tile_rows": 1}, {"tile_rows": 2}, {"tile_rows": 8}, {"stages": 1},
                 {"blocks_per_sm": 1}, {"blocks_per_sm": 4}, {"max_threads": 256},
                 {"max_threads": 128}, {"max_threads": 64})


def variant_sweep(kind: str, variants, cases, plan_of, launch, plain) -> dict:
    """Each distinct set of plans that ``variants`` (planner keywords) give
    for ``cases``: every launch checked against ``plain``, then the device
    ms summed over the cases."""
    want = [plain(c) for c in cases]
    row, seen = {}, set()
    for kw in variants:
        plans = tuple(plan_of(c, kw) for c in cases)
        if plans in seen:
            continue
        seen.add(plans)
        for c, p, w in zip(cases, plans, want):
            check_close(f"{kind} {kw} {p}", launch(c, p), w, torch.bfloat16)
        row[json.dumps(kw) if kw else "chosen"] = {
            "ms": timed_sum(f"{kind} {kw}", [lambda c=c, p=p: launch(c, p)
                                              for c, p in zip(cases, plans)]),
            "plans": [p._asdict() for p in plans]}
    return row


def timed_sum(what: str, calls) -> float | None:
    """The device ms of ``calls`` summed, or None (logged, with the
    profiler's complaint) where a timing session recorded no kernel."""
    try:
        return sum(cuda_ms(fn) for fn in calls)
    except RuntimeError as err:
        log(f"[delta variants] {what}: not timed ({err})")
        return None


def delta_variants(card: str) -> None:
    """The two bypass kernels at their path shapes (bf16) under the launch
    choices their planners pick among, each plan checked against the plain
    version: the multi-tenant apply over qwen2-1.5b's 7 projections at a
    decode step (M = 8) and a mixed step (M = 2048), delta only and with
    the epilogue, at every plan of APPLY_VARIANTS (rows a tile, stages,
    blocks an SM, column spans, the rows route at every M or at none); the
    single-tenant apply over olmoe-1b-7b's 3 expert stacks and head; the
    value gradient over qwen2's layer at M = 2048 and olmoe's 4 shapes at
    every plan of DVAL_VARIANTS. Writes ``chiprun_out/delta_variants.json``."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(29)
    build.library()
    sms = dec_mod.sm_count(dev)
    cfg = get_config("qwen2-1.5b")
    d, dq, dkv, dff = cfg.d_model, cfg.num_heads * cfg.resolved_head_dim, \
        cfg.num_kv_heads * cfg.resolved_head_dim, cfg.d_ff
    projections = [("wq", d, dq), ("wk", d, dkv), ("wv", d, dkv), ("wo", dq, d),
                   ("wgate", d, dff), ("wup", d, dff), ("wdown", dff, d)]
    result = {"card": card, "apply": {}, "single": {}, "dval": {}}

    def report(tag, row):
        log(f"[delta variants] {tag}: " + ", ".join(f"{k_} {v_['ms']}" for k_, v_ in
                                                    row.items()) + f" ms [{card}]")

    for m in (SLOTS, SLOTS * PREFILL_CHUNK):
        cases = []
        for _, d_in, d_out in projections:
            x, idx, val, aid = delta_case(gen, m, d_in, d_out, torch.bfloat16, torch.bfloat16,
                                          dev)
            rpi = m // SLOTS
            y = torch.randn(m, d_out, generator=gen, device=dev).to(torch.bfloat16)
            cases.append((x, idx, val, aid[::rpi].contiguous(), rpi, y, aid))

        def plan_of(c, kw):
            return sd_mod.delta_plan(c[0].shape[0], c[0].shape[1], c[1].shape[2], 2, sms, **kw)

        row = variant_sweep(f"apply M={m}", APPLY_VARIANTS, cases, plan_of,
                            lambda c, p: sd_mod.launch_batched(*c[:5], None, None, p),
                            lambda c: sd_mod.sparse_delta_batched_plain(*c[:3], c[6]))
        # the epilogue under the same plans (timed only: its bits are held
        # against the adds in the kernel phase)
        fused = {key: {"ms": timed_sum(f"apply M={m} {key} with the epilogue", [
            lambda c=c, p=p: sd_mod.launch_batched(*c[:5], c[5], None, sd_mod.DeltaPlan(**p))
            for c, p in zip(cases, r["plans"])])} for key, r in row.items()}
        result["apply"][f"M={m}"] = row
        result["apply"][f"M={m} fused"] = fused
        report(f"apply, qwen2 layer M={m}, delta only", row)
        report(f"apply, qwen2 layer M={m}, with the epilogue", fused)
    ecfg = get_config(MOE_ARCH)
    m_tok = TRAIN_BATCH * TRAIN_SEQ
    g = moe_mod.num_groups(m_tok, ecfg.experts_per_token)
    rows = g * moe_mod.capacity(ecfg, m_tok // g)
    e, dm, f, v = ecfg.num_experts, ecfg.d_model, ecfg.d_ff, ecfg.padded_vocab
    single, grads = [], []
    for b, m, d_in, d_out in ((e, rows, dm, f), (e, rows, dm, f), (e, rows, f, dm),
                              (1, m_tok, dm, v)):
        x = torch.randn(b, m, d_in, generator=gen, device=dev).to(torch.bfloat16)
        idx = torch.randint(0, d_in, (b, TRAIN_K, d_out), generator=gen, device=dev,
                            dtype=torch.int32)
        val = (torch.randn(b, TRAIN_K, d_out, generator=gen, device=dev) * 0.05).to(
            torch.bfloat16)
        dy = (torch.randn(b, m, d_out, generator=gen, device=dev) * m**-0.5).to(torch.bfloat16)
        single.append((x, idx, val))
        grads.append((x, idx, dy))
    row = variant_sweep(
        "olmoe single-tenant apply", APPLY_VARIANTS, single,
        lambda c, kw: sd_mod.delta_plan(c[0].shape[0] * c[0].shape[1], c[0].shape[2],
                                        c[1].shape[2], 2, sms, **kw),
        lambda c, p: sd_mod.launch_single(*c, p), lambda c: sd_mod.sparse_delta_plain(*c))
    result["single"]["olmoe 3 expert stacks + head"] = row
    report("single-tenant apply, olmoe 3 expert stacks + head", row)
    m = TRAIN_BATCH * TRAIN_SEQ
    qgrads = []
    for _, d_in, d_out in projections:
        x = torch.randn(1, m, d_in, generator=gen, device=dev).to(torch.bfloat16)
        idx = torch.randint(0, d_in, (1, TRAIN_K, d_out), generator=gen, device=dev,
                            dtype=torch.int32)
        dy = (torch.randn(1, m, d_out, generator=gen, device=dev) * m**-0.5).to(torch.bfloat16)
        qgrads.append((x, idx, dy))
    for tag, cases in ((f"qwen2 layer M={m}", qgrads), ("olmoe 3 expert stacks + head", grads)):
        row = variant_sweep(
            f"dval {tag}", DVAL_VARIANTS, cases,
            lambda c, kw: sd_mod.dval_plan(*c[0].shape, c[1].shape[2], 2, sms, **kw),
            lambda c, p: sd_mod.launch_dval(*c, torch.float32, p),
            lambda c: sd_mod.sparse_delta_dval_plain(*c))
        result["dval"][tag] = row
        report(f"dval, {tag}", row)
    with open(os.path.join(OUT_DIR, "delta_variants.json"), "w") as f_:
        json.dump(result, f_, indent=1)


def phase_reduced_train(card: str, base: str = "bf16", arch: str = "qwen2-1.5b",
                        flash: bool = False) -> None:
    """Reduced ``arch`` in fp32 (fp32 values too), the same params and
    three batches, trained on the card and on the CPU: losses, values and
    the selected indices; on a packed base the params are packed on the CPU
    and the same bytes move to the card. ``flash`` lowers the flash
    threshold and block so that every layer's attention at seq 64 takes the
    flash path (its kernel on the card, its plain version on the CPU)."""
    batch, seq = REDUCED_FLASH_SHAPE if flash else (4, 16)
    cfg, model, params, batches = reduced_train_case(arch, base, batch, seq,
                                                     **(REDUCED_FLASH if flash else {}))
    want_loss, want_val, want_idx = reduced_train(model, params, batches, "cpu")
    reset_counters()
    got_loss, got_val, got_idx = reduced_train(model, params, batches, "cuda")
    must, must_not = path_kernels(base, cfg, long=flash)
    for name, c in COUNTERS.items():
        assert name not in must + SELECTION or c.kernel > 0, \
            f"reduced training never launched {name}"
        assert name not in must_not or c.kernel == 0, f"reduced training launched {name}"
        assert c.plain == 0, f"reduced training on the card called plain {name}"
    # a flash forward a layer a step; the encoder-decoder's decoder layers run
    # two (causal self-attention, non-causal cross-attention), its encoder one
    sites = cfg.num_layers * (2 if cfg.family == "encdec" else 1) + cfg.encoder_layers
    assert not flash or COUNTERS["flash_attention_fwd"].kernel == 3 * sites
    for (p, a), (_, b) in zip(flatten(want_idx), flatten(got_idx)):
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b.cpu())), \
            f"selected indices of {p} differ card vs cpu"
    for i, (a, b) in enumerate(zip(want_loss, got_loss)):
        assert abs(a - b) <= 1e-5, f"step {i}: loss cpu {a!r} != cuda {b!r}"
    # relative error of the whole value tree: ||cuda - cpu|| / ||cpu||
    rel = value_distance(want_val, got_val)[0]
    tol = VALUE_TOL["encdec-nf4" if cfg.family == "encdec" and base == "nf4" else
                    "flash" if flash else "moe" if cfg.num_experts else "dense"]
    assert rel <= tol, f"values: ||cuda - cpu|| / ||cpu|| = {rel:.3e} > {tol}"
    base_txt = "fp32 base" if base == "bf16" else f"{base} base"
    path = (f", flash path (threshold {cfg.flash_threshold}, block {cfg.flash_block}, seq "
            f"{seq}: {COUNTERS['flash_attention_fwd'].kernel} flash launches)" if flash else "")
    log(f"[reduced-train] 3 steps of reduced {arch} fp32, {base_txt}{path}: selected indices "
        f"identical ({COUNTERS['topk_select'].kernel} topk_select launches); losses cpu "
        f"{[f'{x:.7f}' for x in want_loss]} cuda {[f'{x:.7f}' for x in got_loss]} "
        f"(max |diff| {max(abs(a - b) for a, b in zip(want_loss, got_loss)):.2e}); values "
        f"||cuda - cpu|| / ||cpu|| = {rel:.2e} [{card}]")


def phase_train(card: str, base: str = "bf16", arch: str = "qwen2-1.5b",
                batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ, steps: int = TRAIN_STEPS) -> dict:
    """Full-width NeuroAda training of ``arch`` on a bf16 base, or on one
    packed to ``base`` (int8, NF4) after init and before selection, as the
    launcher does: selection (timed, its launches and peak memory), then
    ``batch`` x ``seq`` steps; at ``seq`` from the flash threshold on (the
    long-context run) every layer's attention takes the flash kernel. Then
    the adapter is served on the same base (for MoE beside two random
    tenants, with a window run; not after the long-context run). Returns
    the measured steps' launches, selection's and the step's figures."""
    cfg = get_config(arch)
    model = get_model(cfg)
    params = model.init(seed=0, device="cuda")
    if base != "bf16":
        params = quantize_base(params, base, block=QUANT_BLOCK)  # the dense base is freed
    base_bytes = tree_bytes(params)
    tcfg = TrainConfig(steps=TRAIN_WARMUP + steps + 1, learning_rate=TRAIN_LR)
    moe = bool(cfg.num_experts)
    long = seq >= cfg.flash_threshold
    tok = batch * seq
    tag = "train" if base == "bf16" else f"train-{base}"
    tag = ("train-olmoe" + ("" if base == "bf16" else f"-{base}") if moe
           else "train-long" if long else tag)
    # selection: the Trainer's set-up selects every adapted stack on the card
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counters()
    t0 = time.perf_counter()
    trainer = Trainer(model, get_peft(PeftConfig(k=TRAIN_K)), tcfg, params)
    torch.cuda.synchronize()
    select_s = time.perf_counter() - t0
    select_peak = torch.cuda.max_memory_allocated() - held
    n_select = COUNTERS["topk_select"].kernel
    assert all(c.plain == 0 for c in COUNTERS.values()), "selection called a plain version"
    assert n_select == select_launches(cfg, base), (n_select, select_launches(cfg, base))
    st = stats(params, trainer.state.trainable)
    assert st["trainable"] == trainable_count(cfg, TRAIN_K), st
    expert_peak = None
    if moe and base != "bf16":  # one packed (L, E, d_in, d_out) stack selected alone
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held_e = torch.cuda.memory_allocated()
        adapt_mod._select(params["blocks"]["wgate"]["w"], TRAIN_K, "magnitude")
        torch.cuda.synchronize()
        expert_peak = torch.cuda.max_memory_allocated() - held_e
    log(f"[{tag}] {arch} {base} base ({base_bytes:,} bytes), NeuroAda k={TRAIN_K} "
        f"magnitude: trainable {st['trainable']:,} of {st['total']:,} "
        f"({100 * st['fraction']:.4f} %), selection {select_s:.3f} s ({n_select} topk_select "
        f"launches, peak {select_peak / 2**20:.1f} MiB above the {held / 2**30:.2f} GiB held "
        f"before it) [{card}]")
    must, must_not = path_kernels(base, cfg, long)
    data = DataLoader("lm", cfg.vocab_size, batch, seq, seed=0)
    try:
        for _ in range(TRAIN_WARMUP):
            trainer.step(next(data))
        fingerprint = packed_fingerprint(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        times, losses, peak = [], [], 0
        for _ in range(steps):
            step_batch = next(data)
            t0 = time.perf_counter()
            m = trainer.step(step_batch)  # returns floats: waits for the device
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
        per_step = {n: v / steps for n, v in launches.items()}
        want = step_launches(cfg, base, long)
        assert per_step == want, (per_step, want)
        # every base matmul of a step (M = batch x seq rows) on the TMA + wgmma route
        routes = {n: dict(COUNTERS[n].routes) for n in ("fused_linear", "fused_linear_q")
                  if COUNTERS[n].kernel}
        assert routes and all(r == {"wgmma": COUNTERS[n].kernel} for n, r in routes.items()), \
            routes
        # every value gradient in one launch a call (the ranges merged inside)
        dv = COUNTERS["sparse_delta_dval"]
        assert dv.kernel > 0 and dv.routes == {sd_mod.DVAL_ROUTE: dv.kernel}, dv.routes
        routes["sparse_delta_dval"] = dict(dv.routes)
        if long:  # every flash launch of the long-context steps on the wgmma route
            fr = dict(COUNTERS["flash_attention_fwd"].routes)
            assert fr == {"wgmma": launches["flash_attention_fwd"]}, fr
            routes["flash_attention_fwd"] = fr
        assert all(np.isfinite(losses)), losses
        prof = f"{tag.replace('-', '_')}_profile.txt"
        buckets = {}
        busy, _, _ = profile_run(lambda: trainer.step(next(data)), card, f"{tag}-profile",
                                 prof, buckets)
    finally:
        data.close()
    med = float(np.median(times))
    log(f"[{tag}] losses {[round(x, 4) for x in losses]} (all finite) [{card}]")
    log(f"[{tag}] {steps} steps of batch {batch} x seq {seq}: step time "
        f"median {med * 1e3:.2f} ms (min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}); "
        f"{tok / med:.0f} training tokens/s; peak memory {peak / 2**30:.2f} GiB; base "
        f"{base_bytes:,} bytes; launches per step {json.dumps(per_step)} (routes "
        f"{json.dumps(routes)}), plain 0; device busy {busy:.1%} of a profiled step [{card}]")
    result = {"card": card, "base": base, "base_bytes": base_bytes, "losses": losses,
              "step_s": times, "tokens_per_step": tok, "peak_bytes": peak,
              "launches_per_step": per_step, "routes": routes, "busy_share": busy,
              "trainable": st["trainable"], "fraction": st["fraction"],
              "select_s": select_s, "select_launches": n_select,
              "select_peak_bytes_above_held": select_peak,
              "profiled_step_device_us_by_bucket": buckets}
    with open(os.path.join(OUT_DIR, f"{tag.replace('-', '_')}.json"), "w") as f:
        json.dump(dict(result, arch=arch), f, indent=1)
    out = {"launches": launches, "peak": peak, "median_s": med, "select_launches": n_select,
           "select_s": select_s, "select_peak": select_peak, "expert_select_peak": expert_peak,
           "buckets": buckets}
    out["base_bytes"] = base_bytes
    if moe:
        out["serve_launches"] = serve_moe(model, params, trainer, card, base)
    elif not long:
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


def serve_moe(model, params, trainer, card: str, base: str = "bf16") -> dict:
    """Full-width olmoe serving: the trained adapter (exported and loaded
    back) as tenant 1 beside two random tenants on its indices and the base,
    with phase 5's engine settings and prompts, on the base it was trained
    on. The gate run (every request ends, the paged serving kernels
    launched — on a packed base also ``fused_linear_q``, 4 a layer-forward
    and the head's — and no training kernel, no plain version, one transfer
    a step, the pool drains, pool bytes as reckoned). On the bf16 base the
    same run profiled (busy share, launches per layer-forward), one window
    run, and a gate run on each int8 KV cache (paged and dense); on the int8
    base a gate run with the int8 self-drafter. Returns the gate runs'
    launches of the serving kernels."""
    suffix = "" if base == "bf16" else f"-{base}"
    tag = f"serve-olmoe{suffix}"
    # 26 MB a file: in the scratch directory, not the output directory
    path = os.path.join(SCRATCH, f"train-olmoe{suffix}_adapter.npz")
    export_adapter(path, trainer.aux, trainer.state.trainable, {"arch": model.cfg.name})
    idx, val = load_adapter(path)
    nbytes = os.path.getsize(path)
    shutil.rmtree(SCRATCH, ignore_errors=True)
    idx, val = (map_leaves(lambda x: None if x is None else x.cuda(), t) for t in (idx, val))
    tenants = [(idx, val)] + random_tenants(params, 2, seed=9, dtype=torch.bfloat16,
                                            device="cuda", idx=idx)
    rng = np.random.default_rng(11)
    lens = [40, 700, 130, 256, 511, 64, 300, 620, 90, 410]
    prompts = [rng.integers(3, model.cfg.vocab_size, size=n).tolist() for n in lens]
    max_new = 32
    kw = dict(slots=SLOTS, max_len=MAX_LEN, prefill_chunk=PREFILL_CHUNK,
              decode_chunk=DECODE_CHUNK, page_size=PAGE)
    allowed = SERVING + (PACKED_BASE if base != "bf16" else ())
    serve(model, params, tenants, prompts[:2], 2, "cuda", **kw)  # warm-up
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    with forwards_never_wait(model):
        eng, reqs = serve(model, params, tenants, prompts, max_new, "cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = {name: c.kernel for name, c in COUNTERS.items()}
    decode_routes(tag)
    apply_routes(tag)
    for name, c in COUNTERS.items():
        assert c.plain == 0, f"olmoe serving called the plain version of {name}"
        assert name in allowed or c.kernel == 0, f"olmoe serving launched {name}"
        assert name not in allowed or c.kernel > 0, f"olmoe serving never launched {name}"
    forwards = forwards_of(eng)
    if base != "bf16":  # 4 attention projections a layer-forward and the head a forward
        assert n["fused_linear_q"] == 4 * forwards + forwards // model.cfg.num_layers, \
            (n["fused_linear_q"], forwards)
    for r in reqs:
        assert r.done and r.reason in ("eos", "max_new"), (r.rid, r.reason, len(r.out))
    assert {r.adapter_id for r in reqs} == {0, 1, 2, 3}
    assert eng.transfers == eng.steps, (eng.transfers, eng.steps)
    assert eng.kv.drained(), "olmoe block pool not fully free after the run"
    pool = eng.kv.pool_bytes()
    assert pool == MOE_POOL_BYTES == reckoned_pool_bytes(model.cfg, "fp32"), pool
    n_tok = sum(len(r.out) for r in reqs)
    st = eng.step_times
    out = {k: n[k] for k in allowed}
    log(f"[{tag}] trained adapter ({nbytes:,} bytes) as tenant 1 beside 2 "
        f"random tenants and the base, {base} base ({tree_bytes(params):,} bytes): "
        f"{len(reqs)} requests, {n_tok} tokens in {wall:.3f} s: "
        f"{n_tok / wall:.1f} tok/s; steps {eng.steps} (mixed {len(st['mixed'])} x "
        f"{float(np.mean(st['mixed'])) * 1e3:.2f} ms, decode {len(st['decode'])} x "
        f"{float(np.mean(st['decode'])) * 1e3:.2f} ms); pool {pool:,} bytes (as reckoned); "
        f"launches {json.dumps(out)}, plain 0 [{card}]")
    if base == "int8":
        out["spec"] = moe_spec_gate(model, params, tenants, prompts, max_new, kw, card,
                                    [r.out for r in reqs])
    if base != "bf16":
        return out
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
    for paged in (True, False):
        out.update(moe_kv_gate(model, params, tenants, prompts, max_new, kw, card, paged))
    return out


def moe_kv_gate(model, params, tenants, prompts, max_new, kw, card: str, paged: bool) -> dict:
    """One olmoe gate run on an int8 KV cache (paged, or the dense slot
    cache): every request ends, the int8 attention kernels of that layout
    launched and no other attention kernel, no plain version, one transfer
    a step, the cache drains, pool bytes as reckoned (int8 codes and float32
    scales). Returns its attention launches."""
    name = f"{'paged' if paged else 'dense'}-int8"
    kw = dict(kw, paged=paged, kv_dtype="int8")
    if not paged:
        kw.pop("page_size")
    mine, others = attention_names(paged, "int8")
    serve(model, params, tenants, prompts[:2], 2, "cuda", **kw)  # warm-up
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    with forwards_never_wait(model):
        eng, reqs = serve(model, params, tenants, prompts, max_new, "cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = {c.name: c.kernel for c in COUNTERS.values()}
    decode_routes(f"serve-olmoe-{name}")
    apply_routes(f"serve-olmoe-{name}")
    for c in COUNTERS.values():
        assert c.plain == 0, f"olmoe {name} serving called the plain version of {c.name}"
        assert c.name not in others or c.kernel == 0, f"olmoe {name} serving launched {c.name}"
        assert c.name not in TRAINING + SINGLE_TENANT + PACKED_BASE or c.kernel == 0, c.name
    assert all(n[m] > 0 for m in mine + ("sparse_delta_batched",)), n
    for r in reqs:
        assert r.done and r.reason in ("eos", "max_new"), (r.rid, r.reason, len(r.out))
    assert eng.transfers == eng.steps, (eng.transfers, eng.steps)
    assert eng.kv.drained(), f"olmoe {name} cache not drained after the run"
    pool = eng.kv.pool_bytes()
    want = reckoned_pool_bytes(model.cfg, "int8")
    assert pool == want == MOE_POOL_BYTES_INT8, (pool, want)
    n_tok = sum(len(r.out) for r in reqs)
    log(f"[serve-olmoe-{name}] {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s: "
        f"{n_tok / wall:.1f} tok/s; steps {eng.steps}; pool {pool:,} bytes (as reckoned; bf16 "
        f"{MOE_POOL_BYTES:,}, {pool / MOE_POOL_BYTES:.1%}); attention launches "
        f"{json.dumps({m: n[m] for m in mine})}, plain 0 [{card}]")
    return {f"{m} ({name})": n[m] for m in mine}


def moe_spec_gate(model, params, tenants, prompts, max_new, kw, card: str, off_outs) -> dict:
    """The gate run again with the int8 self-drafter on the packed olmoe
    base (the served tree is the drafter's: one base, no extra bytes):
    every request ends, one transfer a step, the pool drains, no plain
    version, drafts accepted. Its tokens are not draft="off"'s even in
    exact arithmetic: a verify chunk routes its 40 tokens in 4 groups of
    10, where a decode step routes 8 in one group, and an expert's capacity
    (8) then drops other assignments. So the tie rule is held where no
    assignment can drop: the same model at capacity_factor E / K (every
    expert can take every token of its group), off and int8-spec gate runs,
    greedy tokens equal but where a bf16 near-tie (SPEC_TIE_ULPS) of the
    teacher-forced logits let them part. Returns drafted / accepted
    counts and the launches."""
    cfg = model.cfg
    spec_kw = dict(kw, draft="int8", spec_k=SPEC_K)

    def gate(m, kwargs):
        serve(m, params, tenants, prompts[:2], 2, "cuda", **kwargs)  # warm-up
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        with forwards_never_wait(m):
            eng, reqs = serve(m, params, tenants, prompts, max_new, "cuda", **kwargs)
        torch.cuda.synchronize()
        for c in COUNTERS.values():
            assert c.plain == 0, f"olmoe spec serving called the plain version of {c.name}"
        for r in reqs:
            assert r.done and r.reason in ("eos", "max_new"), (r.rid, r.reason, len(r.out))
        assert eng.transfers == eng.steps, (eng.transfers, eng.steps)
        assert eng.kv.drained(), "olmoe pool not drained after the run"
        return eng, reqs, time.perf_counter() - t0

    eng, reqs, wall = gate(model, spec_kw)
    assert eng.draft_params is eng.params, "the int8 drafter must share the int8 base"
    assert eng.spec_accepted > 0, (eng.spec_drafted, eng.spec_accepted)
    launches = {c.name: c.kernel for c in COUNTERS.values() if c.kernel}
    n_tok = sum(len(r.out) for r in reqs)
    same = sum(r.out == o for r, o in zip(reqs, off_outs))
    log(f"[serve-olmoe-int8-spec] int8 self-drafter, spec_k {SPEC_K}: {len(reqs)} requests, "
        f"{n_tok} tokens in {wall:.3f} s ({n_tok / wall:.1f} tok/s); drafted "
        f"{eng.spec_drafted}, accepted {eng.spec_accepted} "
        f"({eng.spec_accepted / eng.spec_drafted:.3f}); {same} of {len(reqs)} requests "
        f"token-identical to draft=off (capacity drops differ between a verify chunk and a "
        f"decode step); launches {json.dumps(launches)} [{card}]")
    nodrop = get_model(cfg.replace(capacity_factor=cfg.num_experts / cfg.experts_per_token))
    _, off_reqs, _ = gate(nodrop, kw)
    neng, nreqs, _ = gate(nodrop, spec_kw)
    off2 = [r.out for r in off_reqs]
    gaps = divergence_gaps(nodrop, neng, nreqs, off2, prompts)
    assert all(near for *_, near in gaps), f"olmoe int8 drafter parted from off off a tie: {gaps}"
    same2 = sum(r.out == o for r, o in zip(nreqs, off2))
    log(f"[serve-olmoe-int8-spec] at capacity_factor {cfg.num_experts // cfg.experts_per_token} "
        f"(no assignment can drop): {same2} of {len(nreqs)} requests token-identical to "
        f"draft=off, partings at near-ties {[(rid, i, round(u, 2)) for rid, i, _, u, _ in gaps]}; "
        f"drafted {neng.spec_drafted}, accepted {neng.spec_accepted} [{card}]")
    return {"drafted": eng.spec_drafted, "accepted": eng.spec_accepted, "launches": launches,
            "same_as_off": same, "nodrop_same_as_off": same2}


# ------------------------------------------------- the training lifecycle
# remat: the three modes at the 4 x 512 step, REMAT_STEPS measured steps
# after TRAIN_WARMUP each; the long-context run under "full" as well
REMAT_MODES, REMAT_STEPS = ("none", "full", "dots"), 3
# a scratch directory inside the checkout for checkpoints and the merged
# export (3.1 GB for qwen2-1.5b in bf16), removed when the phase ends
SCRATCH = os.path.join(ROOT, "_chip", "lifecycle")


def remat_steps(model, params, mode: str, batch: int, seq: int) -> dict:
    """A Trainer under ``remat=mode``: TRAIN_WARMUP steps (the first
    step's loss kept), then REMAT_STEPS measured (step times, peak memory,
    launches a step; no plain version)."""
    cfg = model.cfg
    tcfg = TrainConfig(steps=TRAIN_WARMUP + REMAT_STEPS + 1, learning_rate=TRAIN_LR, remat=mode)
    trainer = Trainer(model, get_peft(PeftConfig(k=TRAIN_K)), tcfg, params)
    data = DataLoader("lm", cfg.vocab_size, batch, seq, seed=0)
    try:
        first = trainer.step(next(data))["loss"]
        for _ in range(TRAIN_WARMUP - 1):
            trainer.step(next(data))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        times, losses = [], []
        for _ in range(REMAT_STEPS):
            b = next(data)
            t0 = time.perf_counter()
            m = trainer.step(b)
            times.append(time.perf_counter() - t0)
            losses.append(m["loss"])
            assert m["skipped"] == 0, m
        peak = torch.cuda.max_memory_allocated()
    finally:
        data.close()
    for name, c in COUNTERS.items():
        assert c.plain == 0, f"remat {mode} called the plain version of {name}"
    per_step = {n: COUNTERS[n].kernel / REMAT_STEPS for n in
                ("fused_linear", "sparse_delta_dval", "flash_attention_fwd")}
    del trainer
    torch.cuda.empty_cache()
    return {"first_loss": first, "losses": losses, "peak": peak, "step_s": times,
            "median_s": float(np.median(times)), "per_step": per_step}


def phase_remat(card: str, long_none_peak: int) -> dict:
    """Full-width qwen2-1.5b (bf16 base) at batch 4 x seq 512 under remat
    ``none``, ``full`` and ``dots``: the first step's loss bit-equal across
    the modes; per step ``fused_linear`` 392 (full: the forward again in the
    backward) / 196 (dots: its outputs kept) / 196 launches and
    ``sparse_delta_dval`` 196 in every mode; ``full`` peaks below ``none``,
    ``dots`` at most at it. Then ``full`` on the 1 x 4096 long-context
    step: 56 flash forward launches a step, and a peak below the same
    call's ``none`` run (``long_none_peak``)."""
    cfg = get_config("qwen2-1.5b")
    model = get_model(cfg)
    params = model.init(seed=0, device="cuda")
    L = cfg.num_layers
    res = {mode: remat_steps(model, params, mode, TRAIN_BATCH, TRAIN_SEQ) for mode in REMAT_MODES}
    none, full, dots = (res[m] for m in REMAT_MODES)
    assert none["first_loss"] == full["first_loss"] == dots["first_loss"], \
        {m: r["first_loss"] for m, r in res.items()}
    want = {"none": 7 * L, "full": 14 * L, "dots": 7 * L}
    for mode, r in res.items():
        assert r["per_step"]["fused_linear"] == want[mode], (mode, r["per_step"])
        assert r["per_step"]["sparse_delta_dval"] == 7 * L, (mode, r["per_step"])
        assert r["per_step"]["flash_attention_fwd"] == 0, (mode, r["per_step"])
        log(f"[remat-{mode}] qwen2-1.5b bf16 {TRAIN_BATCH} x {TRAIN_SEQ}, {REMAT_STEPS} steps "
            f"after {TRAIN_WARMUP}: first loss {r['first_loss']!r}; step median "
            f"{r['median_s'] * 1e3:.2f} ms (min {min(r['step_s']) * 1e3:.2f}, max "
            f"{max(r['step_s']) * 1e3:.2f}); peak {r['peak'] / 2**30:.2f} GiB; launches a step "
            f"{json.dumps(r['per_step'])}, plain 0 [{card}]")
    assert full["peak"] < none["peak"], (full["peak"], none["peak"])
    assert dots["peak"] <= none["peak"], (dots["peak"], none["peak"])
    log(f"[remat] first losses bit-equal across none / full / dots; peaks "
        f"{none['peak'] / 2**30:.2f} / {full['peak'] / 2**30:.2f} / {dots['peak'] / 2**30:.2f} "
        f"GiB (full saves {(none['peak'] - full['peak']) / 2**30:.2f} GiB); step time "
        f"{full['median_s'] / none['median_s']:.3f}x / {dots['median_s'] / none['median_s']:.3f}x "
        f"none's [{card}]")
    long = remat_steps(model, params, "full", LONG_BATCH, LONG_SEQ)
    assert long["per_step"]["flash_attention_fwd"] == 2 * L, long["per_step"]
    assert long["per_step"]["fused_linear"] == 14 * L, long["per_step"]
    assert long["peak"] < long_none_peak, (long["peak"], long_none_peak)
    log(f"[remat-full-long] qwen2-1.5b bf16 {LONG_BATCH} x {LONG_SEQ} under full: step median "
        f"{long['median_s'] * 1e3:.2f} ms; peak {long['peak'] / 2**30:.2f} GiB (none's in this "
        f"call {long_none_peak / 2**30:.2f}); launches a step {json.dumps(long['per_step'])} "
        f"[{card}]")
    res["full-long"] = long
    with open(os.path.join(OUT_DIR, "train_remat.json"), "w") as f:
        json.dump({"card": card, "long_none_peak": long_none_peak, **res}, f, indent=1)
    del params
    torch.cuda.empty_cache()
    return res


def phase_reduced_remat(card: str, arch: str) -> None:
    """Reduced ``arch`` in fp32 on the card, three AdamW steps under each
    remat mode with deterministic algorithms on (for the scatter-adds of
    autograd's own backwards, those of the MoE's gathers; the port's sparse
    dx is deterministic by itself): losses and values of ``full`` and
    ``dots`` equal ``none``'s bit for bit."""
    cfg, model, params, batches = reduced_train_case(arch, "bf16", 4, 16)
    params = map_leaves(lambda x: None if x is None else x.cuda(), params)
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for mode in REMAT_MODES:
            reset_counters()
            runs[mode] = train_run(model, params, PeftConfig(k=2, delta_dtype="float32"),
                                   TrainConfig(steps=3, learning_rate=TRAIN_LR, remat=mode),
                                   batches)
            assert all(c.plain == 0 for c in COUNTERS.values())
    finally:
        torch.use_deterministic_algorithms(False)
    for mode in ("full", "dots"):
        assert runs[mode][0] == runs["none"][0], (mode, runs[mode][0], runs["none"][0])
        for (p, a), (_, b) in zip(flatten(runs["none"][1]), flatten(runs[mode][1])):
            assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), (mode, p)
    log(f"[reduced-remat] reduced {arch} fp32, 3 steps on the card: losses "
        f"{[f'{x:.7f}' for x in runs['none'][0]]} and every value bit-equal under none / "
        f"full / dots [{card}]")


def sparse_dx_shapes(cfg) -> list:
    """(d_in, d_out) of a dense layer's 7 adapted projections."""
    d, f, kv = cfg.d_model, cfg.d_ff, cfg.num_kv_heads * cfg.resolved_head_dim
    return [(d, d), (d, kv), (d, kv), (d, d), (d, f), (d, f), (f, d)]


def index_add_dx(idx, val, dy, d_in: int):
    """The sparse dx as the ordered segment sum replaced it, the yardstick
    it is timed against: a float32 ``index_add_`` (2-D) or ``scatter_add_``
    (batched) of the materialised terms, whose float atomics on the card
    add in no fixed order."""
    if dy.ndim == 3:
        b, m, _ = dy.shape
        kd = idx.shape[1] * idx.shape[2]
        upd = (dy.float()[:, :, None, :] * val.float()[:, None]).reshape(b, m, kd)
        ind = idx.long().reshape(b, 1, kd).expand(b, m, kd)
        return torch.zeros((b, m, d_in), device=dy.device).scatter_add_(2, ind, upd)
    upd = (dy.float()[:, None, :] * val.float()[None]).reshape(dy.shape[0], -1)
    return torch.zeros((dy.shape[0], d_in), device=dy.device).index_add_(
        1, idx.reshape(-1).long(), upd)


def sparse_dx_variants(card: str) -> None:
    """``--sparse-dx``: the sparse dx check and two resumes (steps 3 and 4
    bit-equal each time), then the qwen2 4 x 512 training step with the
    ordered dx and with ``index_add_dx`` in turn (ordered, index_add_,
    index_add_, ordered), all in one call."""
    for _ in range(2):
        phase_resume(card)
    ordered, steps = ref.sparse_delta_dx_ref, {}
    try:
        for name in ("ordered", "index_add_", "index_add_", "ordered"):
            ref.sparse_delta_dx_ref = ordered if name == "ordered" else index_add_dx
            steps.setdefault(name, []).append(phase_train(card, "bf16")["median_s"] * 1e3)
    finally:
        ref.sparse_delta_dx_ref = ordered
    log(f"[sparse-dx] qwen2-1.5b {TRAIN_BATCH} x {TRAIN_SEQ} step medians, ms, in turn: "
        + "; ".join(f"{n} {[round(t, 2) for t in ts]}" for n, ts in steps.items()) + f" [{card}]")


def check_sparse_dx(card: str) -> dict:
    """The training backward's sparse dx (``ref.sparse_delta_dx_ref``, plain
    PyTorch) at qwen2's 4 x 512 shapes, k = TRAIN_K, a bf16 dy: two calls on
    the card identical bit for bit and equal to the CPU's bit for bit (each
    column summed in one fixed order), also with every term on 7 columns;
    then its device time a step (7 projections x 28 layers) beside the
    ``index_add_`` scatter it replaced, whose float atomics add in no fixed
    order."""
    cfg = get_config("qwen2-1.5b")
    gen = torch.Generator(device="cuda").manual_seed(7)
    m = TRAIN_BATCH * TRAIN_SEQ
    new_ms = old_ms = 0.0
    for d_in, d_out in sparse_dx_shapes(cfg):
        idx = torch.randint(0, d_in, (TRAIN_K, d_out), device="cuda", generator=gen)
        val = torch.randn((TRAIN_K, d_out), device="cuda", generator=gen)
        dy = torch.randn((m, d_out), device="cuda", generator=gen).bfloat16()
        for ix in (idx, idx % 7):
            got = ref.sparse_delta_dx_ref(ix, val, dy, d_in)
            assert torch.equal(got, ref.sparse_delta_dx_ref(ix, val, dy, d_in)), (d_in, d_out)
            cpu = ref.sparse_delta_dx_ref(ix.cpu(), val.cpu(), dy.cpu(), d_in)
            assert torch.equal(got.cpu(), cpu), (d_in, d_out)
        new_ms += cuda_ms(lambda: ref.sparse_delta_dx_ref(idx, val, dy, d_in))
        old_ms += cuda_ms(lambda: index_add_dx(idx, val, dy, d_in))
    layers = cfg.num_layers
    log(f"[sparse-dx] qwen2-1.5b {TRAIN_BATCH} x {TRAIN_SEQ}, k={TRAIN_K}: the 7 projections' dx "
        f"on the card twice bit-equal and equal to the CPU's (also with every term on 7 "
        f"columns); {new_ms * layers:.2f} ms a step by the ordered segment sum against "
        f"{old_ms * layers:.2f} ms by index_add_'s atomics ({layers} layers) [{card}]")
    return {"dx_ms_step": new_ms * layers, "index_add_ms_step": old_ms * layers}


def phase_resume(card: str) -> dict:
    """Checkpoint and resume through ``Trainer`` at full width (qwen2-1.5b
    bf16, 4 x 512), the checkpoints in a scratch directory. Run A: 4 steps,
    a save at step 2 (its copy to the host and its file write timed). Run
    B: a fresh Trainer resumes from A's step-2 file and runs to 4. B's
    restored values and moments equal A's state at 2 bit for bit, and B's
    step-3 and step-4 losses equal A's bit for bit: the backward has no
    float atomics (the sparse dx sums each column in a fixed order), so a
    resumed run repeats the uninterrupted one exactly."""
    dx = check_sparse_dx(card)
    cfg = get_config("qwen2-1.5b")
    model = get_model(cfg)
    params = model.init(seed=0, device="cuda")
    dir_a, dir_b = os.path.join(SCRATCH, "ckpt_a"), os.path.join(SCRATCH, "ckpt_b")
    for d in (dir_a, dir_b):
        shutil.rmtree(d, ignore_errors=True)
    mk = lambda d: Trainer(model, get_peft(PeftConfig(k=TRAIN_K)),  # noqa: E731
                           TrainConfig(steps=4, learning_rate=TRAIN_LR, checkpoint_every=2,
                                       checkpoint_dir=d, log_every=0), params)
    a = mk(dir_a)
    data = DataLoader("lm", cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    try:
        a.run(data, steps=2)  # saves at 2 and waits
        copy_s, write_s = a.ckpt.last_copy_s, a.ckpt.last_write_s
        at2 = {p: x.clone() for p, x in flatten({"trainable": a.state.trainable,
                                                 "opt_state": a.state.opt_state})
               if x is not None}
        shutil.copytree(dir_a, dir_b)
        a.run(data, steps=4)
    finally:
        data.close()
    want = [h["loss"] for h in a.history]
    nbytes = os.path.getsize(os.path.join(dir_b, "ckpt_00000002.npz"))
    b = mk(dir_b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start = b.try_resume()
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    assert start == 2 and int(b.state.step) == 2, start
    got = dict(flatten({"trainable": b.state.trainable, "opt_state": b.state.opt_state}))
    assert set(p for p, x in got.items() if x is not None) == set(at2)
    for p, x in at2.items():
        y = got[p]
        assert y.device.type == "cuda" and y.dtype == x.dtype and torch.equal(x, y), p
    data = DataLoader("lm", cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0, start_step=start)
    try:
        b.run(data, steps=4)
    finally:
        data.close()
    got_loss = [h["loss"] for h in b.history]
    assert got_loss == want[2:], (got_loss, want)
    assert b.ckpt.steps() == [2, 4]
    log(f"[resume] qwen2-1.5b bf16 {TRAIN_BATCH} x {TRAIN_SEQ}: A's losses {want}; B resumed "
        f"at step {start} in {resume_s * 1e3:.1f} ms (values and moments bit-equal to A's at "
        f"2), its losses {got_loss} (steps 3 and 4 bit-equal); a save: host copy "
        f"{copy_s * 1e3:.1f} ms on the training thread, file write {write_s * 1e3:.1f} ms "
        f"behind it ({nbytes:,} bytes) [{card}]")
    out = {"card": card, "losses_a": want, "losses_b": got_loss, "resume_s": resume_s,
           "save_copy_s": copy_s, "save_write_s": write_s, "bytes": nbytes, **dx}
    with open(os.path.join(OUT_DIR, "train_resume.json"), "w") as f:
        json.dump(out, f, indent=1)
    shutil.rmtree(SCRATCH, ignore_errors=True)
    del params, a, b
    torch.cuda.empty_cache()
    return out


REQ_LINE = re.compile(r"^req(\d+) \[(\w+)\]: prompt=\[[^\]]*\] -> \[([^\]]*)\]$")


def launcher_tokens(main, argv) -> list:
    """Run a launcher's ``main(argv)`` on the card, its stdout captured;
    the greedy tokens it printed, by request id."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    text = buf.getvalue()
    for line in text.splitlines():
        LOG.append("[launcher] " + line)
    outs = {}
    for line in text.splitlines():
        m = REQ_LINE.match(line)
        if m:
            outs[int(m.group(1))] = [int(t) for t in m.group(3).split(",") if t.strip()]
    return [outs[i] for i in sorted(outs)]


def phase_export(card: str) -> dict:
    """``launch/train.py --export`` (and ``--export-adapter``) of full-width
    qwen2-1.5b (bf16, 4 x 512, 2 steps), then ``launch/serve.py`` on the
    card: ``--params`` the merged export for the 10-prompt gate run, and the
    unmerged tenant on the same base (seed 0) with every request on it. The
    greedy tokens agree but where a bf16 near-tie of the unmerged model's
    teacher-forced logits (SPEC_TIE_ULPS) let them part. Times the export's
    write and the load."""
    shutil.rmtree(SCRATCH, ignore_errors=True)
    os.makedirs(SCRATCH)
    merged, adapter = os.path.join(SCRATCH, "merged.npz"), os.path.join(SCRATCH, "tenant.npz")
    cfg = get_config("qwen2-1.5b")
    model = get_model(cfg)
    t0 = time.perf_counter()
    launch_train.main(["--arch", cfg.name, "--task", "lm", "--steps", "2", "--batch",
                       str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--k", str(TRAIN_K),
                       "--export", merged, "--export-adapter", adapter])
    train_s = time.perf_counter() - t0
    size = os.path.getsize(merged)
    rng = np.random.default_rng(11)
    lens = [40, 700, 130, 256, 511, 64, 300, 620, 90, 410]
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist() for n in lens]
    argv = ["--arch", cfg.name, "--prompts", ";".join(",".join(map(str, p)) for p in prompts),
            "--max-new", "32", "--slots", str(SLOTS), "--max-len", str(MAX_LEN),
            "--prefill-chunk", str(PREFILL_CHUNK), "--decode-chunk", str(DECODE_CHUNK)]
    reset_counters()
    t0 = time.perf_counter()
    got = launcher_tokens(launch_serve.main, argv + ["--params", merged])
    serve_s = time.perf_counter() - t0
    n = {c.name: c.kernel for c in COUNTERS.values()}
    for c in COUNTERS.values():
        assert c.plain == 0, f"serve --params called the plain version of {c.name}"
    assert n["sparse_delta_batched"] == 0 and n["fused_linear_q"] == 0, n  # one merged tenant
    assert n["paged_decode_attention"] > 0 and n["paged_prefill_attention"] > 0, n
    want = launcher_tokens(launch_serve.main,
                           argv + ["--adapters", adapter, "--adapter-ids", ",".join(["1"] * 10)])
    assert len(got) == len(want) == 10
    same = sum(a == b for a, b in zip(got, want))
    gaps = []
    if same < 10:  # teacher-force the unmerged model at each parting
        params = model.init(seed=0, device="cuda")
        idx, val = load_adapter(adapter)
        idx, val = (map_leaves(lambda x: None if x is None else x.cuda(), t) for t in (idx, val))
        eng = engine_for(model, params, [(idx, val)], [], 1, "cuda", slots=SLOTS,
                         max_len=MAX_LEN)
        reqs = [types.SimpleNamespace(rid=i, out=o, adapter_id=1) for i, o in enumerate(got)]
        gaps = divergence_gaps(model, eng, reqs, want, prompts)
        del params, eng
    assert all(near for *_, near in gaps), f"merged export parted from the tenant off a tie: {gaps}"
    log(f"[export] train --export of qwen2-1.5b bf16 (2 steps, {train_s:.1f} s with init, "
        f"selection and the write): {size:,} bytes; serve --params merged.npz, gate run of 10 "
        f"prompts x 32 new through the launcher ({serve_s:.1f} s with the load and init): "
        f"{same} of 10 requests token-identical to the unmerged tenant on the same base, "
        f"partings at near-ties {[(rid, i, round(u, 2)) for rid, i, _, u, _ in gaps]}; "
        f"launches {json.dumps({k: v for k, v in n.items() if v})}, plain 0 [{card}]")
    shutil.rmtree(SCRATCH, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"bytes": size, "same": same, "gaps": gaps, "train_s": train_s, "serve_s": serve_s}


def phase_reduced_export(card: str) -> None:
    """Reduced qwen2-1.5b in fp32 on the card: three training steps, the
    merged export and the base written with ``save_pytree``, served through
    ``launch/serve.py --params`` (merged; base + the unmerged tenant): the
    same greedy tokens."""
    cfg, model, params, batches = reduced_train_case("qwen2-1.5b", "bf16", 4, 16)
    params = map_leaves(lambda x: None if x is None else x.cuda(), params)
    trainer = Trainer(model, get_peft(PeftConfig(k=2, delta_dtype="float32")),
                      TrainConfig(steps=3, learning_rate=TRAIN_LR), params)
    trainer.run(iter(batches))
    shutil.rmtree(SCRATCH, ignore_errors=True)
    os.makedirs(SCRATCH)
    merged, base, adapter = (os.path.join(SCRATCH, n) for n in ("m.npz", "b.npz", "a.npz"))
    save_pytree(merged, trainer.merged_params())
    save_pytree(base, params)
    export_adapter(adapter, trainer.aux, trainer.state.trainable)
    real = launch_serve.reduced
    launch_serve.reduced = lambda c: real(c).replace(dtype="float32")
    try:
        rng = np.random.default_rng(0)
        prompts = ";".join(",".join(map(str, rng.integers(3, cfg.vocab_size, size=n)))
                           for n in (5, 37, 12, 70, 3))
        argv = ["--reduced", "--prompts", prompts, "--max-new", "10", "--slots", "3"]
        got = launcher_tokens(launch_serve.main, argv + ["--params", merged])
        want = launcher_tokens(launch_serve.main, argv + ["--params", base, "--adapters", adapter,
                                                         "--adapter-ids", "1,1,1,1,1"])
    finally:
        launch_serve.reduced = real
        shutil.rmtree(SCRATCH, ignore_errors=True)
    assert got == want, (got, want)
    log(f"[reduced-export] reduced qwen2-1.5b fp32: serve --params of the merged export gives "
        f"the unmerged tenant's greedy tokens on the card, all {len(got)} requests "
        f"({sum(map(len, got))} tokens) [{card}]")


# ------------------------------------------ PEFT methods and strategies (slice 13)


def trainable_grads(model, peft, params, trainable, aux, batch) -> dict:
    """{path: the step's gradient} of the trainable tree on ``batch``
    (after ``post_grad``), as the train step forms it."""
    live = map_leaves(lambda v: None if v is None else v.detach().requires_grad_(), trainable)
    leaves = [v for _, v in flatten(live) if v is not None]
    eff, ad = peft.model_inputs(params, live, aux)
    loss = model.loss(eff, ad, batch)[0]
    gs = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
    grads = map_leaves(lambda v: None if v is None else next(gs), live)
    grads = map_leaves(lambda v, g: None if v is None else torch.zeros_like(v) if g is None else g,
                       live, grads)
    return {p: g for p, g in flatten(peft.post_grad(grads, aux)) if g is not None}


def warmup_grads(model, params, batch: dict):
    """|dL/dW| of every parameter on one batch, in float32: the
    ``gradient`` strategy's scores (the port's twin of
    ``benchmarks/fig7_selection_strategies.py``'s ``_warmup_grads``)."""
    grads = trainable_grads(model, get_peft(PeftConfig(method="full")), params, params, None,
                            batch)
    return unflatten([(p, grads.pop(p).abs().float()) for p in list(grads)])


def device_batch(batch: dict, dev) -> dict:
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def method_steps(model, peft, params, trainable, aux, batches, rho: bool):
    """Three AdamW steps of ``peft`` from ``trainable`` on ``params``'
    device: (losses, {path: the move over the steps}, {path: ρ} when
    ``rho``). ρ is an entry's gradient rounding (1e-5 of its leaf's largest
    |g| plus 1e-7 of the tree's) over its |g|, the largest over the steps
    (steps where g is exactly 0 do not count)."""
    dev = next(x for _, x in flatten(params) if x is not None).device
    step, opt = make_train_step(model, peft, TrainConfig(steps=len(batches),
                                                         learning_rate=TRAIN_LR))
    start = {p: x.clone() for p, x in flatten(trainable) if x is not None}
    state = TrainState(trainable, opt.init(trainable),
                       torch.zeros((), dtype=torch.int32, device=dev))
    losses, rhos = [], {}
    for b in batches:
        b = device_batch(b, dev)
        if rho:
            g = {p: x.abs().double() for p, x in trainable_grads(model, peft, params,
                                                                  state.trainable, aux, b).items()}
            top = max(float(x.max()) for x in g.values())
            for p, a in g.items():
                r = torch.where(a > 0, (1e-5 * float(a.max()) + 1e-7 * top) / a.clamp(min=1e-300),
                                0.0)
                rhos[p] = torch.maximum(rhos[p], r) if p in rhos else r
        state, m = step(params, aux, state, b)
        losses.append(float(m["loss"]))
        assert int(m["skipped"]) == 0, m
    moves = {p: (x.double() - start[p].double()) for p, x in flatten(state.trainable)
             if x is not None}
    return losses, moves, rhos


def compare_moves(want: dict, got: dict, rho: dict) -> dict:
    """Card moves against the CPU's, entry by entry, by the rule of
    ``tests/test_torch_peft.py``: |Δ_card − Δ_cpu| ≤ 1e-5·|Δ_cpu| + 1e-4·lr
    + 3·lr·min(ρ, 2) (``worst``: the largest share of its bound an entry
    uses). Entries with ρ ≥ 1 (a CPU gradient within rounding of zero at
    some step: Adam may move it the other way on the card) are the
    exceptions, counted. ``rel``: ||Δ_card − Δ_cpu|| / ||Δ_cpu|| over the
    well-conditioned entries, whose gradients sit at least 100 times above
    their rounding at every step (ρ < 0.01), which the reduced runs' value
    bound (VALUE_TOL) holds; ``rel_regular`` the same over every entry with
    ρ < 1, where Adam's normalisation amplifies the rounding by up to 1/ρ
    (reported, held only entry by entry)."""
    lr = TRAIN_LR
    acc = {"sq": 0.0, "norm": 0.0, "sq_r": 0.0, "norm_r": 0.0}
    exceptions = entries = 0
    worst = 0.0
    for p, a in want.items():
        b = got[p].cpu()
        err = (b - a).abs()
        tight = 1e-5 * a.abs() + 1e-4 * lr
        worst = max(worst, float((err / (tight + 3 * lr * rho[p].clamp(max=2.0))).max()))
        exceptions += int(((rho[p] >= 1) & (err > tight)).sum())
        entries += err.numel()
        for key, keep in (("", rho[p] < 0.01), ("_r", rho[p] < 1)):
            acc["sq" + key] += float(((b - a) * keep).square().sum())
            acc["norm" + key] += float((a * keep).square().sum())
    return {"rel": (acc["sq"] / max(acc["norm"], 1e-300)) ** 0.5,
            "rel_regular": (acc["sq_r"] / max(acc["norm_r"], 1e-300)) ** 0.5,
            "worst": worst, "exceptions": exceptions, "entries": entries}


# (arch, method, strategy, base): the reduced runs card vs CPU ("bf16" is
# the dense base, as in reduced_train_case: fp32 there)
REDUCED_METHODS = (("qwen2-1.5b", "lora", "magnitude", "bf16"),
                   ("qwen2-1.5b", "bitfit", "magnitude", "bf16"),
                   ("qwen2-1.5b", "masked", "magnitude", "bf16"),
                   ("qwen2-1.5b", "full", "magnitude", "bf16"),
                   ("qwen2-1.5b", "neuroada", "reverse", "bf16"),
                   ("qwen2-1.5b", "neuroada", "gradient", "bf16"),
                   ("qwen2-1.5b", "lora", "magnitude", "int8"),
                   (MOE_ARCH, "bitfit", "magnitude", "bf16"),
                   (MOE_ARCH, "masked", "magnitude", "bf16"),
                   (MOE_ARCH, "full", "magnitude", "bf16"))


def phase_reduced_methods(card: str) -> None:
    """Reduced qwen2-1.5b (and olmoe-1b-7b) in fp32, three AdamW steps of
    each of REDUCED_METHODS on the card and on the CPU from the same
    params, batches and initial trainables (LoRA's drawn on the CPU; the
    selections made on each device; ``gradient`` from the CPU's warm-up
    |dL/dW|): selected indices and masks identical, losses within 1e-5, the
    trainables' moves within the rounding rule of ``compare_moves``, its
    exceptions at most 2 % of the entries, and over the well-conditioned
    entries within VALUE_TOL relative. Then ``random`` on the card by its
    properties."""
    failures = []
    for arch, method, strategy, base in REDUCED_METHODS:
        cfg, model, params, batches = reduced_train_case(arch, base, 4, 16)
        grads = (warmup_grads(model, params, device_batch(batches[0], "cpu"))
                 if strategy == "gradient" else None)
        pcfg = PeftConfig(method=method, k=2, strategy=strategy, lora_rank=4,
                          delta_dtype="float32")
        runs = {}
        for dev in ("cpu", "cuda"):
            p_dev = map_leaves(lambda x: None if x is None else x.to(dev), params)
            g_dev = None if grads is None else map_leaves(
                lambda x: None if x is None else x.to(dev), grads)
            peft = get_peft(pcfg, **({"grads": g_dev} if g_dev is not None else {}))
            reset_counters()
            if method == "lora":  # one draw, on the CPU
                tr, aux = runs["cpu"]["init"] if dev == "cuda" else peft.init(
                    p_dev, torch.Generator().manual_seed(0))
                tr = map_leaves(lambda x: None if x is None else x.to(dev), tr)
            else:
                tr, aux = peft.init(p_dev)
            init = (map_leaves(lambda x: None if x is None else x.clone(), tr), aux)
            n_select = COUNTERS["topk_select"].kernel
            losses, moves, rho = method_steps(model, peft, p_dev, tr, aux, batches, dev == "cpu")
            if dev == "cuda":
                assert all(c.plain == 0 for c in COUNTERS.values()), \
                    {c.name: c.plain for c in COUNTERS.values() if c.plain}
                want_q = base != "bf16"
                assert (COUNTERS["fused_linear_q"].kernel > 0) == want_q
                assert (n_select > 0) == (method in ("neuroada", "masked")), n_select
            runs[dev] = {"losses": losses, "moves": moves, "rho": rho, "aux": aux, "init": init}
        cpu, gpu = runs["cpu"], runs["cuda"]
        if cpu["aux"] is not None:
            for (p, a), (_, b) in zip(flatten(cpu["aux"]), flatten(gpu["aux"])):
                assert (a is None) == (b is None) and (a is None or torch.equal(a, b.cpu())), \
                    f"{arch} {method} {strategy}: aux {p} differs card vs cpu"
        d_loss = max(abs(a - b) for a, b in zip(cpu["losses"], gpu["losses"]))
        cmp = compare_moves(cpu["moves"], gpu["moves"], cpu["rho"])
        tol = VALUE_TOL["moe" if cfg.num_experts else "dense"]
        tag = f"{arch} {method}" + (f" {strategy}" if method in ("neuroada", "masked") else "") \
            + ("" if base == "bf16" else f" {base} base")
        log(f"[reduced-method] {tag}: 3 steps fp32 card vs cpu: losses {[f'{x:.7f}' for x in gpu['losses']]} "
            f"(max |diff| {d_loss:.2e}); moves: worst entry at {cmp['worst']:.3f} of its bound, "
            f"{cmp['exceptions']} exceptions of {cmp['entries']:,} entries; ||card - cpu|| / "
            f"||cpu|| = {cmp['rel']:.2e} over the well-conditioned entries (bound {tol}), "
            f"{cmp['rel_regular']:.2e} over all but the exceptions [{card}]")
        if d_loss > 1e-5 or cmp["worst"] > 1 or cmp["rel"] > tol \
                or cmp["exceptions"] > max(2, cmp["entries"] // 50):
            failures.append((tag, d_loss, cmp))
    assert not failures, failures
    # random: one generator a selection, k distinct rows a column, a seeded
    # rerun equal, each stack's kernel result the plain version's on the
    # same scores (the generator replayed in leaf order)
    cfg, model, params, _ = reduced_train_case("qwen2-1.5b", "bf16", 4, 16)
    params = map_leaves(lambda x: None if x is None else x.cuda(), params)
    reset_counters()
    a, _ = init_adapters(params, 4, strategy="random",
                         rng=torch.Generator(device="cuda").manual_seed(3))
    b, _ = init_adapters(params, 4, strategy="random",
                         rng=torch.Generator(device="cuda").manual_seed(3))
    n = COUNTERS["topk_select"].kernel
    g = torch.Generator(device="cuda").manual_seed(3)
    for (p, x), (_, y), (_, w) in zip(flatten(a), flatten(b), flatten(params)):
        if x is None:
            continue
        assert torch.equal(x, y), p
        srt = torch.sort(x, dim=-2).values
        assert bool((srt[..., 1:, :] != srt[..., :-1, :]).all()), p
        scores = torch.rand(tuple(w.shape), generator=g, device="cuda")
        assert torch.equal(x, ts_mod.topk_select_plain(scores.reshape(-1, *w.shape[-2:]), 4)
                           .reshape(x.shape)), p
    assert n == 2 * len(adapt_mod.adaptable_shapes(params)) and \
        COUNTERS["topk_select"].plain == len(adapt_mod.adaptable_shapes(params))
    log(f"[reduced-method] random selection on the card (k = 4): a seeded rerun equal, 4 "
        f"distinct rows a column, every stack equal to the plain version on the same scores "
        f"({n // 2} launches a selection) [{card}]")


# the bf16 runs first: they share one params tree, freed before the packed ones
FULL_METHODS = (("lora", "bf16"), ("bitfit", "bf16"), ("masked", "bf16"), ("full", "bf16"),
                ("lora", "int8"), ("lora", "nf4"))


def tree_nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for _, x in flatten(tree) if x is not None)


def method_run(card: str, model, params, method: str, base: str) -> dict:
    """Full-width qwen2-1.5b training under ``method`` on a bf16 base, or
    on one packed to ``base``: the Trainer's set-up (selection for
    ``masked``), TRAIN_WARMUP + REMAT_STEPS steps of TRAIN_BATCH x
    TRAIN_SEQ (step times, peak memory, launches a step: none on the bf16
    base, where every product is plain torch as in the reference, and 196
    ``fused_linear_q`` on a packed one: QLoRA's base products at k = 0, on
    the wgmma route); the trainable count and the optimizer state's
    bytes. ``masked``: every unselected entry and every leaf that is not
    adapted keeps the base's bits (weight decay 0)."""
    cfg = model.cfg
    L = cfg.num_layers
    tag = f"method-{method}" + ("" if base == "bf16" else f"-{base}")
    tcfg = TrainConfig(steps=TRAIN_WARMUP + REMAT_STEPS + 1, learning_rate=TRAIN_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counters()
    t0 = time.perf_counter()
    trainer = Trainer(model, get_peft(PeftConfig(method=method, k=TRAIN_K)), tcfg, params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - held
    n_select = COUNTERS["topk_select"].kernel
    assert n_select == (7 if method == "masked" else 0), n_select
    st = stats(params, trainer.state.trainable)
    opt_bytes = tree_nbytes({"mu": trainer.state.opt_state.mu, "nu": trainer.state.opt_state.nu})
    data = DataLoader("lm", cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    try:
        for _ in range(TRAIN_WARMUP):
            trainer.step(next(data))
        fingerprint = packed_fingerprint(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        times, losses = [], []
        for _ in range(REMAT_STEPS):
            b = next(data)
            t0 = time.perf_counter()
            m = trainer.step(b)
            times.append(time.perf_counter() - t0)
            losses.append(m["loss"])
            assert m["skipped"] == 0, m
        peak = torch.cuda.max_memory_allocated()
    finally:
        data.close()
    assert all(np.isfinite(losses)), losses
    assert all(torch.equal(a, b) for a, b in zip(fingerprint, packed_fingerprint(params)))
    for c in COUNTERS.values():
        assert c.plain == 0, f"{tag} called the plain version of {c.name}"
    per_step = {c.name: c.kernel / REMAT_STEPS for c in COUNTERS.values() if c.kernel}
    want = {} if base == "bf16" else {"fused_linear_q": 7 * L}
    assert per_step == want, (tag, per_step, want)
    if base != "bf16":
        assert dict(COUNTERS["fused_linear_q"].routes) == {"wgmma": 7 * L * REMAT_STEPS}
    moved = None
    if method == "masked":  # the Fig. 2 strawman still trains only its selection
        moved = 0
        for (p, w), (_, t), (_, mk) in zip(flatten(params), flatten(trainer.state.trainable),
                                           flatten(trainer.aux)):
            assert torch.equal(torch.where(mk, w, t), w), f"masked moved an unselected entry of {p}"
            moved += int((t != w).sum())
        selected = sum(int(mk.sum()) for _, mk in flatten(trainer.aux))
        assert 0 < moved <= selected, (moved, selected)
    med = float(np.median(times))
    tok = TRAIN_BATCH * TRAIN_SEQ
    log(f"[{tag}] qwen2-1.5b {base} base, {TRAIN_BATCH} x {TRAIN_SEQ}, {REMAT_STEPS} steps after "
        f"{TRAIN_WARMUP}: step median {med * 1e3:.2f} ms (min {min(times) * 1e3:.2f}, max "
        f"{max(times) * 1e3:.2f}); {tok / med:.0f} tokens/s; peak {peak / 2**30:.2f} GiB; "
        f"trainable {st['trainable']:,} ({100 * st['fraction']:.4f} %); optimizer state "
        f"{opt_bytes:,} bytes; set-up {init_s:.3f} s ({n_select} topk_select launches, "
        f"peak {init_peak / 2**30:.2f} GiB above the weights); launches a step "
        f"{json.dumps(per_step)}, plain 0"
        + (f"; {moved:,} entries moved, every unselected one and every leaf not adapted "
           f"bit-equal to the base" if moved is not None else "") + f"; losses "
        f"{[round(x, 4) for x in losses]} [{card}]")
    del trainer
    torch.cuda.empty_cache()
    return {"base": base, "step_s": times, "median_s": med, "tokens_per_s": tok / med,
            "peak_bytes": peak, "trainable": st["trainable"], "fraction": st["fraction"],
            "opt_state_bytes": opt_bytes, "setup_s": init_s, "setup_peak_bytes": init_peak,
            "select_launches": n_select, "launches_per_step": per_step, "losses": losses,
            "masked_moved": moved}


def phase_methods(card: str, neuroada: dict) -> dict:
    """FULL_METHODS at full width (the bf16 params shared, each packed base
    made from them), then the memory gate: NeuroAda's peak (phase 7's bf16
    run, ``neuroada``) below ``masked``'s and ``full``'s, its reduction set
    beside the paper's "up to 60 %" (no gate on the 60)."""
    cfg = get_config("qwen2-1.5b")
    params = get_model(cfg).init(seed=0, device="cuda")
    out = {}
    for method, base in FULL_METHODS:
        if base != "bf16":  # packed from the same seed's weights, the dense base freed
            params = None
            params = quantize_base(get_model(cfg).init(seed=0, device="cuda"), base,
                                   block=QUANT_BLOCK)
        # a Model per run: a Model keeps views of the last param trees it ran
        out[f"{method}-{base}"] = method_run(card, get_model(cfg), params, method, base)
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    na = neuroada["peak"]
    cut = {m: 1 - na / out[f"{m}-bf16"]["peak_bytes"] for m in ("masked", "full")}
    for m in ("masked", "full"):
        assert na < out[f"{m}-bf16"]["peak_bytes"], (m, na, out[f"{m}-bf16"]["peak_bytes"])
    log(f"[methods] peak memory, qwen2-1.5b bf16 {TRAIN_BATCH} x {TRAIN_SEQ}: NeuroAda k={TRAIN_K} "
        f"{na / 2**30:.2f} GiB (phase 7), masked {out['masked-bf16']['peak_bytes'] / 2**30:.2f}, "
        f"full {out['full-bf16']['peak_bytes'] / 2**30:.2f}, LoRA r=8 "
        f"{out['lora-bf16']['peak_bytes'] / 2**30:.2f}, BitFit "
        f"{out['bitfit-bf16']['peak_bytes'] / 2**30:.2f}, QLoRA int8 / NF4 "
        f"{out['lora-int8']['peak_bytes'] / 2**30:.2f} / "
        f"{out['lora-nf4']['peak_bytes'] / 2**30:.2f}: NeuroAda peaks {100 * cut['masked']:.1f} % "
        f"below masked and {100 * cut['full']:.1f} % below full (the paper: \"up to 60 %\") "
        f"[{card}]")
    with open(os.path.join(OUT_DIR, "train_methods.json"), "w") as f:
        json.dump({"card": card, "neuroada_peak_bytes": na, "reduction_vs": cut, **out}, f,
                  indent=1)
    return out


def phase_strategies(card: str, magnitude: dict) -> dict:
    """Selection at full width on qwen2-1.5b's bf16 weights (k = TRAIN_K),
    each strategy through ``init_adapters`` on the card: time (host clock to
    a sync), ``topk_select`` launches (7, one a stack), peak above the
    weights (and the warm-up |dL/dW| for ``gradient``), and every stack's
    indices equal to the plain version's on the same input. ``gradient``'s
    warm-up (one TRAIN_BATCH x TRAIN_SEQ batch, autograd with every weight
    requiring grad) is timed with its peak. ``magnitude``'s figure is phase
    7's bf16 set-up (``magnitude``), timed here again beside the others."""
    cfg = get_config("qwen2-1.5b")
    model = get_model(cfg)
    params = model.init(seed=0, device="cuda")
    data = DataLoader("lm", cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    try:
        batch = device_batch(next(data), "cuda")
    finally:
        data.close()
    out = {}
    for strategy in ("magnitude", "reverse", "gradient", "random"):
        kw, extra = {}, {}
        if strategy == "gradient":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            grads = warmup_grads(model, params, batch)
            torch.cuda.synchronize()
            extra = {"warmup_s": time.perf_counter() - t0,
                     "warmup_peak_bytes": torch.cuda.max_memory_allocated() - held,
                     "grads_bytes": tree_nbytes(grads)}
            kw["grads"] = grads
        if strategy == "random":
            kw["rng"] = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_counters()
        t0 = time.perf_counter()
        idx, _ = init_adapters(params, TRAIN_K, strategy=strategy, **kw)
        torch.cuda.synchronize()
        sel_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held
        n = COUNTERS["topk_select"].kernel
        assert n == 7 and COUNTERS["topk_select"].plain == 0, (strategy, n)
        g = torch.Generator(device="cuda").manual_seed(0)
        for (p, i), (_, w) in zip(flatten(idx), flatten(params)):
            if i is None:
                continue
            if strategy == "gradient":
                x = kw["grads"]
                for key in p:
                    x = x[key]
            elif strategy == "random":
                x = torch.rand(tuple(w.shape), generator=g, device="cuda")
            else:
                x = w
            want = ts_mod.topk_select_plain(x, TRAIN_K, strategy != "reverse")
            assert torch.equal(i, want), (strategy, p)
        x = want = None
        out[strategy] = {"select_s": sel_s, "launches": n, "peak_bytes_above_held": peak,
                         **extra}
        del idx, kw
        grads = None
        torch.cuda.empty_cache()
        log(f"[strategy-{strategy}] qwen2-1.5b bf16, k={TRAIN_K}: selection {sel_s * 1e3:.1f} ms "
            f"({n} topk_select launches), peak {peak / 2**20:.1f} MiB above the "
            f"{held / 2**30:.2f} GiB held; every stack equal to the plain version"
            + (f"; warm-up |dL/dW| {extra['warmup_s'] * 1e3:.1f} ms, peak "
               f"{extra['warmup_peak_bytes'] / 2**30:.2f} GiB above the weights, the float32 "
               f"|g| tree {extra['grads_bytes'] / 2**30:.2f} GiB" if extra else "")
            + (f" (phase 7's set-up: {magnitude['select_s'] * 1e3:.1f} ms)"
               if strategy == "magnitude" else "") + f" [{card}]")
    del params
    torch.cuda.empty_cache()
    with open(os.path.join(OUT_DIR, "selection_strategies.json"), "w") as f:
        json.dump({"card": card, **out}, f, indent=1)
    return out


def phase_lora_export(card: str) -> None:
    """``launch/train.py --peft lora --export`` of reduced qwen2-1.5b in
    fp32 on the card (3 steps), then ``launch/serve.py --params`` of the
    merged file on the card and on the CPU: the same greedy tokens."""
    shutil.rmtree(SCRATCH, ignore_errors=True)
    os.makedirs(SCRATCH)
    merged = os.path.join(SCRATCH, "lora.npz")
    real = launch_train.reduced, launch_serve.reduced
    launch_train.reduced = lambda c: real[0](c).replace(dtype="float32")
    launch_serve.reduced = lambda c: real[1](c).replace(dtype="float32")
    try:
        reset_counters()
        launch_train.main(["--reduced", "--peft", "lora", "--steps", "3", "--batch", "4",
                           "--seq", "16", "--export", merged])
        assert all(c.plain == 0 for c in COUNTERS.values())
        rng = np.random.default_rng(5)
        prompts = ";".join(",".join(map(str, rng.integers(3, 512, size=n)))
                           for n in (5, 37, 12, 70, 3))
        argv = ["--reduced", "--prompts", prompts, "--max-new", "10", "--slots", "3",
                "--params", merged]
        got = launcher_tokens(launch_serve.main, argv)
        want = launcher_tokens(launch_serve.main, argv + ["--device", "cpu"])
    finally:
        launch_train.reduced, launch_serve.reduced = real
        shutil.rmtree(SCRATCH, ignore_errors=True)
    assert got == want, (got, want)
    log(f"[lora-export] reduced qwen2-1.5b fp32: train --peft lora --export on the card, serve "
        f"--params of the merged file: the CPU's greedy tokens on the card, all {len(got)} "
        f"requests ({sum(map(len, got))} tokens) [{card}]")


# ------------------------------------------------- serving production lifecycle

# chaos at full width: the CPU grid's knobs (tests/test_torch_chaos.py) and
# the first seed from 0 up that, on the gate run's schedule, fires all three
# engine-side injections and leaves requests to survive (seed 0 storms no
# deadline; seed 7, the grid's, cancels or expires all 10)
LIFECYCLE_CHAOS = dict(seed=1, cancel_prob=0.3, deadline_prob=0.2, pressure_prob=0.5,
                       pressure_frac=0.9)
# the fairness run: a hot tenant's requests, then a cold tenant's, each of
# FAIR_PROMPT tokens and FAIR_NEW new
FAIR_HOT, FAIR_COLD, FAIR_PROMPT, FAIR_NEW = 12, 4, 200, 16
# a request whose deadline passes mid-decode: its timeout (seconds) and budget
MID_DECODE_TIMEOUT, MID_DECODE_NEW = 1.0, 200


def trace_latency(tracer, reqs) -> dict:
    """Exact per-request latency from a lifecycle trace (µs): TTFT is the
    first_token instant less the submit instant; every later token arrives
    at the end of the decode span that emitted it (a mixed step's one-token
    ``decode`` span included). Returns TTFT a request, the gap to each
    step's arrivals ("burst": one a step that emitted) and the even split
    of each gap over the tokens that step brought (ITL a token)."""
    by_rid = collections.defaultdict(list)
    for e in tracer.events:
        by_rid[e["rid"]].append(e)
    ttft, burst, itl = [], [], []
    for r in reqs:
        ev = by_rid[r.rid]
        submit = next(e["ts"] for e in ev if e["name"] == "submit")
        last = next(e["ts"] for e in ev if e["name"] == "first_token")
        ttft.append(last - submit)
        arrived = 1
        for e in ev:
            n = e["args"].get("tokens", 0) if e["name"] == "decode" else 0
            if n:
                gap = e["ts"] + e["dur"] - last
                burst.append(gap)
                itl += [gap / n] * n
                last = e["ts"] + e["dur"]
                arrived += n
        assert arrived == len(r.out), (r.rid, arrived, len(r.out))
    return {"ttft": ttft, "burst": burst, "itl": itl}


def held_to_gate(what: str, model, eng, reqs, off_outs, prompts) -> int:
    """Hold requests that ran on another schedule than the gate run's (a
    cancel, a deadline or an arrival moves which step, mixed or decode,
    computes a token) to its tokens: each identical, or parted at a
    near-tie of the teacher-forced logits as ``divergence_gaps`` judges
    (bf16 products of another row count may round the other way). Logs
    every parting; returns how many were identical."""
    gaps = divergence_gaps(model, eng, reqs, [off_outs[r.rid] for r in reqs], prompts)
    for rid, i, gap, ulps, near in gaps:
        log(f"[serve-lifecycle] {what} rid {rid} parts from the gate run at token {i}: top-2 "
            f"gap {gap:.5f} = {ulps:.2f} bf16 ulps, both within {SPEC_TIE_ULPS}: {near}")
    assert all(near for *_, near in gaps), f"{what}: a parting off a near-tie: {gaps}"
    return len(reqs) - len(gaps)


def quantiles_ms(values_us) -> dict:
    return {f"p{int(q * 100)}": percentile(values_us, q) / 1e3 for q in (0.5, 0.95)}


async def http_open(port: int, method: str, path: str, body=None):
    """One HTTP/1.1 request over loopback: (status, headers, reader, writer)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode() if body is not None else b""
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
                 f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    headers = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode().partition(":")
        headers[k.strip().lower()] = v.strip()
    return status, headers, reader, writer


async def http_body(port: int, method: str, path: str, body=None):
    status, headers, reader, writer = await http_open(port, method, path, body)
    raw = await reader.readexactly(int(headers["content-length"]))
    writer.close()
    return status, raw


async def sse_tokens(reader, limit: int = 1 << 20) -> tuple[list, str]:
    """Tokens of an SSE stream up to its done event (at most ``limit``),
    and the done event's reason (None when the limit came first)."""
    toks = []
    while len(toks) < limit:
        line = await asyncio.wait_for(reader.readline(), timeout=120)
        if not line:
            break
        if line.startswith(b"data: "):
            ev = json.loads(line[6:])
            if ev.get("done"):
                return toks, ev["reason"]
            toks.append(ev["token"])
    return toks, None


def front_end_run(model, params, tenants, prompts, max_new, kw) -> dict:
    """The 10 gate prompts streamed concurrently over SSE through
    ``ServeFrontend`` on port 0, each with its tenant; one (rid 1) cancelled
    after its first token; ``/metrics`` read; ``/admin/shutdown`` drains."""
    eng = engine_for(model, params, tenants, [], max_new, "cuda", **kw)
    out = {"engine": eng}

    async def scenario():
        front = ServeFrontend(eng, port=0)
        port = await front.start()
        opened = [await http_open(port, "POST", "/v1/generate",
                                  {"prompt": p, "max_new": max_new,
                                   "adapter_id": i % (len(tenants) + 1)})
                  for i, p in enumerate(prompts)]
        assert all(o[0] == 200 for o in opened), [o[0] for o in opened]
        rids = [int(o[1]["x-request-id"]) for o in opened]
        first, _ = await sse_tokens(opened[1][2], limit=1)
        st, body = await http_body(port, "POST", "/v1/cancel", {"rid": rids[1]})
        assert st == 200 and json.loads(body)["cancelled"], body
        streams = await asyncio.gather(*(sse_tokens(o[2]) for o in opened))
        for o in opened:
            o[3].close()
        st, text = await http_body(port, "GET", "/metrics")
        assert st == 200
        samples = {}
        for line in text.decode().splitlines():
            if line and not line.startswith("#"):
                name, value = line.rsplit(" ", 1)
                samples[name] = float(value)
        st, _ = await http_body(port, "POST", "/admin/shutdown")
        assert st == 200
        await front.serve()  # returns after the drain; raises the engine thread's error
        out.update(rids=rids, streams=[(first + t if i == 1 else t, reason)
                                       for i, (t, reason) in enumerate(streams)],
                   samples=samples, fatal=front._fatal)

    asyncio.run(scenario())
    return out


def serve_lifecycle(card: str, stamp, gate: dict | None = None) -> dict:
    """Slice 14's phase on the qwen2 paged bf16 gate run (``gate`` as
    phase_full returns it; built here when alone): instrumentation's host
    operations and cost, the registry and trace against the run, TTFT and
    ITL of a window, fifo against drr, seeded chaos, deadlines on the real
    clock, the SSE front end and the launcher's observability flags."""
    t_phase = time.perf_counter()
    if gate is None:
        model, params, tenants, prompts, max_new, kw = gate_inputs()
        serve(model, params, tenants, prompts[:2], 2, "cuda", **kw)  # warm-up
        n_ops, tally, (_, reqs) = host_ops(
            lambda: serve(model, params, tenants, prompts, max_new, "cuda", **kw))
        assert n_ops == GATE_OPS, (n_ops, GATE_OPS)
        gate = dict(model=model, params=params, tenants=tenants, prompts=prompts,
                    max_new=max_new, kw=kw, tally=tally, off_outs=[r.out for r in reqs])
    model, params, tenants, prompts = (gate[k] for k in ("model", "params", "tenants",
                                                         "prompts"))
    max_new, kw, off_outs = gate["max_new"], gate["kw"], gate["off_outs"]
    run = lambda **extra: serve(model, params, tenants, prompts, max_new, "cuda",  # noqa: E731
                                **kw, **extra)
    result = {"card": card}

    # 1. instrumentation dispatches nothing: metrics off, and on with a tracer
    for tag, extra in (("metrics off", {"metrics": False}), ("tracer", {"tracer": Tracer()})):
        n_ops, tally, (eng, reqs) = host_ops(lambda: run(**extra))
        moved = {k: (gate["tally"].get(k, 0), tally.get(k, 0))
                 for k in set(tally) | set(gate["tally"])
                 if tally.get(k, 0) != gate["tally"].get(k, 0)}
        assert not moved and n_ops == GATE_OPS, (tag, n_ops, moved)
        assert [r.out for r in reqs] == off_outs, f"{tag}: tokens moved"
    log(f"[serve-lifecycle] gate run with metrics off and with metrics and a tracer: "
        f"{GATE_OPS} host operations each, op by op those of metrics on (the default); "
        f"the same greedy tokens [{card}]")

    # 2. the registry and the trace against the traced run
    reg, tracer = eng.metrics, eng.tracer
    n_tok = sum(len(r.out) for r in reqs)
    assert eng.transfers == eng.steps == reg.value("serve_transfers_total"), \
        (eng.transfers, eng.steps)
    assert reg.get("serve_tokens_total").total == n_tok
    want = collections.Counter((str(r.adapter_id), r.reason) for r in reqs)
    got = {(s["labels"]["tenant"], s["labels"]["reason"]): s["value"]
           for s in reg.snapshot()["serve_requests_finished_total"]["series"]}
    assert got == want and sum(want.values()) == len(prompts), (got, want)
    assert reg.get("serve_ttft_seconds").count == len(prompts)
    assert reg.get("serve_itl_seconds").count == n_tok - len(prompts)
    assert reg.value("serve_pool_blocks_free") == eng.kv.num_blocks
    assert reg.value("serve_pool_blocks_used") == 0 and eng.kv.drained()
    finishes = sorted(e["rid"] for e in tracer.events if e["name"] == "finish")
    assert finishes == sorted(r.rid for r in reqs), finishes
    log(f"[serve-lifecycle] registry of the traced gate run: {eng.steps} transfers = steps, "
        f"{n_tok} tokens, finished {dict(collections.Counter(r.reason for r in reqs))}, "
        f"TTFT count {len(prompts)}, ITL count {n_tok - len(prompts)}, pool gauges "
        f"{eng.kv.num_blocks} free / 0 used; {len(tracer)} trace events, one finish a "
        f"request [{card}]")

    # 3. deadlines on the real clock, on that idle engine (its EMA measured)
    ema = eng.step_seconds_ema
    assert ema is not None and ema > 0
    try:
        eng.submit(prompts[0], max_new=8, timeout=ema / 10)
        raise AssertionError("a request with a timeout below a step was admitted")
    except QueueFullError as e:
        assert "deadline unreachable" in str(e), e
    assert eng.metrics.get("serve_requests_shed_total").labels("deadline").value == 1
    t0 = time.perf_counter()
    rid = eng.submit(prompts[0], max_new=MID_DECODE_NEW, timeout=MID_DECODE_TIMEOUT)
    late = eng.scheduler.get(rid)
    eng.run_to_completion()
    waited = time.perf_counter() - t0
    assert late.reason == "deadline" and 0 < len(late.out) < MID_DECODE_NEW, \
        (late.reason, len(late.out))
    assert eng.metrics.get("serve_deadline_expired_total").labels("decode").value == 1
    assert eng.kv.drained() and eng.transfers == eng.steps
    log(f"[serve-lifecycle] deadlines: step EMA {ema * 1e3:.2f} ms; a {ema / 10 * 1e3:.2f} ms "
        f"timeout shed at intake; a {MID_DECODE_TIMEOUT:.1f} s timeout ended mid-decode "
        f"after {len(late.out)} of {MID_DECODE_NEW} tokens ({waited:.3f} s), pool drained "
        f"[{card}]")
    result["deadline"] = {"ema_ms": ema * 1e3, "tokens": len(late.out), "wall_s": waited}
    stamp("serve lifecycle: counts, registry, deadlines")

    # 4. what instrumentation costs on this host-bound engine: off / on / traced
    walls = {"off": [], "on": [], "traced": []}
    for _ in range(3):
        for tag in walls:
            extra = {"off": {"metrics": False}, "on": {}, "traced": {"tracer": Tracer()}}[tag]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, timed = run(**extra)
            torch.cuda.synchronize()
            walls[tag].append(time.perf_counter() - t0)
            assert [r.out for r in timed] == off_outs
    med = {k: float(np.median(v)) for k, v in walls.items()}
    result["instrumentation_s"] = walls
    log(f"[serve-lifecycle] gate run wall, 3 each in turn: metrics off {med['off']:.3f} s, "
        f"on {med['on']:.3f} s ({med['on'] / med['off']:.4f}x), on + tracer "
        f"{med['traced']:.3f} s ({med['traced'] / med['off']:.4f}x); runs "
        f"{json.dumps({k: [round(x, 4) for x in v] for k, v in walls.items()})} [{card}]")

    # 5. exact TTFT and ITL of the 16 x 64 window from its trace
    rng = np.random.default_rng(13)
    lens = rng.integers(40, 701, size=WINDOW_REQUESTS)
    wprompts = [rng.integers(3, model.cfg.vocab_size, size=int(n)).tolist() for n in lens]
    t0 = time.perf_counter()
    weng, wreqs = serve(model, params, tenants, wprompts, WINDOW_NEW, "cuda", tracer=Tracer(),
                        **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lat = trace_latency(weng.tracer, wreqs)
    w_tok = sum(len(r.out) for r in wreqs)
    result["window"] = {"tok_s": w_tok / wall, "ttft_ms": quantiles_ms(lat["ttft"]),
                        "itl_ms": quantiles_ms(lat["itl"]), "burst_ms": quantiles_ms(lat["burst"]),
                        "itl_mean_ms": float(np.mean(lat["itl"])) / 1e3,
                        "hist_ttft_p50_ms": weng.metrics.get("serve_ttft_seconds").quantile(0.5)
                        * 1e3}
    w = result["window"]
    log(f"[serve-lifecycle] window {WINDOW_REQUESTS} x {WINDOW_NEW} traced: {w_tok} tokens in "
        f"{wall:.3f} s ({w['tok_s']:.1f} tok/s); TTFT p50 {w['ttft_ms']['p50']:.1f} ms, p95 "
        f"{w['ttft_ms']['p95']:.1f} ms; ITL a token (a step's gap split over its tokens) p50 "
        f"{w['itl_ms']['p50']:.2f} ms, p95 {w['itl_ms']['p95']:.2f} ms, mean "
        f"{w['itl_mean_ms']:.2f} ms; gap between a request's token arrivals p50 "
        f"{w['burst_ms']['p50']:.1f} ms, p95 {w['burst_ms']['p95']:.1f} ms [{card}]")

    # 6. fairness: a hot tenant's requests ahead of a cold tenant's
    rng = np.random.default_rng(17)
    fprompts = [rng.integers(3, model.cfg.vocab_size, size=FAIR_PROMPT).tolist()
                for _ in range(FAIR_HOT + FAIR_COLD)]
    result["fairness"] = {}
    for policy in ("fifo", "drr"):
        store = AdapterStore(base_params=params)
        for i, (idx, val) in enumerate(tenants):
            store.register(idx, val, name=f"tenant{i + 1}")
        feng = ServeEngine(model, params, adapter_store=store, device="cuda", tracer=Tracer(),
                           fairness=policy, **kw)
        aids = [1] * FAIR_HOT + [2] * FAIR_COLD
        freqs = [feng.scheduler.get(feng.submit(p, max_new=FAIR_NEW, adapter_id=a))
                 for p, a in zip(fprompts, aids)]
        feng.run_to_completion()
        assert all(r.reason in ("eos", "max_new") for r in freqs) and feng.kv.drained()
        ttft = trace_latency(feng.tracer, freqs)["ttft"]
        result["fairness"][policy] = {
            "cold_ttft_ms": float(np.mean(ttft[FAIR_HOT:])) / 1e3,
            "hot_ttft_ms": float(np.mean(ttft[:FAIR_HOT])) / 1e3, "steps": feng.steps}
    f = result["fairness"]
    log(f"[serve-lifecycle] fairness, {FAIR_HOT} hot then {FAIR_COLD} cold requests of "
        f"{FAIR_PROMPT} + {FAIR_NEW} tokens: cold tenant's mean TTFT fifo "
        f"{f['fifo']['cold_ttft_ms']:.1f} ms, drr {f['drr']['cold_ttft_ms']:.1f} ms; hot "
        f"tenant's fifo {f['fifo']['hot_ttft_ms']:.1f} ms, drr {f['drr']['hot_ttft_ms']:.1f} ms "
        f"[{card}]")
    stamp("serve lifecycle: cost, window, fairness")

    # 7. chaos at full width
    chaos = ChaosMonkey(**LIFECYCLE_CHAOS)
    reset_counters()
    with forwards_never_wait(model):
        ceng, creqs = run(chaos=chaos)
    for name, c in COUNTERS.items():
        assert name not in SERVING or c.kernel > 0, f"chaos run never launched {name}"
        assert c.plain == 0, f"chaos run called the plain version of {name}"
    survivors = [r for r in creqs if r.reason in ("eos", "max_new")]
    assert all(r.done and r.reason in ("eos", "max_new", "cancelled", "deadline")
               for r in creqs), [(r.rid, r.reason) for r in creqs]
    assert survivors, "chaos left no request to hold to the gate run"
    same = held_to_gate("chaos survivor", model, ceng, survivors, off_outs, prompts)
    assert ceng.kv.drained() and ceng.kv.stolen_blocks == 0
    assert sum(chaos.injected.values()) > 0 and ceng.transfers == ceng.steps
    reasons = dict(collections.Counter(r.reason for r in creqs))
    result["chaos"] = {"injected": chaos.injected, "reasons": reasons,
                       "preemptions": ceng.preemptions, "steps": ceng.steps}
    log(f"[serve-lifecycle] chaos (seed {LIFECYCLE_CHAOS['seed']}): injected "
        f"{json.dumps(chaos.injected)}, reasons {json.dumps(reasons)}, preemptions "
        f"{ceng.preemptions}; {same} of {len(survivors)} survivors token-identical to the gate "
        f"run, the others parted at a near-tie; pool drained, "
        f"nothing stolen; launches {json.dumps({n: COUNTERS[n].kernel for n in SERVING})}, "
        f"plain 0; {ceng.transfers} transfers = steps [{card}]")

    # 8. the SSE front end on the card
    with forwards_never_wait(model):
        front = front_end_run(model, params, tenants, prompts, max_new, kw)
    feng = front["engine"]
    assert front["fatal"] is None and feng.draining and feng.kv.drained()
    streams = front["streams"]
    assert streams[1][1] == "cancelled" and 0 < len(streams[1][0]) < max_new, streams[1]
    assert all(reason in ("eos", "max_new") for i, (_, reason) in enumerate(streams) if i != 1)
    kept = [types.SimpleNamespace(rid=i, out=toks, adapter_id=i % (len(tenants) + 1))
            for i, (toks, _) in enumerate(streams) if i != 1]
    same = held_to_gate("stream", model, feng, kept, off_outs, prompts)
    samples = front["samples"]
    assert samples["serve_transfers_total"] == feng.steps
    assert samples['serve_requests_cancelled_total{phase="decode"}'] + \
        samples['serve_requests_cancelled_total{phase="prefill"}'] == 1
    log(f"[serve-lifecycle] SSE front end: 10 gate prompts streamed concurrently, rid 1 "
        f"cancelled after {len(streams[1][0])} tokens; {same} of the other 9 streams "
        f"token-identical to the gate run, the others parted at a near-tie; /metrics {len(samples)} samples ({feng.steps} transfers = steps); drained "
        f"by /admin/shutdown, _fatal None, forwards under the sync guard [{card}]")

    # 9. the launcher's observability flags at full width
    out_dir = os.path.join(SCRATCH, "serve")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    paths = {k: os.path.join(out_dir, n) for k, n in
             (("metrics", "metrics.json"), ("trace", "trace.jsonl"), ("profile", "profile"))}
    argv = ["--arch", "qwen2-1.5b", "--prompts", ";".join(",".join(map(str, p))
                                                          for p in prompts[:3]),
            "--max-new", "8", "--slots", str(SLOTS), "--max-len", str(MAX_LEN),
            "--prefill-chunk", str(PREFILL_CHUNK), "--decode-chunk", str(DECODE_CHUNK),
            "--page-size", str(PAGE), "--metrics-every", "2",
            "--metrics-out", paths["metrics"], "--trace-out", paths["trace"],
            "--profile-dir", paths["profile"]]
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        launch_serve.main(argv)
    wall = time.perf_counter() - t0
    lines = printed.getvalue().splitlines()
    snap = json.load(open(paths["metrics"]))
    events = [json.loads(ln) for ln in open(paths["trace"])]
    prof = [os.path.join(paths["profile"], n) for n in os.listdir(paths["profile"])]
    chrome = json.load(open(prof[0]))
    n_kernels = sum(1 for e in chrome["traceEvents"] if e.get("cat") == "kernel")
    assert sum(s["value"] for s in snap["serve_requests_finished_total"]["series"]) == 3
    assert sum(e["name"] == "finish" for e in events) == 3
    assert any(ln.startswith("[metrics] step=") for ln in lines)
    assert len(prof) == 1 and n_kernels > 0, (prof, n_kernels)
    sizes = {k: sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(p) for f in fs)
             if os.path.isdir(p) else os.path.getsize(p) for k, p in paths.items()}
    log(f"[serve-lifecycle] launch/serve.py at full width, 3 prompts x 8 new ({wall:.1f} s with "
        f"init): --metrics-out {len(snap)} families, --trace-out {len(events)} events, "
        f"--profile-dir a Chrome trace with {n_kernels} device kernels; bytes "
        f"{json.dumps(sizes)} [{card}]")
    shutil.rmtree(out_dir, ignore_errors=True)
    result["phase_s"] = time.perf_counter() - t_phase
    with open(os.path.join(OUT_DIR, "serve_lifecycle.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    stamp("serve lifecycle: chaos, front end, launcher")
    return result


def peft_slice(card: str, train: dict, stamp) -> dict:
    """Slice 13's phases: the methods and strategies card vs CPU at reduced
    size, the full-width method table and memory gate, the strategies'
    selection at full width, LoRA's merged export served."""
    phase_reduced_methods(card)
    stamp("reduced methods")
    torch.cuda.empty_cache()
    methods = phase_methods(card, train["bf16"])
    stamp("full-width methods")
    strategies = phase_strategies(card, train["bf16"])
    phase_lora_export(card)
    stamp("strategies, LoRA export")
    return {"methods": methods, "strategies": strategies}


def lifecycle(card: str, train: dict, stamp) -> None:
    """Slice 12's phases: olmoe on the packed bases (reduced card vs CPU,
    then full width: selection, training, the gate run, on int8 the
    self-drafter) and on int8 KV (reduced), remat (reduced, then full
    width), checkpoint / resume, and the merged export served through the
    launcher. ``train`` holds the bf16 olmoe run and the long-context run
    of this call; the packed olmoe runs are added to it."""
    for qd in PACKED:
        phase_reduced_train(card, qd, MOE_ARCH)
        phase_reduced(qd, arch=MOE_ARCH)
    # each layout equal to the CPU's; unlike qwen2's, olmoe's two layouts may
    # part (the dense cache's mixed steps attend in plain torch, and routing
    # amplifies a last-bit difference)
    for paged in (True, False):
        phase_reduced("fp32", paged, "int8", arch=MOE_ARCH)
    stamp("reduced olmoe, packed and int8 KV")
    ref = train["olmoe"]
    for qd in PACKED:
        torch.cuda.empty_cache()
        run = train[f"olmoe-{qd}"] = phase_train(card, qd, MOE_ARCH, steps=REMAT_STEPS)
        # selection dequantizes one (d_in, d_out) expert matrix at a time: a
        # packed expert stack selected alone peaks below one layer's dense
        # (E, d_in, d_out) stack in bf16 (the whole selection's peak is the
        # untied head's, dequantized whole: 2048 x 50304)
        cfg = get_config(MOE_ARCH)
        layer_stack = cfg.num_experts * cfg.d_model * cfg.d_ff * 2
        assert run["select_launches"] == select_launches(cfg, qd)
        log(f"[train-olmoe-{qd}] base {run['base_bytes']:,} bytes ({run['base_bytes'] / ref['base_bytes']:.1%} of "
            f"bf16's); selection {run['select_s']:.3f} s, {run['select_launches']} topk_select "
            f"launches (one an expert matrix), peak {run['select_peak'] / 2**20:.1f} MiB above "
            f"the weights (the head's); the wgate stack alone "
            f"{run['expert_select_peak'] / 2**20:.1f} MiB (< one layer's dense expert stack, "
            f"{layer_stack / 2**20:.0f} MiB); training peak {run['peak'] / 2**30:.2f} GiB "
            f"against bf16's {ref['peak'] / 2**30:.2f}, step median "
            f"{run['median_s'] * 1e3:.2f} ms against {ref['median_s'] * 1e3:.2f} [{card}]")
        assert run["expert_select_peak"] < layer_stack, run["expert_select_peak"]
        assert run["peak"] < ref["peak"], (qd, run["peak"], ref["peak"])
    stamp("olmoe packed training and serving")
    for arch in ("qwen2-1.5b", MOE_ARCH):
        phase_reduced_remat(card, arch)
    torch.cuda.empty_cache()
    phase_remat(card, train["long"]["peak"])
    stamp("remat")
    phase_resume(card)
    phase_reduced_export(card)
    phase_export(card)
    stamp("checkpoint, resume, export")


# ------------------------------------------------- slice 15: VLM, SSM, hybrid

FAMILY_ARCHS = ("qwen2-vl-2b", "falcon-mamba-7b", "zamba2-2.7b", "seamless-m4t-large-v2")
# full-width NeuroAda training, (batch, seq, remat), reckoned before the run:
# * qwen2-vl-2b is qwen2-1.5b's trunk (1.54 B parameters with its 151936-row
#   tied embedding): qwen2's 4 x 512, a quarter of each sequence patches;
# * falcon-mamba-7b (7.27 B, 14.5 GB in bf16): a 512-step scan chunk is
#   (B, 512, 8192, 16) float32 = 256 MiB a tensor at B = 1. Autograd through
#   the doubling scan would keep ~20 of them a layer (350 GiB for 64 layers
#   at B = 2); the scan's written-out backward keeps only its inputs, ≈ 0.2
#   GB a layer at B = 2 (13 GB in all) and ≈ 4 GB of scan buffers while one
#   layer's backward runs: 2 x 512 fits without remat, about 35 GB;
# * zamba2-2.7b (2.44 B, 4.9 GB): SSD's (T, T, B, 80) float32 products are
#   336 MB at T = 1024, B = 1, and autograd keeps several a layer (≈ 70 GB
#   for 54 layers), so remat="full" (the reference's option: a group of the
#   shared block and 6 Mamba-2 blocks recomputed at a time) at 1 x 2048,
#   where the shared attention (32 heads of 80) reaches the flash threshold
#   and its mma route on the path;
# * seamless-m4t-large-v2 (slice 16; 2.03 B, 4.1 GB): 2 x 512 target tokens
#   over 2 x ENC_FRAMES frames, remat none (the reference ignores remat on
#   this family). The encoder keeps ≈ 24 x 4096 x 8192 x 2 B x 3 = 4.8 GB of
#   MLP activations, the decoder ≈ 1.2 GB, the float32 logits and their
#   gradient 2 x 1.05 GB: a peak near 15 GB. The encoder's self-attention
#   and the cross-attention (Skv = 2048 frames) reach the flash threshold,
#   not causal; the decoder's self-attention (512) stays dense.
FAMILY_TRAIN = {"qwen2-vl-2b": (4, 512, "none"), "falcon-mamba-7b": (2, 512, "none"),
                "zamba2-2.7b": (1, 2048, "full"), "seamless-m4t-large-v2": (2, 512, "none")}
# greedy generation through prefill + decode_step with the trained adapter;
# the encoder-decoder's prompt is ENC_FRAMES frames and ENCDEC_PROMPT tokens
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 512, 64
ENC_FRAMES, ENCDEC_PROMPT = 2048, 16
# slice 16: the packed families' training steps after the 2 warm-up ones, and
# their greedy tokens (from a PACKED_PROMPT-token prompt; the frames as above)
PACKED_STEPS, PACKED_NEW, PACKED_PROMPT = 3, 16, 64
# the projections the SSM families adapt that no earlier phase reached:
# (arch, name, K, N, bias); zamba2's shared block has qwen2-like shapes
FAMILY_LINEAR = (("falcon-mamba-7b", "in_proj", 4096, 16384, False),
                 ("falcon-mamba-7b", "x_proj", 8192, 288, False),
                 ("falcon-mamba-7b", "dt_proj", 256, 8192, True),
                 ("falcon-mamba-7b", "out_proj", 8192, 4096, False),
                 ("zamba2-2.7b", "in_proj", 2560, 10240, False),
                 ("zamba2-2.7b", "bc_proj", 5120, 128, False),
                 ("zamba2-2.7b", "dt_proj", 2560, 80, True),
                 ("zamba2-2.7b", "out_proj", 5120, 2560, False))
# slice 16: seamless-m4t-large-v2's projections at the rows they run at,
# (name, M, K, N): the encoder at 2 x 2048 frames (the cross k/v projections
# read the encoder's output at the same M and shape as its wq), the decoder
# at 2 x 512 tokens
SEAMLESS_LINEAR = (("enc wq, cross wk / wv", 4096, 1024, 1024),
                   ("enc wgate / wup", 4096, 1024, 8192), ("enc wdown", 4096, 8192, 1024),
                   ("dec self / cross wq", 1024, 1024, 1024), ("dec wgate / wup", 1024, 1024, 8192),
                   ("dec wdown", 1024, 8192, 1024))
# the packed shapes no earlier phase ran fused_linear_q at: (arch, name, M, K,
# N, bias) at the training rows
FAMILY_PACKED = (("falcon-mamba-7b", "x_proj", 1024, 8192, 288, False),
                 ("falcon-mamba-7b", "dt_proj", 1024, 256, 8192, True),
                 ("zamba2-2.7b", "bc_proj", 2048, 5120, 128, False),
                 ("zamba2-2.7b", "dt_proj", 2048, 2560, 80, True),
                 ("seamless-m4t-large-v2", "enc wgate", 4096, 1024, 8192, False),
                 ("seamless-m4t-large-v2", "dec wdown", 1024, 8192, 1024, False))


def family_stacks(cfg) -> list:
    """(name, shape) of every stack NeuroAda selects on in the SSM, hybrid
    and encoder-decoder families (the transformer families:
    :func:`weight_stacks`)."""
    d, di, n, v = cfg.d_model, cfg.resolved_d_inner, cfg.ssm_state, cfg.padded_vocab
    if cfg.family == "encdec":
        hd, f = cfg.resolved_head_dim, cfg.d_ff
        dq, dkv = cfg.num_heads * hd, cfg.num_kv_heads * hd

        def layer(L, attn):
            out = []
            for p in attn:
                out += [(p + "wq", (L, d, dq)), (p + "wk", (L, d, dkv)), (p + "wv", (L, d, dkv)),
                        (p + "wo", (L, dq, d))]
            return out + [("wgate", (L, d, f)), ("wup", (L, d, f)), ("wdown", (L, f, d))]

        return ([("enc " + a, sh) for a, sh in layer(cfg.encoder_layers, ("",))]
                + [("dec " + a, sh) for a, sh in layer(cfg.num_layers, ("self_", "cross_"))]
                + [("head", (d, v))])
    if cfg.family == "ssm":
        L, dtr = (cfg.num_layers,), cfg.resolved_dt_rank
        return [("in_proj", (*L, d, 2 * di)), ("x_proj", (*L, di, dtr + 2 * n)),
                ("dt_proj", (*L, dtr, di)), ("out_proj", (*L, di, d)), ("head", (d, v))]
    g = (cfg.num_layers // cfg.attn_every, cfg.attn_every)
    hd = cfg.resolved_head_dim
    dq, dkv, f = cfg.num_heads * hd, cfg.num_kv_heads * hd, cfg.d_ff
    return [("in_proj", (*g, d, 2 * di)), ("bc_proj", (*g, di, 2 * n)),
            ("dt_proj", (*g, d, cfg.ssm_heads)), ("out_proj", (*g, di, d)),
            ("wq", (d, dq)), ("wk", (d, dkv)), ("wv", (d, dkv)), ("wo", (dq, d)),
            ("wgate", (d, f)), ("wup", (d, f)), ("wdown", (f, d)), ("head", (d, v))]


def dense_decode_cost(q, k, vl) -> tuple[float, float]:
    """Of the slot cache only each slot's first ``vl`` rows of k and v read,
    q read and out written once; 4·hd flops a (query head, row) pair."""
    b, _, h, hd = q.shape
    rows = float(vl.sum())
    nbytes = 2 * rows * k.shape[2] * hd * k.element_size() + 2 * q.numel() * q.element_size()
    return nbytes + b * 4, 4.0 * h * hd * rows


def family_kernels(gen, dev, summary, detail, card: str) -> None:
    """The kernels at the shapes this slice's paths first run them at, each
    against its plain version: ``fused_linear`` on both routes (the TMA +
    wgmma one the wrapper picks, and the WMMA kernel called directly) and
    ``sparse_delta_dval`` at every SSM projection of FAMILY_LINEAR at its
    training rows (falcon-mamba's x_proj N = 288 and dt_proj K = 256,
    zamba2's dt_proj N = 80 and bc_proj N = 128); ``topk_select`` over every
    falcon-mamba and zamba2 stack (the two-level (9, 6, d_in, d_out) ones
    included), indices and order exactly; the dense decode at zamba2's 32
    query and 32 kv heads of 80 (group 1) over a (4, 576) slot cache; the
    flash forward at hd 80 on its mma route at zamba2's 1 x 2048. Slice 16:
    ``fused_linear`` and ``sparse_delta_dval`` at seamless's projections
    (SEAMLESS_LINEAR), ``topk_select`` over its 18 stacks and head, the
    dense decode at its 16 / 16 heads of 64 (group 1), the flash forward
    not causal at (2, 2048, 16, 64) and (2, 512, 16, 64) queries against
    2048 keys (the encoder's and the cross-attention's, wgmma route), and
    ``fused_linear_q`` (int8 and NF4) at FAMILY_PACKED's shapes, at the
    training rows (timed) and the decode rows, and on layers of a two-level
    packed (g, per, K, N) stack. Timed in bf16 beside the plain version,
    the bound and a one-call yardstick where there is one, into each
    kernel's ``families`` entry."""
    dt = torch.bfloat16
    fam = {n: {} for n in ("fused_linear", "sparse_delta_dval", "topk_select",
                           "decode_attention", "flash_attention_fwd", "fused_linear_q")}

    def add(kernel, arch, row, nbytes, flops):
        acc = fam[kernel].setdefault(arch, {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                                            "bytes": 0.0, "flops": 0.0, "max_abs_err": 0.0,
                                            "cases": []})
        acc["ms"] += row["ms"]
        acc["plain_ms"] += row["plain_ms"]
        acc["library_ms"] = (None if acc["library_ms"] is None or row["library_ms"] is None
                             else acc["library_ms"] + row["library_ms"])
        acc["bytes"] += nbytes
        acc["flops"] += flops
        acc["max_abs_err"] = max(acc["max_abs_err"], row["max_abs_err"])
        acc["cases"].append(row["case"])
        detail.append({"kernel": kernel, "arch": arch, **row})

    linear = [(arch, name, math.prod(FAMILY_TRAIN[arch][:2]), kd, n, has_bias)
              for arch, name, kd, n, has_bias in FAMILY_LINEAR]
    linear += [("seamless-m4t-large-v2", name, m, kd, n, False)
               for name, m, kd, n in SEAMLESS_LINEAR]
    for arch, name, m, kd, n, has_bias in linear:
        x = torch.randn(m, kd, generator=gen, device=dev).to(dt)
        w = (torch.randn(kd, n, generator=gen, device=dev) * kd**-0.5).to(dt)
        idx = torch.randint(0, kd, (TRAIN_K, n), generator=gen, device=dev, dtype=torch.int32)
        val = (torch.randn(TRAIN_K, n, generator=gen, device=dev) * 0.05).to(dt)
        bias = (torch.randn(n, generator=gen, device=dev) * 0.1).to(dt) if has_bias else None
        dy = (torch.randn(m, n, generator=gen, device=dev) * m**-0.5).to(dt)
        case = f"{arch} {name} M={m} K={kd} N={n}{' +bias' if has_bias else ''}, k={TRAIN_K}"
        want = fl_mod.fused_linear_plain(x, w, idx, val, bias)
        reset_counters()
        got = fl_mod.fused_linear(x, w, idx, val, bias)
        r = fl_mod.route(m, kd, n, dt, (x.data_ptr(), w.data_ptr()))
        expect_route(COUNTERS["fused_linear"], r, 1, f"fused_linear {case}")
        wmma = old_fused_linear(x, w, idx, val, bias)
        err = check_close(f"fused_linear {case} ({r})", got, want, dt)
        err = max(err, check_close(f"fused_linear {case} (WMMA)", wmma(), want, dt))
        lib = (lambda: torch.addmm(bias, x, w)) if has_bias else (lambda: torch.mm(x, w))
        row = {"case": case, "route": r, "max_abs_err": err,
               "ms": cuda_ms(lambda: fl_mod.fused_linear(x, w, idx, val, bias)),
               "wmma_ms": cuda_ms(wmma),
               "plain_ms": cuda_ms(lambda: fl_mod.fused_linear_plain(x, w, idx, val, bias),
                                   iters=3),
               "library_ms": cuda_ms(lib)}
        cost = linear_cost(x, w, idx, val, bias)
        row["bound_ms"], row["bound_by"] = bound(*cost, dt)
        add("fused_linear", arch, row, *cost)
        got = sd_mod.sparse_delta_dval(x, idx, dy)
        err = check_close(f"sparse_delta_dval {case}", got,
                          sd_mod.sparse_delta_dval_plain(x, idx, dy), dt)
        assert torch.equal(got, sd_mod.sparse_delta_dval(x, idx, dy)), case
        row = {"case": case, "max_abs_err": err,
               "ms": cuda_ms(lambda: sd_mod.sparse_delta_dval(x, idx, dy)),
               "plain_ms": cuda_ms(lambda: sd_mod.sparse_delta_dval_plain(x, idx, dy), iters=3),
               "library_ms": None}
        cost = dval_cost(x, idx, dy)
        row["bound_ms"], row["bound_by"] = bound(*cost, dt)
        add("sparse_delta_dval", arch, row, *cost)
        del x, w, dy, want, got
    for arch in FAMILY_ARCHS[1:]:
        for name, shape in family_stacks(get_config(arch)):
            w = torch.randn(shape, generator=gen, device=dev, dtype=dt)
            got, want = ops.topk_select(w, TRAIN_K), ts_mod.topk_select_plain(w, TRAIN_K)
            assert torch.equal(got, want), f"topk_select {arch} {name} {shape}"
            row = {"case": f"{name} {list(shape)}", "max_abs_err": 0.0,
                   "ms": cuda_ms(lambda: ops.topk_select(w, TRAIN_K)),
                   "plain_ms": cuda_ms(lambda: ts_mod.topk_select_plain(w, TRAIN_K), iters=1,
                                       warmup=1),
                   "library_ms": cuda_ms(lambda: torch.topk(w.abs(), TRAIN_K, dim=-2))}
            nbytes = w.numel() * w.element_size() + got.numel() * 4
            row["bound_ms"], row["bound_by"] = bound(nbytes, 0.0, dt)
            add("topk_select", arch, row, nbytes, 0.0)
            del w, got, want
        torch.cuda.empty_cache()
    # the dense decode: zamba2's shared attention (32 query and 32 kv heads of
    # 80) over a 512-token prompt's cache, seamless's decoder self-attention
    # (16 / 16 of 64) over its 16-token prompt's
    for arch, prompt in (("zamba2-2.7b", GEN_PROMPT), ("seamless-m4t-large-v2", ENCDEC_PROMPT)):
        cfg = get_config(arch)
        h, hd = cfg.num_heads, cfg.resolved_head_dim
        smax = prompt + GEN_NEW
        q = torch.randn(GEN_BATCH, 1, h, hd, generator=gen, device=dev).to(dt)
        k = torch.randn(GEN_BATCH, smax, h, hd, generator=gen, device=dev).to(dt)
        v = torch.randn(GEN_BATCH, smax, h, hd, generator=gen, device=dev).to(dt)
        vl = torch.tensor([prompt, smax // 2, smax, 1], dtype=torch.int32, device=dev)
        reset_counters()
        got = dd_mod.decode_attention(q, k, v, vl)
        expect_route(COUNTERS["decode_attention"], dec_mod.ROUTE, 1, f"dense decode hd {hd}")
        err = check_close(f"decode_attention {arch}", got,
                          dd_mod.decode_attention_plain(q, k, v, vl), dt)
        mask = (torch.arange(smax, device=dev)[None, :] < vl[:, None])[:, None, None, :]
        row = {"case": f"q ({GEN_BATCH},1,{h},{hd}), cache ({GEN_BATCH},{smax},{h},{hd}), "
                       f"frontiers {vl.tolist()}", "max_abs_err": err,
               "ms": cuda_ms(lambda: dd_mod.decode_attention(q, k, v, vl)),
               "plain_ms": cuda_ms(lambda: dd_mod.decode_attention_plain(q, k, v, vl), iters=3),
               "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                   q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask))}
        cost = dense_decode_cost(q, k, vl)
        row["bound_ms"], row["bound_by"] = bound(*cost, dt)
        add("decode_attention", arch, row, *cost)
    # the flash forward: zamba2's causal hd 80 (mma route); seamless's encoder
    # self-attention and cross-attention, not causal, against 2048 frames
    zc = get_config("zamba2-2.7b")
    h, hd = zc.num_heads, zc.resolved_head_dim
    s = FAMILY_TRAIN["zamba2-2.7b"][1]
    sc = get_config("seamless-m4t-large-v2")
    flash_shapes = [("zamba2-2.7b", (1, s, h, hd), (1, s, h, hd), True, "mma")]
    b_, sq_ = FAMILY_TRAIN["seamless-m4t-large-v2"][:2]
    kv_shape = (b_, ENC_FRAMES, sc.num_kv_heads, sc.resolved_head_dim)
    flash_shapes += [("seamless-m4t-large-v2", (b_, n, sc.num_heads, sc.resolved_head_dim),
                      kv_shape, False, "wgmma") for n in (ENC_FRAMES, sq_)]
    for arch, q_shape, kv_shape, causal, want_route in flash_shapes:
        q = torch.randn(q_shape, generator=gen, device=dev).to(dt)
        k, v = (torch.randn(kv_shape, generator=gen, device=dev).to(dt) for _ in range(2))
        out, lse = flash_call(f"flash {arch} {q_shape}", q, k, v, causal)
        assert fa_mod.route(q, k, v) == want_route, (fa_mod.route(q, k, v), want_route)
        fr = check_flash(f"flash_attention_fwd {arch} {q_shape}", q, k, v, causal, out, lse)
        row = {"case": f"q {q_shape}, k/v {kv_shape}, {'causal' if causal else 'not causal'}, "
                       f"route {want_route}", **fr,
               "ms": cuda_ms(lambda: fa_mod.flash_attention_fwd(q, k, v, causal=causal)),
               "plain_ms": cuda_ms(lambda: fa_mod.flash_attention_fwd_plain(q, k, v,
                                                                            causal=causal),
                                   iters=3),
               "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                   q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal))}
        cost = flash_cost(q, k, causal)
        row["bound_ms"], row["bound_by"] = bound(*cost, dt)
        add("flash_attention_fwd", arch, row, *cost)
        del q, k, v, out, lse
    packed_family_kernels(gen, dev, add)
    for kernel, by_arch in fam.items():
        for arch, acc in by_arch.items():
            acc["bound_ms"], acc["bound_by"] = bound(acc.pop("bytes"), acc.pop("flops"), dt)
            lib = acc["library_ms"]
            lib = "none" if lib is None else f"{lib:.4f}"
            log(f"[kernels-families] {kernel} at {arch}'s {len(acc['cases'])} new shapes: "
                f"{acc['ms']:.4f} ms (plain {acc['plain_ms']:.4f}, bound {acc['bound_ms']:.4f} "
                f"by {acc['bound_by']}, one-call yardstick {lib}); max|err| "
                f"{acc['max_abs_err']:.3e} [{card}]")
        summary.setdefault(kernel, {})["families"] = by_arch
    torch.cuda.empty_cache()


def packed_family_kernels(gen, dev, add) -> None:
    """``fused_linear_q`` (int8 and NF4, block QUANT_BLOCK) at FAMILY_PACKED's
    shapes against its plain version: at the training rows (k = 1, timed,
    beside ``torch.mm`` / ``addmm`` on the dense weight), and at the decode
    rows (M = GEN_BATCH, k = 1: generation with the trained adapter), each
    launch on the route ``quant_linear.route`` names; then two layers of a
    packed two-level (g, per, K, N) stack (zamba2's bc_proj) are the bytes
    of the layer packed alone and run as such."""
    dt, counter = torch.bfloat16, COUNTERS["fused_linear_q"]
    for arch, name, m, kd, n, has_bias in FAMILY_PACKED:
        w = (torch.randn(kd, n, generator=gen, device=dev) * kd**-0.5).to(dt)
        idx = torch.randint(0, kd, (TRAIN_K, n), generator=gen, device=dev, dtype=torch.int32)
        val = (torch.randn(TRAIN_K, n, generator=gen, device=dev) * 0.05).to(dt)
        bias = (torch.randn(n, generator=gen, device=dev) * 0.1).to(dt) if has_bias else None
        for qd in PACKED:
            qt = quantize(w, qd, QUANT_BLOCK)
            for rows in (m, GEN_BATCH):
                x = torch.randn(rows, kd, generator=gen, device=dev).to(dt)
                args = (x, qt.data, qt.scales, idx, val, bias)
                case = (f"{arch} {name} {qd} M={rows} K={kd} N={n}"
                        f"{' +bias' if has_bias else ''}, k={TRAIN_K}")
                fn = lambda: ql_mod.fused_linear_q(*args, qdtype=qd, block=QUANT_BLOCK)  # noqa: E731
                plain = lambda: ql_mod.fused_linear_q_plain(*args, qdtype=qd,  # noqa: E731
                                                            block=QUANT_BLOCK)
                counter.reset()
                got = fn()
                r = ql_mod.route(rows, kd, n, dt, (x.data_ptr(), qt.data.data_ptr(),
                                                   qt.scales.data_ptr()))
                expect_route(counter, r, 1, f"fused_linear_q {case}")
                err = check_close(f"fused_linear_q {case} ({r})", got, plain(), dt)
                if rows == GEN_BATCH:
                    continue
                lib = ((lambda: torch.addmm(bias, x, w)) if has_bias  # noqa: E731
                       else (lambda: torch.mm(x, w)))
                row = {"case": case, "route": r, "max_abs_err": err, "ms": cuda_ms(fn),
                       "plain_ms": cuda_ms(plain, iters=3), "library_ms": cuda_ms(lib)}
                cost = packed_cost(x, qt, TRAIN_K, val, bias)
                row["bound_ms"], row["bound_by"] = bound(*cost, dt)
                add("fused_linear_q", f"{arch} {qd}", row, *cost)
    cfg = get_config("zamba2-2.7b")
    g, per = cfg.num_layers // cfg.attn_every, cfg.attn_every
    kd, n = cfg.resolved_d_inner, 2 * cfg.ssm_state
    stack = (torch.randn(g, per, kd, n, generator=gen, device=dev) * kd**-0.5).to(dt)
    x = torch.randn(FAMILY_TRAIN["zamba2-2.7b"][1], kd, generator=gen, device=dev).to(dt)
    idx = torch.randint(0, kd, (TRAIN_K, n), generator=gen, device=dev, dtype=torch.int32)
    val = (torch.randn(TRAIN_K, n, generator=gen, device=dev) * 0.05).to(dt)
    for qd in PACKED:
        qs = quantize(stack, qd, QUANT_BLOCK)
        for i, j in ((0, 0), (g - 1, per - 1)):
            layer, alone = qs[i][j], quantize(stack[i, j], qd, QUANT_BLOCK)
            assert torch.equal(layer.data, alone.data) and torch.equal(layer.scales,
                                                                       alone.scales), (qd, i, j)
            args = (x, layer.data, layer.scales, idx, val, None)
            check_close(f"fused_linear_q {qd} zamba2 bc_proj stack [{i}][{j}]",
                        ql_mod.fused_linear_q(*args, qdtype=qd, block=QUANT_BLOCK),
                        ql_mod.fused_linear_q_plain(*args, qdtype=qd, block=QUANT_BLOCK), dt)
    log(f"[kernels-families] fused_linear_q ok at {len(FAMILY_PACKED)} packed family shapes x "
        f"int8 / NF4 at the training and decode rows, and on layers [0][0] and [{g - 1}]"
        f"[{per - 1}] of a packed ({g}, {per}, {kd}, {n}) stack (bytes of the layer packed "
        f"alone)")


def vlm_batches(cfg, batch: int, seq: int, steps: int, seed: int = 0):
    """VLM training batches: ``int(seq * image_frac)`` random patch
    embeddings first, then text from the ``lm`` task, and (3, B, seq) M-RoPE
    positions: the patches on a square-ish grid at t = 0, the text after it
    with t = h = w running on from the grid's extent."""
    s_img, s_txt = get_model(cfg).vlm_split(seq)
    side = math.isqrt(s_img)
    grid = np.stack([np.zeros(s_img), np.arange(s_img) // side, np.arange(s_img) % side])
    text = np.arange(s_txt)[None, :] + grid.max() + 1 + np.zeros((3, 1))
    pos = np.broadcast_to(np.concatenate([grid, text], 1).astype(np.int32)[:, None],
                          (3, batch, seq)).copy()
    rng = np.random.default_rng(seed)
    for i in range(steps):
        b = TASKS["lm"](cfg.vocab_size, batch, s_txt, seed, i)
        b["patches"] = rng.standard_normal((batch, s_img, cfg.d_model)).astype(np.float32)
        b["positions"] = pos
        yield b


def family_step_launches(cfg, remat: str, seq: int, packed: bool = False) -> dict:
    """Launches a NeuroAda training step makes: every adapted projection
    once forward (``fused_linear``, ``fused_linear_q`` on a ``packed`` base,
    where an untied head's base matmul is one more; once more when
    ``remat`` recomputes the layer) and once backward
    (``sparse_delta_dval``); the untied heads of the SSM, hybrid and
    encoder-decoder families take no bypass (as in the reference); a flash
    forward an attention site from the threshold on (the encoder-decoder's
    encoder and cross-attention over ENC_FRAMES frames, its decoder's
    self-attention at ``seq``)."""
    rec = 2 if remat != "none" else 1
    if cfg.family == "ssm":
        n, sites = 4 * cfg.num_layers, 0
    elif cfg.family == "hybrid":
        sites = cfg.num_layers // cfg.attn_every
        n = 7 * sites + 4 * cfg.num_layers
    elif cfg.family == "encdec":
        n = 7 * cfg.encoder_layers + 11 * cfg.num_layers
        sites = ((cfg.encoder_layers + cfg.num_layers) * (ENC_FRAMES >= cfg.flash_threshold)
                 + cfg.num_layers * (seq >= cfg.flash_threshold))
    else:
        n, sites = 7 * cfg.num_layers, cfg.num_layers * (seq >= cfg.flash_threshold)
    if cfg.family in ("ssm", "hybrid"):
        sites *= seq >= cfg.flash_threshold
    head = 0 if cfg.tie_embeddings else 1
    linear = {"fused_linear_q": rec * n + head} if packed else {"fused_linear": rec * n}
    out = {**linear, "sparse_delta_dval": n}
    if sites:
        out["flash_attention_fwd"] = rec * sites
    return out


def gen_inputs(cfg, rows: int, prompt: int, seed: int = 23) -> tuple:
    """(prompt tokens (rows, prompt) on the card, the encoder-decoder's
    (rows, ENC_FRAMES, D) bf16 frames or None)."""
    rng = np.random.default_rng(seed)
    toks = torch.tensor(rng.integers(3, cfg.vocab_size, (rows, prompt)), dtype=torch.int32,
                        device="cuda")
    if cfg.family != "encdec":
        return toks, None
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return toks, torch.randn(rows, ENC_FRAMES, cfg.d_model, generator=gen, device="cuda",
                             dtype=torch.bfloat16)


def family_data(cfg, batch: int, seq: int, steps: int) -> tuple:
    """(training batches, their closer): the VLM's patch batches, the lm
    task's (with ``frames`` of (batch, ENC_FRAMES, D) on the card for the
    encoder-decoder, the same each step)."""
    if cfg.family == "vlm":
        return vlm_batches(cfg, batch, seq, steps), lambda: None
    loader = DataLoader("lm", cfg.vocab_size, batch, seq, seed=0)
    if cfg.family != "encdec":
        return loader, loader.close
    frames = gen_inputs(cfg, batch, 1, seed=0)[1]
    return (dict(b, frames=frames) for b in loader), loader.close


def gen_launches_want(cfg, prompt: int, new: int) -> dict:
    """Adapted-projection launches and dense decode launches of a prefill
    over ``prompt`` tokens and ``new`` decode steps: every projection once
    in the prefill; in a decode step every projection (the encoder-decoder's
    decoder layers alone, without their cross k/v, which are cached: 9 a
    layer), and one dense decode an attention site."""
    n_proj = family_step_launches(cfg, "none", prompt)["sparse_delta_dval"]
    per_step = 9 * cfg.num_layers if cfg.family == "encdec" else n_proj
    sites = {"ssm": 0, "hybrid": cfg.num_layers // max(cfg.attn_every, 1)}.get(cfg.family,
                                                                              cfg.num_layers)
    return {"proj": n_proj + new * per_step, "decode_attention": sites * new}


def phase_family_reduced(card: str, arch: str, base: str = "bf16") -> None:
    """The reduced twin in fp32 card vs CPU, on a dense base or one packed
    to ``base``: three training steps (losses 1e-5, values, selected
    indices: ``phase_reduced_train``'s bounds), and greedy tokens from
    prefill + 8 decode steps with a random adapter, identical on both. The
    encoder-decoder runs with the flash threshold lowered (REDUCED_FLASH),
    so its encoder and cross-attention take the non-causal flash kernel,
    and generates over 64 frames."""
    enc = get_config(arch).family == "encdec"
    phase_reduced_train(card, base, arch, flash=enc)
    cfg = reduced(get_config(arch)).replace(dtype="float32", **(REDUCED_FLASH if enc else {}))
    model = get_model(cfg)
    params = model.init(seed=0, device="cpu")
    if base != "bf16":
        params = quantize_base(params, base, block=QUANT_BLOCK)
    (idx, val), = random_tenants(params, 1, seed=3, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(1)
    prompt = torch.tensor(rng.integers(3, cfg.vocab_size, (2, 24)), dtype=torch.int32)
    frames = (torch.from_numpy(rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32))
              if enc else None)
    outs = []
    for dev in ("cpu", "cuda"):
        move = lambda t: map_leaves(lambda x: None if x is None else x.to(dev), t)  # noqa: E731
        reset_counters()
        fr = None if frames is None else frames.to(dev)
        outs.append(generate(model, move(params), zip_adapters(move(idx), move(val)),
                             prompt.to(dev), 8, fr)[0].cpu())
        assert dev == "cpu" or all(c.plain == 0 for c in COUNTERS.values())
        # the prefill's encoder self-attention and cross-attention, a layer each
        assert not enc or dev == "cpu" or (
            COUNTERS["flash_attention_fwd"].kernel == cfg.encoder_layers + cfg.num_layers)
    assert torch.equal(outs[0], outs[1]), f"{arch} reduced greedy tokens: cpu {outs[0]} != " \
                                          f"cuda {outs[1]}"
    log(f"[reduced-{arch}{'' if base == 'bf16' else '-' + base}] greedy tokens from prefill + 8 "
        f"decode steps with an adapter{' (non-causal flash in the prefill)' if enc else ''}: "
        f"identical on cpu (plain) and cuda (kernels) [{card}]")


# the decode caches' leaves with a sequence axis (dense, hybrid, encoder-decoder)
KV_LEAVES = ("k", "v", "shared_k", "shared_v", "self_k", "self_v")


def extend_cache(cache: dict, n: int) -> dict:
    """The cache ``prefill`` returned with ``n`` more rows on the sequence
    axis of every KV leaf (the recurrent states keep their shape)."""
    return {k: F.pad(v, (0, 0, 0, 0, 0, n)) if k in KV_LEAVES else v for k, v in cache.items()}


def generate(model, params, adapters, prompt, new: int, frames=None) -> tuple:
    """Greedy tokens (B, new) from ``prefill`` over ``prompt`` (B, S) (and
    the encoder-decoder's ``frames``) and ``new`` decode steps; and the
    seconds of the prefill and of the decode steps (each ends in a
    synchronize on the card)."""
    sync = torch.cuda.synchronize if prompt.is_cuda else (lambda: None)
    b, s = prompt.shape
    batch = {"tokens": prompt} if frames is None else {"tokens": prompt, "frames": frames}
    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, adapters, batch)
        cache = extend_cache(cache, new)
        sync()
        t1 = time.perf_counter()
        toks = []
        for i in range(new):
            tok = logits.argmax(-1).to(torch.int32)
            toks.append(tok)
            logits = model.decode_step(params, adapters, cache, {
                "token": tok, "pos": torch.full((b,), s + i, dtype=torch.int32,
                                                device=prompt.device)})
        sync()
        t2 = time.perf_counter()
    assert torch.isfinite(logits).all(), "generation gave non-finite logits"
    return torch.stack(toks, 1), t1 - t0, t2 - t1


def phase_family(card: str, arch: str) -> dict:
    """Full published width and depth in bf16, random weights from a seed:
    selection (k = 1, timed, ``topk_select`` launches), NeuroAda training
    (FAMILY_TRAIN; 2 warm-up + TRAIN_STEPS timed steps; only the path's
    kernels, no plain version; peak memory; one profiled step), then greedy
    generation with the trained adapter through prefill + decode_step
    (GEN_BATCH x GEN_PROMPT, GEN_NEW new tokens; decode tok/s)."""
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    model = get_model(cfg)
    batch, seq, remat = FAMILY_TRAIN[arch]
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    shapes = adapt_mod.adaptable_shapes(params)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counters()
    t0 = time.perf_counter()
    trainer = Trainer(model, get_peft(PeftConfig(k=TRAIN_K)),
                      TrainConfig(steps=TRAIN_WARMUP + TRAIN_STEPS + 1, learning_rate=TRAIN_LR,
                                  remat=remat), params)
    torch.cuda.synchronize()
    select_s = time.perf_counter() - t0
    select_peak = torch.cuda.max_memory_allocated() - held
    n_select = COUNTERS["topk_select"].kernel
    assert all(c.plain == 0 for c in COUNTERS.values()), "selection called a plain version"
    assert n_select == len(shapes), (n_select, shapes)
    st = stats(params, trainer.state.trainable)
    assert st["trainable"] == sum(TRAIN_K * math.prod(s[:-2]) * s[-1] for s in shapes.values())
    log(f"[family-{arch}] {arch} bf16 at full width and depth ({st['total']:,} parameters, "
        f"init {init_s:.2f} s), NeuroAda k={TRAIN_K} magnitude: trainable {st['trainable']:,} "
        f"({100 * st['fraction']:.4f} % of the parameters), selection {select_s:.3f} s "
        f"({n_select} topk_select launches, one a stack: {json.dumps({k: list(v) for k, v in shapes.items()})}; "
        f"peak {select_peak / 2**20:.1f} MiB above the {held / 2**30:.2f} GiB held) [{card}]")
    data, closer = family_data(cfg, batch, seq, TRAIN_WARMUP + TRAIN_STEPS + 1)
    want = family_step_launches(cfg, remat, seq)
    try:
        for _ in range(TRAIN_WARMUP):
            trainer.step(next(data))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        times, losses, peak = [], [], 0
        for _ in range(TRAIN_STEPS):
            step_batch = next(data)
            t0 = time.perf_counter()
            m = trainer.step(step_batch)
            times.append(time.perf_counter() - t0)
            peak = max(peak, torch.cuda.max_memory_allocated())
            losses.append(m["loss"])
            assert m["skipped"] == 0, m
        launches = {n: COUNTERS[n].kernel for n in want}
        for name, c in COUNTERS.items():
            assert c.plain == 0, f"{arch} training called the plain version of {name}"
            assert name in want or c.kernel == 0, f"{arch} training launched {name}"
        per_step = {n: v / TRAIN_STEPS for n, v in launches.items()}
        assert per_step == want, (per_step, want)
        routes = {n: dict(COUNTERS[n].routes) for n in want}
        assert all(np.isfinite(losses)), losses
        buckets = {}
        busy, _, _ = profile_run(lambda: trainer.step(next(data)), card,
                                 f"family-{arch}-profile", f"train_{arch}_profile.txt", buckets)
    finally:
        closer()
    med = float(np.median(times))
    tok = batch * seq
    log(f"[family-{arch}] losses {[round(x, 4) for x in losses]} (all finite) [{card}]")
    what = {"vlm": " (a quarter patches, M-RoPE positions)",
            "encdec": f" over {ENC_FRAMES} frames"}.get(cfg.family, "")
    log(f"[family-{arch}] {TRAIN_STEPS} steps of batch {batch} x seq {seq}{what}, remat "
        f"{remat}: step time median {med * 1e3:.2f} ms (min {min(times) * 1e3:.2f}, max "
        f"{max(times) * 1e3:.2f}); {tok / med:.0f} training tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB; launches per step {json.dumps(per_step)} (routes "
        f"{json.dumps(routes)}), plain 0; device busy {busy:.1%} of a profiled step [{card}]")
    # greedy generation with the trained adapter
    adapters = zip_adapters(trainer.aux, trainer.state.trainable)
    gen_prompt = ENCDEC_PROMPT if cfg.family == "encdec" else GEN_PROMPT
    prompt, frames = gen_inputs(cfg, GEN_BATCH, gen_prompt)
    generate(model, params, adapters, prompt[:, :8], 2, frames)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    toks, pre_s, dec_s = generate(model, params, adapters, prompt, GEN_NEW, frames)
    gen_peak = torch.cuda.max_memory_allocated()
    gen_launches = {n: c.kernel for n, c in COUNTERS.items() if c.kernel}
    assert all(c.plain == 0 for c in COUNTERS.values()), "generation called a plain version"
    # the prefill and every decode step run each adapted projection once (the
    # encoder-decoder's decode steps not its cached cross k/v); one dense
    # decode an attention site a step; the encoder-decoder's prefill one flash
    # forward a layer of each stack (encoder, cross-attention)
    gw = gen_launches_want(cfg, gen_prompt, GEN_NEW)
    assert gen_launches.get("fused_linear") == gw["proj"], (gen_launches, gw)
    assert gen_launches.get("decode_attention", 0) == gw["decode_attention"], gen_launches
    if gw["decode_attention"]:
        expect_route(COUNTERS["decode_attention"], dec_mod.ROUTE, gw["decode_attention"],
                     f"{arch} decode at hd {cfg.resolved_head_dim}")
    if cfg.family == "encdec":
        assert gen_launches.get("flash_attention_fwd") == cfg.encoder_layers + cfg.num_layers
    assert toks.shape == (GEN_BATCH, GEN_NEW)
    with torch.no_grad():  # 8 decode steps under the profiler: the decode's busy share
        logits, cache = model.prefill(params, adapters, {"tokens": prompt} if frames is None
                                      else {"tokens": prompt, "frames": frames})
        cache = extend_cache(cache, 8)

        def decode_steps():
            tok = logits.argmax(-1).to(torch.int32)
            for i in range(8):
                tok = model.decode_step(params, adapters, cache, {
                    "token": tok, "pos": torch.full((GEN_BATCH,), gen_prompt + i,
                                                    dtype=torch.int32, device="cuda")}
                ).argmax(-1).to(torch.int32)

        dec_busy, _, _ = profile_run(decode_steps, card, f"family-{arch}-decode-profile",
                                     f"decode_{arch}_profile.txt")
        del cache
    log(f"[family-{arch}] greedy generation with the trained adapter, B={GEN_BATCH}, a "
        f"{gen_prompt}-token prompt{f' over {ENC_FRAMES} frames' if frames is not None else ''}, "
        f"{GEN_NEW} new tokens: prefill {pre_s * 1e3:.1f} ms, decode "
        f"{dec_s * 1e3:.1f} ms = {GEN_BATCH * GEN_NEW / dec_s:.1f} tok/s "
        f"({dec_s / GEN_NEW * 1e3:.2f} ms a step); peak memory {gen_peak / 2**30:.2f} GiB; "
        f"launches {json.dumps(gen_launches)}, plain 0; device busy {dec_busy:.1%} of 8 "
        f"profiled decode steps [{card}]")
    result = {"card": card, "arch": arch, "batch": batch, "seq": seq, "remat": remat,
              "total_params": st["total"], "trainable": st["trainable"],
              "fraction": st["fraction"], "select_s": select_s, "select_launches": n_select,
              "losses": losses, "step_s": times, "peak_bytes": peak,
              "launches_per_step": per_step, "routes": routes, "busy_share": busy,
              "profiled_step_device_us_by_bucket": buckets,
              "generate": {"batch": GEN_BATCH, "prompt": gen_prompt, "new": GEN_NEW,
                           "prefill_s": pre_s, "decode_s": dec_s,
                           "tok_s": GEN_BATCH * GEN_NEW / dec_s, "peak_bytes": gen_peak,
                           "decode_busy_share": dec_busy,
                           "launches": gen_launches}}
    with open(os.path.join(OUT_DIR, f"train_{arch}.json"), "w") as f:
        json.dump(result, f, indent=1)
    out = {"train_launches": launches, "select_launches": n_select,
           "gen_launches": gen_launches}
    if cfg.family == "vlm":
        out["serve_launches"] = vlm_gate(card, model, params, trainer)
        out["kv_launches"] = vlm_gate(card, model, params, trainer, kv_dtype="int8")
    del trainer, params
    torch.cuda.empty_cache()
    return out


def vlm_gate(card: str, model, params, trainer, kv_dtype: str = "fp32") -> dict:
    """qwen2-vl-2b's multi-tenant paged gate run, qwen2-1.5b's settings:
    the trained adapter and 2 random tenants on its indices (k = 1: a
    store holds one adapter shape) beside the base, the gate
    run's 10 prompts (text; plain RoPE, as the reference's engine), every
    forward and token draw under the sync guard, on a bf16 pool or (slice
    16) an int8 one. Every request ends, only the serving kernels (paged
    prefill, ring decode, both of ``kv_dtype``'s body, and the fused
    bypass) launch, one transfer a step, the pool drains."""
    prompts, max_new, kw = gate_prompts(model.cfg.vocab_size), 32, gate_kw()
    kw["kv_dtype"] = kv_dtype
    names = ("sparse_delta_batched",) + attention_names(True, kv_dtype)[0]
    tenants = [(trainer.aux, trainer.state.trainable)] + random_tenants(
        params, 2, seed=7, dtype=torch.bfloat16, device="cuda", idx=trainer.aux)
    serve(model, params, tenants, prompts[:2], 2, "cuda", **kw)  # warm-up
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    with forwards_never_wait(model):
        eng, reqs = serve(model, params, tenants, prompts, max_new, "cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: COUNTERS[n].kernel for n in names}
    decode_routes(f"vlm-gate-{kv_dtype}")
    apply_by_route = apply_routes(f"vlm-gate-{kv_dtype}", 7, forwards_of(eng))
    for name, c in COUNTERS.items():
        assert name not in names or c.kernel > 0, f"vlm gate run never launched {name}"
        assert name in names or c.kernel == 0, f"vlm gate run launched {name}"
        assert c.plain == 0, f"vlm gate run called the plain version of {name}"
    assert all(r.done and r.reason in ("eos", "max_new") for r in reqs)
    assert {r.adapter_id for r in reqs} == {0, 1, 2, 3}
    assert eng.transfers == eng.steps and eng.kv.drained()
    n_tok = sum(len(r.out) for r in reqs)
    log(f"[family-qwen2-vl-2b] paged {kv_dtype} gate run, the trained adapter + 2 random "
        f"tenants + the base: {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s ({n_tok / wall:.1f} tok/s); "
        f"steps {eng.steps}, one transfer each; launches {json.dumps(launches)}, applies "
        f"{json.dumps(apply_by_route)}, plain 0; pool drained [{card}]")
    return launches


def phase_family_packed(card: str, arch: str, qd: str) -> dict:
    """``arch`` at full width on a base packed to ``qd`` (block QUANT_BLOCK)
    after a bf16 init: selection one matrix at a time, 2 warm-up +
    PACKED_STEPS NeuroAda steps (FAMILY_TRAIN's shape; peak memory; only
    ``fused_linear_q``, ``sparse_delta_dval`` and where reckoned the flash
    forward, as many as reckoned; the packed bytes unchanged), then
    PACKED_NEW greedy tokens with the trained adapter (B = GEN_BATCH, a
    PACKED_PROMPT-token prompt, or ENCDEC_PROMPT tokens over ENC_FRAMES
    frames). Returns the launches."""
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    model = get_model(cfg)
    batch, seq, remat = FAMILY_TRAIN[arch]
    params = model.init(seed=0, device="cuda")
    shapes = adapt_mod.adaptable_shapes(params)
    params = quantize_base(params, qd, block=QUANT_BLOCK)  # the dense base is freed
    base_bytes = tree_bytes(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counters()
    t0 = time.perf_counter()
    trainer = Trainer(model, get_peft(PeftConfig(k=TRAIN_K)),
                      TrainConfig(steps=TRAIN_WARMUP + PACKED_STEPS, learning_rate=TRAIN_LR,
                                  remat=remat), params)
    torch.cuda.synchronize()
    select_s = time.perf_counter() - t0
    select_peak = torch.cuda.max_memory_allocated() - held
    n_select = COUNTERS["topk_select"].kernel
    assert all(c.plain == 0 for c in COUNTERS.values()), "selection called a plain version"
    assert n_select == sum(math.prod(s[:-2]) for s in shapes.values()), (n_select, shapes)
    data, closer = family_data(cfg, batch, seq, TRAIN_WARMUP + PACKED_STEPS)
    want = family_step_launches(cfg, remat, seq, packed=True)
    try:
        for _ in range(TRAIN_WARMUP):
            trainer.step(next(data))
        fingerprint = packed_fingerprint(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        times, losses = [], []
        for _ in range(PACKED_STEPS):
            step_batch = next(data)
            t0 = time.perf_counter()
            m = trainer.step(step_batch)
            times.append(time.perf_counter() - t0)
            losses.append(m["loss"])
            assert m["skipped"] == 0, m
        peak = torch.cuda.max_memory_allocated()
    finally:
        closer()
    launches = {n: COUNTERS[n].kernel for n in want}
    for name, c in COUNTERS.items():
        assert c.plain == 0, f"{arch} {qd} training called the plain version of {name}"
        assert name in want or c.kernel == 0, f"{arch} {qd} training launched {name}"
    per_step = {n: v / PACKED_STEPS for n, v in launches.items()}
    assert per_step == want, (per_step, want)
    assert all(np.isfinite(losses)), losses
    assert all(torch.equal(a, b) for a, b in zip(fingerprint, packed_fingerprint(params)))
    adapters = zip_adapters(trainer.aux, trainer.state.trainable)
    gen_prompt = ENCDEC_PROMPT if cfg.family == "encdec" else PACKED_PROMPT
    prompt, frames = gen_inputs(cfg, GEN_BATCH, gen_prompt)
    reset_counters()
    toks, pre_s, dec_s = generate(model, params, adapters, prompt, PACKED_NEW, frames)
    gen_launches = {n: c.kernel for n, c in COUNTERS.items() if c.kernel}
    assert all(c.plain == 0 for c in COUNTERS.values()), "generation called a plain version"
    gw = gen_launches_want(cfg, gen_prompt, PACKED_NEW)
    head = 0 if cfg.tie_embeddings else PACKED_NEW + 1  # the packed head's matmul a forward
    assert gen_launches.get("fused_linear_q") == gw["proj"] + head, (gen_launches, gw)
    assert "fused_linear" not in gen_launches, gen_launches
    assert gen_launches.get("decode_attention", 0) == gw["decode_attention"], gen_launches
    assert toks.shape == (GEN_BATCH, PACKED_NEW)
    med = float(np.median(times))
    log(f"[family-{arch}-{qd}] {qd} base ({base_bytes:,} bytes), selection {select_s:.3f} s "
        f"({n_select} topk_select launches, one a matrix; peak {select_peak / 2**20:.1f} MiB "
        f"above the {held / 2**30:.2f} GiB held); {PACKED_STEPS} steps of batch {batch} x seq "
        f"{seq}, remat {remat}: losses {[round(x, 4) for x in losses]}, step median "
        f"{med * 1e3:.2f} ms (min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), peak "
        f"{peak / 2**30:.2f} GiB, launches per step {json.dumps(per_step)}, plain 0, base "
        f"bytes unchanged; {PACKED_NEW} greedy tokens (B={GEN_BATCH}, {gen_prompt}-token "
        f"prompt): prefill {pre_s * 1e3:.1f} ms, decode {GEN_BATCH * PACKED_NEW / dec_s:.1f} "
        f"tok/s, launches {json.dumps(gen_launches)} [{card}]")
    result = {"card": card, "arch": arch, "base": qd, "base_bytes": base_bytes,
              "select_s": select_s, "select_launches": n_select, "select_peak_bytes": select_peak,
              "losses": losses, "step_s": times, "peak_bytes": peak,
              "launches_per_step": per_step,
              "generate": {"batch": GEN_BATCH, "prompt": gen_prompt, "new": PACKED_NEW,
                           "prefill_s": pre_s, "decode_s": dec_s, "launches": gen_launches}}
    with open(os.path.join(OUT_DIR, f"train_{arch}_{qd}.json"), "w") as f:
        json.dump(result, f, indent=1)
    del trainer, params, adapters
    torch.cuda.empty_cache()
    return {"train_launches": launches, "gen_launches": gen_launches,
            "select_launches": n_select}


def families(card: str, summary: dict, stamp) -> dict:
    """Slice 15's and 16's phases (also alone with ``--families``): the
    reduced twins card vs CPU (qwen2-vl's int8 KV engines too), then each
    family at full width (training, generation; the VLM's gate runs on a
    bf16 and an int8 pool), then each family on an int8 and an NF4 base
    (its reduced twins card vs CPU, then full width). Returns each arch's
    launches."""
    out = {}
    for arch in FAMILY_ARCHS:
        phase_family_reduced(card, arch)
    for paged in (True, False):
        phase_reduced("fp32", paged, "int8", arch="qwen2-vl-2b")
    stamp("reduced families")
    for arch in FAMILY_ARCHS:
        out[arch] = phase_family(card, arch)
        stamp(arch)
    for arch in FAMILY_ARCHS:
        for qd in PACKED:
            phase_family_reduced(card, arch, qd)
            out[arch][f"packed_{qd}"] = phase_family_packed(card, arch, qd)
        stamp(f"{arch} packed")
    return out


# --------------------------------------------------- tensor-parallel serving

# slice 17: 2 ranks, both on the one card, with a gloo device group (NCCL
# refuses two ranks on one device; gloo takes the card's tensors as they
# are); 4 of the gate prompts x 32 new tokens on the paged engine, the base
# and 2 tenants cycling
TP, TP_REQUESTS, TP_NEW, TP_TENANTS = 2, 4, 32, 2
# tp = 2's first decode logits against tp = 1's, both bf16 on the card: every
# row-parallel output (wo and wdown of each layer, 2 L sites) rounds twice
# more than at tp = 1 — each rank's partial product to bf16, then the bf16
# sum of the two partials — at most 2u of its size, u = 2^-8 (bf16's unit
# roundoff). The sites' errors are independent and add up as a random walk
# through the residual stream, so the logits' relative error ||tp2 - tp1|| /
# ||tp1|| over the compared rows is held to 2u sqrt(2 L): 0.0585 at L = 28.
# The MoE layer's partial sums (slice 18) are such a site too: 0.0442 for
# olmoe's L = 16, held over the rows whose routes agreed at every layer
BF16_U = 2.0 ** -8
# the reduced float32 twins of the CPU tests (tests/test_torch_tp_serve.py,
# test_torch_tp_moe_serve*.py, test_torch_tp_vlm.py): qwen2 with 4 kv-heads
# and 8 heads on the paged pool with 2 tenants and on the dense slot cache
# (the dense decode's wrapper), the untied head (reduced qwen3-32b) on an
# int8 base of 32-row blocks with 2 tenants (matmul_q_cols_sharded); olmoe
# (2 of its 4 experts a rank) paged with 2 tenants and on an int8 base with
# 2 tenants; qwen2-vl paged with 2 tenants; 3 prompts x 6 tokens on 2 slots
TP_TWINS = {"qwen2-paged-tenants": ("qwen2-1.5b", dict(paged=True), True),
            "qwen2-dense": ("qwen2-1.5b", dict(paged=False), False),
            "qwen3-untied-int8": ("qwen3-32b", dict(paged=True, base_dtype="int8",
                                                    quant_block=32), True),
            "olmoe-paged-tenants": ("olmoe-1b-7b", dict(paged=True), True),
            "olmoe-int8-tenants": ("olmoe-1b-7b", dict(paged=True, base_dtype="int8",
                                                       quant_block=32), True),
            "qwen2-vl-paged-tenants": ("qwen2-vl-2b", dict(paged=True), True)}
TP_TWIN_KW = dict(slots=2, max_len=64, decode_chunk=2, prefill_chunk=8)
TP_TWIN_PROMPTS = [[1, 17, 25], [1, 40, 41, 42], [3, 5]]
# the full-width runs of the path, in order: (tag, arch, base)
TP_FULL = (("bf16", "qwen2-1.5b", "bf16"), ("int8", "qwen2-1.5b", "int8"),
           ("olmoe-bf16", "olmoe-1b-7b", "bf16"), ("olmoe-int8", "olmoe-1b-7b", "int8"),
           ("vl-bf16", "qwen2-vl-2b", "bf16"))
# each model's weights seed: qwen2-vl-2b's text backbone has qwen2-1.5b's
# shapes (its vision tower is a stub), so it draws other weights
TP_SEED = {"qwen2-1.5b": 0, "olmoe-1b-7b": 0, "qwen2-vl-2b": 1}
# per-shard shapes at tp 2: (global heads, local (H, KV, hd), the untied
# packed head's (K, local N) and whose head it is). qwen2-1.5b's attention
# (qwen2-vl-2b's is the same: 12 / 2 heads of 128) with qwen3-32b's head
# (5120 -> 151,936 columns), and olmoe-1b-7b's (16 / 16 heads of 128; its
# own head, 2048 -> 50,304 columns)
TP_SHAPES = {"qwen2": ((12, 2), (6, 1, 128), (5120, 151936 // 2), "qwen3-32b"),
             "olmoe": ((16, 16), (8, 8, 128), (2048, 50304 // 2), "olmoe-1b-7b")}
# a mixed step's expert buffers on one olmoe rank at tp 2: 32 of the 64
# experts, each G·C = 320 rows (2048 tokens in 32 routing groups of 64,
# capacity 10), d 2048 -> F 1024, against the rank's (N·32, k, 1024) stacks
TP_MOE_EXPERTS = 64 // TP


def tp_kernels(gen, dev, card: str, model: str = "qwen2") -> dict:
    """The four wrappers of tensor-parallel serving, each on one rank's local
    slices at ``model``'s per-shard shapes of tp 2 (:data:`TP_SHAPES`),
    against the plain version of the kernel it launches (the fp and int8
    bodies of the three attention kernels; the packed head in int8 and
    NF4), timed beside that plain version, its bound and a one-call PyTorch
    yardstick on the same local slice (SDPA over the gathered cache;
    ``torch.mm`` on the dense local columns of the head). Returns a summary
    row a wrapper."""
    heads, (h, hkv, hd), (head_k, head_n), head_of = TP_SHAPES[model]
    num_blocks = SLOTS * (-(-MAX_LEN // PAGE))
    dec_vl = [1, 17, 300, MAX_LEN - 1, 512, 0, 640, 33]
    pre_off, pre_len = [700, 0, 256, 0, 512, 40, 0, 300], [1, 256, 188, 0, 256, 1, 40, 0]
    bf = torch.bfloat16
    tag = "tp-kernels" if model == "qwen2" else f"tp-kernels-{model}"
    out = {}

    def timed(name, call, plain, library, cost, err, shape, int8=None):
        ms = cuda_ms(call)
        b_ms, b_by = bound(*cost, bf)
        row = dict(ms=ms, plain_ms=cuda_ms(plain, iters=3), library_ms=cuda_ms(library),
                   bound_ms=b_ms, bound_by=b_by, max_abs_err=err, shape=shape)
        if int8 is not None:
            row["int8"] = int8
        out[name] = row
        log(f"[{tag}] {name} ok: max|err| {err:.3e}, {ms:.4f} ms (plain "
            f"{row['plain_ms']:.4f}, library {row['library_ms']:.4f}, bound {b_ms:.4f} by "
            f"{b_by}); {shape} [{card}]")

    # paged decode: (8, 1, h, 128) against the rank's kv-heads of every page
    q, kp, vp, table, _, vl = paged_case(gen, [0] * SLOTS, dec_vl, 1, bf, dev, num_blocks,
                                         heads=(h, hkv, hd))
    run = lambda: dec_mod.paged_decode_attention_sharded(  # noqa: E731
        q, kp, vp, table, vl, TP, heads)
    plain = lambda: dec_mod.paged_decode_attention_plain(q, kp, vp, table, vl)  # noqa: E731
    err = check_close("paged_decode_attention_sharded", run(), plain(), bf)
    kc, ks = quantized(gen, (num_blocks, PAGE, hkv, hd), dev)
    vc, vs = quantized(gen, (num_blocks, PAGE, hkv, hd), dev)
    got = dec_mod.paged_decode_attention_sharded(q, kc, vc, table, vl, TP, heads, ks, vs)
    want = dec_mod.paged_decode_attention_plain(q, kc, vc, table, vl, ks, vs)
    q_cost = int8_attention_cost(q, hkv, table, vl, float(vl.sum()), int((vl > 0).sum()), 1)
    int8 = dict(max_abs_err=check_close("paged_decode_attention_sharded int8", got, want, bf),
                ms=cuda_ms(lambda: dec_mod.paged_decode_attention_sharded(
                    q, kc, vc, table, vl, TP, heads, ks, vs)),
                bound_ms=bound(*q_cost, bf)[0])
    s = table.shape[1] * PAGE
    mask = (torch.arange(s, device=dev)[None, :] < vl[:, None])[:, None, None, :]
    timed("paged_decode_attention_sharded", run, plain, sdpa_yardstick(q, kp, vp, table, mask),
          decode_cost(q, kp, table, vl), err,
          f"q (8,1,{h},{hd}) bf16, pool ({num_blocks},16,{hkv},{hd}) one rank's kv-heads, "
          f"kv_valid_len {dec_vl}", int8)

    # paged prefill: one mixed step's chunk buffer on one rank's heads
    q, kp, vp, table, qoff, vl = paged_case(gen, pre_off, pre_len, PREFILL_CHUNK, bf, dev,
                                            num_blocks, heads=(h, hkv, hd))
    run = lambda: pre_mod.paged_prefill_attention_sharded(  # noqa: E731
        q, kp, vp, table, qoff, vl, TP, heads)
    plain = lambda: pre_mod.paged_prefill_attention_plain(q, kp, vp, table, qoff, vl)  # noqa: E731
    err = check_close("paged_prefill_attention_sharded", run(), plain(), bf)
    got = pre_mod.paged_prefill_attention_sharded(q, kc, vc, table, qoff, vl, TP, heads, ks, vs)
    want = pre_mod.paged_prefill_attention_plain(q, kc, vc, table, qoff, vl, ks, vs)
    mask = prefill_mask(qoff, vl, table, dev)
    q_cost = int8_attention_cost(q, hkv, table, vl, float(mask[:, 0].sum()),
                                 int(mask[:, 0].any(-1).sum()), 2)
    int8 = dict(max_abs_err=check_close("paged_prefill_attention_sharded int8", got, want, bf),
                ms=cuda_ms(lambda: pre_mod.paged_prefill_attention_sharded(
                    q, kc, vc, table, qoff, vl, TP, heads, ks, vs)),
                bound_ms=bound(*q_cost, bf)[0])
    timed("paged_prefill_attention_sharded", run, plain, sdpa_yardstick(q, kp, vp, table, mask),
          prefill_cost(q, kp, table, qoff, vl, mask), err,
          f"q (8,256,{h},{hd}) bf16, pool ({num_blocks},16,{hkv},{hd}), q_offset {pre_off}, "
          f"q_len {pre_len}", int8)

    # dense decode: the slot cache's local kv-heads, bf16 and int8
    q = torch.randn(SLOTS, 1, h, hd, generator=gen, device=dev).to(bf)
    k = torch.randn(SLOTS, MAX_LEN, hkv, hd, generator=gen, device=dev).to(bf)
    v = torch.randn(SLOTS, MAX_LEN, hkv, hd, generator=gen, device=dev).to(bf)
    vl = torch.tensor(dec_vl, dtype=torch.int32, device=dev)
    run = lambda: dd_mod.decode_attention_sharded(q, k, v, vl, TP, heads)  # noqa: E731
    plain = lambda: dd_mod.decode_attention_plain(q, k, v, vl)  # noqa: E731
    err = check_close("decode_attention_sharded", run(), plain(), bf)
    kc, ks = quantized(gen, (SLOTS, MAX_LEN // 16, 16, hkv, hd), dev)
    vc, vs = quantized(gen, (SLOTS, MAX_LEN // 16, 16, hkv, hd), dev)
    kc, vc = kc.reshape(SLOTS, MAX_LEN, hkv, hd), vc.reshape(SLOTS, MAX_LEN, hkv, hd)
    got = dd_mod.decode_attention_sharded(q, kc, vc, vl, TP, heads, ks, vs)
    want = dd_mod.decode_attention_plain(q, kc, vc, vl, ks, vs)
    nbytes, flops = dense_decode_cost(q, kc, vl)
    int8 = dict(max_abs_err=check_close("decode_attention_sharded int8", got, want, bf),
                ms=cuda_ms(lambda: dd_mod.decode_attention_sharded(q, kc, vc, vl, TP, heads,
                                                                   ks, vs)),
                bound_ms=bound(nbytes + 2 * ks.numel() * 4, flops, bf)[0])
    kx = k.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous()
    vx = v.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous()
    qt = q.transpose(1, 2).contiguous()
    dmask = (torch.arange(MAX_LEN, device=dev)[None, :] < vl[:, None])[:, None, None, :]
    timed("decode_attention_sharded", run, plain,
          lambda: F.scaled_dot_product_attention(qt, kx, vx, attn_mask=dmask),
          dense_decode_cost(q, k, vl), err,
          f"q (8,1,{h},{hd}) bf16, cache (8,{MAX_LEN},{hkv},{hd}) one rank's kv-heads, "
          f"kv_valid_len {dec_vl}", int8)
    del k, v, kx, vx, kc, vc

    # the untied head's local columns, int8 and NF4, at the decode rows (M = slots)
    x = torch.randn(SLOTS, head_k, generator=gen, device=dev).to(bf)
    rows = {}
    for qd in PACKED:
        w = torch.randn(head_k, head_n, generator=gen, device=dev) * head_k ** -0.5
        qt = quantize(w, qd, QUANT_BLOCK)
        del w
        run = lambda: ql_mod.matmul_q_cols_sharded(  # noqa: E731
            x, qt.data, qt.scales, qdtype=qd, block=QUANT_BLOCK)
        plain = lambda: ql_mod.fused_linear_q_plain(  # noqa: E731
            x, qt.data, qt.scales, qdtype=qd, block=QUANT_BLOCK)
        err = check_close(f"matmul_q_cols_sharded {qd}", run(), plain(), bf)
        dense = dequantize(qt).to(bf)
        ms = cuda_ms(run)
        b_ms, b_by = bound(*packed_cost(x, qt, 0, None, None), bf)
        rows[qd] = dict(ms=ms, plain_ms=cuda_ms(plain, iters=3),
                        library_ms=cuda_ms(lambda: torch.mm(x, dense)), bound_ms=b_ms,
                        bound_by=b_by, max_abs_err=err, route=ql_mod.route(
                            SLOTS, head_k, head_n, bf))
        del dense, qt
        r = rows[qd]
        log(f"[{tag}] matmul_q_cols_sharded {qd} ok: max|err| {err:.3e}, {ms:.4f} ms "
            f"(route {r['route']}; plain {r['plain_ms']:.4f}, torch.mm on the dense slice "
            f"{r['library_ms']:.4f}, bound {b_ms:.4f} by {b_by}); x ({SLOTS},{head_k}) bf16 "
            f"on ({head_k},{head_n}) local columns [{card}]")
    out["matmul_q_cols_sharded"] = dict(rows["int8"], nf4=rows["nf4"], shape=(
        f"x ({SLOTS},{head_k}) bf16 on one rank's ({head_k},{head_n}) columns of "
        f"{head_of}'s head, int8 (nf4 beside it), block {QUANT_BLOCK}"))
    return out


def tp_expert_apply(gen, dev, card: str) -> dict:
    """The bypass apply (``sparse_delta_batched``) on one olmoe rank's
    expert stacks at tp 2: a mixed step's local expert buffers (32 experts
    x 320 rows, d 2048) against the rank's ``(N·32, k, 1024)`` stacks of
    wgate, each buffer row's combined id ``tenant · 32 + (e − lo)`` (the
    range the kernel reads is held: every id below N·32, the stacks' rows),
    held against its plain version and timed beside its bound; no single
    PyTorch call computes it."""
    cfg = get_config(MOE_ARCH)
    d, f, e = cfg.d_model, cfg.d_ff, TP_MOE_EXPERTS
    m_tok = SLOTS * PREFILL_CHUNK
    g = moe_mod.num_groups(m_tok, cfg.experts_per_token)
    rows = g * moe_mod.capacity(cfg, m_tok // g)
    assert rows == 320, rows
    n_ad = (TP_TENANTS + 1) * e
    bf = torch.bfloat16
    xb = torch.randn(e * rows, d, generator=gen, device=dev).to(bf)
    bidx = torch.randint(0, d, (n_ad, K_DELTA, f), generator=gen, device=dev, dtype=torch.int32)
    bval = (torch.randn(n_ad, K_DELTA, f, generator=gen, device=dev) * 0.05).to(bf)
    bval[:e] = 0  # tenant 0 is the base
    tenant = torch.randint(0, TP_TENANTS + 1, (e, rows), generator=gen, device=dev)
    aid = (tenant * e + torch.arange(e, device=dev)[:, None]).reshape(-1).to(
        torch.int32).contiguous()
    lo_id, hi_id = int(aid.min()), int(aid.max())
    assert 0 <= lo_id and hi_id < n_ad, (lo_id, hi_id, n_ad)
    run = lambda: sd_mod.sparse_delta_batched(xb, bidx, bval, aid)  # noqa: E731
    plain = lambda: sd_mod.sparse_delta_batched_plain(xb, bidx, bval, aid)  # noqa: E731
    err = check_close("sparse_delta_batched local experts", run(), plain(), bf)
    ms = cuda_ms(run)
    b_ms, b_by = bound(*delta_cost(xb, bidx, bval, aid, f), bf)
    row = dict(ms=ms, plain_ms=cuda_ms(plain, iters=3), library_ms=None, bound_ms=b_ms,
               bound_by=b_by, max_abs_err=err, ids=[lo_id, hi_id], stacks=n_ad,
               shape=f"one olmoe rank's expert buffers ({e * rows}, {d}) -> {f} at tp 2, "
                     f"(N·{e}, k, {f}) = ({n_ad}, {K_DELTA}, {f}) stacks, combined ids "
                     f"{lo_id}..{hi_id}")
    log(f"[tp-kernels-olmoe] sparse_delta_batched on a rank's local expert stacks ok: max|err| "
        f"{err:.3e}, {ms:.4f} ms (plain {row['plain_ms']:.4f}, bound {b_ms:.4f} by {b_by}); "
        f"{row['shape']} [{card}]")
    return row


def tp_run(model, params, tenants, prompts, max_new, kw, group=None, tag="", teach=False):
    """One serving run of the [tp] phase on this process: the leader (or a
    tp = 1 engine, ``group`` None) submits the prompts, cycling over the base
    and the tenants, and runs them; a follower follows. The kernels' counts
    are set to 0 just before the run and read just after it, and no plain
    version may have run. Captures, with no fetch inside a step, the first
    decode step's logits with each slot's sequence so far (host state)
    and, on an MoE model, every forward's top-k expert choices up to that
    step, layer by layer; with tenants on an MoE model, the largest
    combined tenant id the bypass apply was handed beside the rows of the
    stacks it indexed. With ``teach`` on a rank, the first mixed step and
    the first decode step are also taught to tp 1 arithmetic
    (:func:`tp_teacher_step`): the ranks gather their caches just after
    that step, and after the run, once the counts are read, the leader runs
    the step unsharded on that state. Returns the run's readings."""
    from repro_torch.distributed.collectives import tp_all_gather

    store = AdapterStore()
    for i, (idx, val) in enumerate(tenants):
        store.register(idx, val, name=f"tenant{i + 1}")
    eng = ServeEngine(model, params, adapter_store=store, device="cuda", tp_group=group, **kw)
    first, forwards, states = {}, [], {}
    ids = {"max": None, "stacks": set()}
    real_chunk, real_decode = model.prefill_chunk, model.decode_step
    real_top_k, real_ids = moe_mod.top_k, moe_mod._dispatch_adapter_ids

    def hooked(fn, kind):
        """``fn`` with its MoE layers' choices recorded up to and including
        the first decode step, and the state after the first step of each
        kind kept for the teacher."""
        def call(params_, adapters, cache, batch):
            if first or params_ is not eng.params:
                return fn(params_, adapters, cache, batch)
            rec = {"q_len": None if kind == "decode" else batch["q_len"].clone(), "topk": [],
                   "open": True}
            forwards.append(rec)
            out = fn(params_, adapters, cache, batch)
            rec["open"] = False
            if teach and group is not None and kind not in states:
                # both ranks meet at the gather; the leader keeps the state
                full = {k: tp_all_gather(v, group, dim=v.ndim - (1 if k.endswith("_scale") else 2))
                        for k, v in cache.items()}
                states[kind] = None
                if group.leader:
                    aid = None if adapters is None else next(
                        iter(adapters["blocks"].values())).aid.clone()
                    states[kind] = dict(fn=fn, cache=full, aid=aid, chosen=rec["topk"],
                                        batch={k: v.clone() for k, v in batch.items()},
                                        logits=out.detach().float().clone())
            if kind == "decode":
                first.update(logits=out.detach().clone(), history=[
                    None if r is None else r.prompt + r.out for r in eng.scheduler.active])
            return out
        return call

    def top_k(probs, k):
        vals, idx = real_top_k(probs, k)
        if forwards and forwards[-1]["open"]:
            forwards[-1]["topk"].append(idx)
        return vals, idx

    def dispatch_ids(a, route, b, s, e):
        out = real_ids(a, route, b, s, e)
        if out is not None:
            d = next(x for x in (adapter_leaf(a, n) for n in moe_mod.EXPERT_LINEARS)
                     if isinstance(x, BatchedDelta))
            ids["stacks"].add(d.idx.shape[0] * d.idx.shape[1])
            top = out.max()
            ids["max"] = top if ids["max"] is None else torch.maximum(ids["max"], top)
        return out

    model.prefill_chunk = hooked(real_chunk, "mixed")
    model.decode_step = hooked(real_decode, "decode")
    moe_mod.top_k, moe_mod._dispatch_adapter_ids = top_k, dispatch_ids
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    try:
        if group is None or group.leader:
            for i, p in enumerate(prompts):
                eng.submit(p, max_new=max_new, adapter_id=i % (len(tenants) + 1))
            reqs = eng.run_to_completion()
            eng.close()
        else:
            reqs = None
            eng.follow()
        torch.cuda.synchronize()
    finally:
        del model.decode_step, model.prefill_chunk
        moe_mod.top_k, moe_mod._dispatch_adapter_ids = real_top_k, real_ids
    wall = time.perf_counter() - t0
    launches = {c.name: c.kernel for c in COUNTERS.values() if c.kernel}
    plain = {c.name: c.plain for c in COUNTERS.values() if c.plain}
    assert not plain, f"{tag}: a plain version ran on the card: {plain}"
    assert eng.transfers == eng.steps, (tag, eng.transfers, eng.steps)
    assert eng.kv.drained(), f"{tag}: the pool did not drain"
    teacher = {kind: tp_teacher_step(params, kw, store, st) for kind, st in states.items()
               if st is not None}
    return {"tokens": None if reqs is None else [r.out for r in reqs],
            "logits": first["logits"].float().cpu() if first else None,
            "history": first.get("history"),
            "teacher": teacher or None,
            "routes": [dict(q_len=None if f["q_len"] is None else f["q_len"].cpu(),
                            topk=sorted_choices(f["topk"]).to(torch.int8))
                       for f in forwards if f["topk"]] or None,
            "ids": (None if ids["max"] is None else [int(ids["max"]), sorted(ids["stacks"])]),
            "launches": launches,
            "steps": eng.steps, "transfers": eng.transfers, "wall_s": wall,
            "step_ms": {k: float(np.mean(v)) * 1e3 for k, v in eng.step_times.items() if v},
            "pool_bytes": eng.kv.pool_bytes(),
            "pool_bytes_per_shard": eng.kv.pool_bytes_per_shard(),
            "base_bytes": tree_bytes(eng.params), "tp": eng.tp}


def sorted_choices(choices: list) -> torch.Tensor:
    """A forward's top-k choices, one (..., K) tensor a layer, as one
    (layers, tokens, K) tensor on the host, each token's set sorted."""
    return torch.stack([c.reshape(-1, c.shape[-1]).sort(dim=-1).values for c in choices]).cpu()


def tp_teacher_step(params, kw, store, state) -> dict:
    """One step of a tp 2 run taught to tp 1 arithmetic on the very same
    state, after the run, with no serving group live: the step's forward
    (``state``: the step's function, its batch, the ranks' caches as
    gathered just after it, the tenant ids) on the unsharded base (packed
    as the engine packs it) and the whole tenant stacks. Each layer writes
    the step's k/v over what the tp 2 step wrote before it reads them, so
    the gathered cache is the state tp 1 would have started from. On an
    MoE model each layer's top-k is forced to the tp 2 step's choice:
    routing, capacity drops included, is then the same, and what is left
    between the two steps' logits is the arithmetic the ranks split and
    all-reduce. Returns both logits and, on an MoE model, the experts tp 1
    would have chosen itself beside the forced ones."""
    from repro_torch.distributed import context as tp_ctx

    assert tp_ctx.serve_group() is None, "the teacher ran under a serving group"
    dev = state["cache"]["k"].device
    base = map_leaves(lambda t: None if t is None else t.to(dev), params)
    if kw.get("base_dtype", "fp32") != "fp32":
        base = quantize_base(base, kw["base_dtype"], block=kw["quant_block"])
    full_ad, aid = None, state["aid"]
    if aid is not None:
        sidx, sval = store.stacked(dev)
        full_ad = {"blocks": {n: BatchedDelta(leaf["w"], sval["blocks"][n]["w"], aid)
                              for n, leaf in sidx["blocks"].items()
                              if isinstance(leaf, dict) and leaf.get("w") is not None},
                   "head": None}
        head = sidx.get("head")
        if isinstance(head, dict) and head.get("w") is not None:
            full_ad["head"] = BatchedDelta(head["w"], sval["head"]["w"], aid)
    forced, own, real_top_k = iter(state["chosen"]), [], moe_mod.top_k

    def top_k(probs, k):
        _, idx = real_top_k(probs, k)
        own.append(idx)
        want = next(forced)
        return torch.gather(probs, -1, want), want

    moe_mod.top_k = top_k
    try:
        logits = state["fn"](base, full_ad, state["cache"], state["batch"])
    finally:
        moe_mod.top_k = real_top_k
    out = {"logits": logits.detach().float().cpu(), "tp2": state["logits"].cpu()}
    if "q_len" in state["batch"]:
        out["q_len"] = state["batch"]["q_len"].cpu()
    if own:
        out["own"], out["forced"] = sorted_choices(own), sorted_choices(state["chosen"])
    return out


def tp_full_inputs(arch: str):
    """Full-width ``arch`` (bf16, seed :data:`TP_SEED`), its 2 tenants (seed
    7 more) and the first TP_REQUESTS gate prompts: the same on every
    process."""
    cfg = get_config(arch)
    model = get_model(cfg)
    params = model.init(seed=TP_SEED[arch], device="cuda")
    tenants = random_tenants(params, TP_TENANTS, seed=7 + TP_SEED[arch], dtype=torch.bfloat16,
                             device="cuda")
    return model, params, tenants, gate_prompts(cfg.vocab_size)[:TP_REQUESTS]


def tp_twin(arch: str):
    """A reduced float32 twin: (model, params on the CPU, seed 0, and 2
    tenants on the CPU, seed 7)."""
    cfg = reduced(get_config(arch)).replace(dtype="float32", num_kv_heads=4, num_heads=8)
    model = get_model(cfg)
    params = model.init(seed=0, device="cpu")
    return model, params, random_tenants(params, 2, seed=7, dtype=torch.float32, device="cpu")


def tp_runs(group=None) -> dict:
    """Every run of the [tp] phase's path on this process: the full-width
    runs of :data:`TP_FULL` (each model's first after a short warm-up),
    then the reduced twins, each with the kernels it launched (counted
    from 0 at its start; the twins' tenants are selected on the CPU first,
    outside the count)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    twins = {name: tp_twin(arch) for name, (arch, _, _) in TP_TWINS.items()}
    out, arch_now = {}, None
    for tag, arch, base in TP_FULL:
        if arch != arch_now:
            if arch_now is not None:
                del params, tenants
                torch.cuda.empty_cache()
            model, params, tenants, prompts = tp_full_inputs(arch)
            arch_now = arch
            tp_run(model, params, tenants, prompts[:2], 2, gate_kw(), group, f"warm-up {arch}")
        kw = gate_kw() if base == "bf16" else dict(gate_kw(), base_dtype=base,
                                                   quant_block=QUANT_BLOCK)
        out[tag] = tp_run(model, params, tenants, prompts, TP_NEW, kw, group, tag, teach=True)
    del params, tenants
    torch.cuda.empty_cache()
    for name, (_, kw, with_tenants) in TP_TWINS.items():
        model, params, tenants = twins[name]
        out[name] = tp_run(model, params, tenants if with_tenants else [], TP_TWIN_PROMPTS, 6,
                           dict(TP_TWIN_KW, **kw), group, name)
    return out


def tp_rank(rank: int, tp: int, init_method: str) -> dict:
    """One rank of the [tp] phase: joins the gloo group on the card, runs
    :func:`tp_runs`, leaves."""
    from repro_torch.distributed.collectives import close_tp, init_tp

    group = init_tp(rank, tp, "cuda:0", init_method, timeout=300)
    try:
        return dict(tp_runs(group), backend=group.describe())
    finally:
        close_tp()


def phase_tp(card: str) -> tuple[list, dict]:
    """Tensor-parallel serving (slices 17-18): the four wrappers against
    their plain versions at qwen2's and olmoe's per-shard shapes
    (:func:`tp_kernels`) and the apply on one olmoe rank's expert stacks
    (:func:`tp_expert_apply`), then the path (:func:`tp_path`). Returns the
    four kernel rows, with the wrappers' launches on the path (olmoe's
    shapes and launches in each row's ``olmoe`` entry, qwen2-vl's launches
    in its ``vl`` entry), and the apply's row."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1717)
    rows = tp_kernels(gen, dev, card)
    olmoe = tp_kernels(gen, dev, card, "olmoe")
    apply = tp_expert_apply(gen, dev, card)
    torch.cuda.empty_cache()
    launches, by_model, runs = tp_path(card)
    apply.update(launches=by_model["olmoe"].get("sparse_delta_batched", 0),
                 launches_by_model={m: n.get("sparse_delta_batched", 0)
                                    for m, n in by_model.items()})
    with open(os.path.join(OUT_DIR, "tp.json"), "w") as f:
        json.dump({"card": card, "kernels": rows, "olmoe_kernels": olmoe, "expert_apply": apply,
                   "launches": launches, "launches_by_model": by_model, "runs": runs}, f,
                  indent=1)
    sources = {"decode_attention_sharded": dd_mod, "paged_decode_attention_sharded": dec_mod,
               "paged_prefill_attention_sharded": pre_mod, "matmul_q_cols_sharded": ql_mod}
    return [dict(name=name, route="cuda", source=mod.SOURCE, replaces=mod.TP_REPLACES,
                 launches=launches[name], max_abs_err=rows[name]["max_abs_err"],
                 ms=rows[name]["ms"], kernel_ms=rows[name]["ms"],
                 plain_ms=rows[name]["plain_ms"], bound_ms=rows[name]["bound_ms"],
                 bound_by=rows[name]["bound_by"], library_ms=rows[name]["library_ms"],
                 shape=rows[name]["shape"],
                 **{k: rows[name][k] for k in ("int8", "nf4") if k in rows[name]},
                 olmoe=dict(olmoe[name], launches=by_model["olmoe"].get(name, 0)),
                 vl={"launches": by_model["vl"].get(name, 0)})
            for name, mod in sources.items()], apply


def tp_route_flips(a: dict, b: dict, same: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Of the slots ``same`` (whose sequences agree at the first decode
    step), those whose every token chose the same top-k experts at every
    layer of every forward up to and including that step in runs ``a`` and
    ``b`` (a slot's logits read its whole history), and the count of real
    (token, layer) routes whose top-k sets differ, at the mixed steps and
    at the decode step, over all slots."""
    fa, fb = a["routes"], b["routes"]
    assert [f["topk"].shape for f in fa] == [f["topk"].shape for f in fb], \
        "the runs' forwards differ"
    live = torch.tensor([h is not None for h in a["history"]])
    agree = torch.ones(len(live), dtype=torch.bool)
    flips = {"mixed": 0, "decode": 0, "routes": 0}
    for x, y in zip(fa, fb):
        n_layers, n_tok = x["topk"].shape[:2]
        bsz = len(live)
        differ = (x["topk"] != y["topk"]).any(dim=-1).reshape(n_layers, bsz, n_tok // bsz)
        if x["q_len"] is None:  # the decode step: the slots that hold a request
            real = live[:, None]
        else:  # a mixed step: each slot's chunk columns below its q_len
            real = torch.arange(n_tok // bsz)[None, :] < x["q_len"].long()[:, None]
        differ &= real[None]
        flips["mixed" if x["q_len"] is not None else "decode"] += int(differ.sum())
        flips["routes"] += int(real.sum()) * n_layers
        agree &= ~differ.any(dim=2).any(dim=0)
    return same[agree[same]], flips


def tp_taught(tag: str, cfg, b: dict, tol: float, card: str) -> None:
    """Holds the tp 2 run ``b``'s first mixed step and first decode step to
    the same steps taught to tp 1 arithmetic on its own state (the ranks'
    caches gathered, the unsharded base; on an MoE model tp 2's top-k
    choices forced) within ``tol``, over the slots the step computed for:
    the mixed step's with a chunk (``q_len`` > 0), the decode step's that
    hold a request. Logs each, with how many of its routes tp 1 left to
    itself would have chosen otherwise."""
    live_decode = torch.tensor([s for s, h in enumerate(b["history"]) if h is not None])
    b["taught"] = {}
    for kind in ("mixed", "decode"):
        t = b["teacher"][kind]
        rows = torch.nonzero(t["q_len"] > 0)[:, 0] if kind == "mixed" else live_decode
        got, want = t["tp2"][rows], t["logits"][rows]
        rel = float((got - want).norm() / want.norm())
        err = float((got - want).abs().max())
        assert rel <= tol, (tag, kind, "taught", rel, tol)
        taught = {"rel": rel, "max_abs_err": err, "slots": len(rows)}
        forced = ""
        if "own" in t:
            n_layers = t["own"].shape[0]
            own = t["own"].reshape(n_layers, len(t["tp2"]), -1, t["own"].shape[-1])
            want_k = t["forced"].reshape(own.shape)
            if kind == "mixed":
                real = torch.arange(own.shape[2])[None, :] < t["q_len"].long()[:, None]
            else:
                real = torch.zeros(own.shape[1:3], dtype=torch.bool)
                real[live_decode] = True
            taught["flips"] = int(((own != want_k).any(dim=-1) & real[None]).sum())
            taught["routes"] = int(real.sum()) * n_layers
            forced = (f" with tp 2's top-{cfg.experts_per_token} choices forced (tp 1 would have "
                      f"chosen other experts at {taught['flips']} of {taught['routes']} (token, "
                      f"layer) routes)")
        b["taught"][kind] = taught
        log(f"[tp-{tag}] the first {kind} step taught to tp 1 arithmetic on the tp 2 run's own "
            f"state (the ranks' caches gathered, the unsharded base){forced}: ||tp2 - tp1|| / "
            f"||tp1|| over its {len(rows)} slots {rel:.3e} <= {tol:.3e}, max|err| {err:.3e} "
            f"[{card}]")


# the kernels each run of the path must launch on every rank: the full-width
# runs the paged wrappers and the apply (tenants), olmoe's int8 run its
# untied packed head's columns; the twins their own wrapper
TP_MUST = {"olmoe-int8": ("matmul_q_cols_sharded",), "qwen2-dense": ("decode_attention_sharded",),
           "qwen3-untied-int8": ("matmul_q_cols_sharded",)}
TP_MUST_FULL = ("paged_decode_attention_sharded", "paged_prefill_attention_sharded",
                "sparse_delta_batched")


def tp_path(card: str) -> tuple[dict, dict, dict]:
    """The path at tp = 1 on the card (and the reduced twins on the CPU),
    then 2 spawned ranks on the card run the same path at tp = 2. Holds the
    reduced twins' greedy tokens at tp 2 to tp 1 and the CPU's, each
    full-width run's first decode logits to tp 1's within 2u sqrt(2 L) (on
    an MoE model over the slots whose top-k choices agreed at every layer;
    the flipped routes are counted), its first mixed and decode steps to
    the same steps taught to tp 1 on its own state (:func:`tp_taught`), the
    pool bytes' arithmetic and, on the MoE runs with tenants, the combined
    ids inside the rank's stacks; each run must have launched its kernels
    on every rank (:data:`TP_MUST`), and no plain version run. Returns (each
    wrapper's launches over the path's runs and both ranks, every kernel's
    launches by model over the full-width runs (qwen2 / olmoe / vl, both
    ranks), the leader's readings of each run)."""
    from repro_torch.distributed.collectives import run_ranks

    one = tp_runs()
    cpu = {}
    for name, (arch, kw, with_tenants) in TP_TWINS.items():
        model, params, tenants = tp_twin(arch)
        store = AdapterStore()
        for idx, val in (tenants if with_tenants else []):
            store.register(idx, val)
        eng = ServeEngine(model, params, adapter_store=store, device="cpu",
                          **dict(TP_TWIN_KW, **kw))
        for i, p in enumerate(TP_TWIN_PROMPTS):
            eng.submit(p, max_new=6, adapter_id=i % (store.num_adapters + 1))
        cpu[name] = [r.out for r in eng.run_to_completion()]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(tp_rank, TP, timeout=900)
    log(f"[tp] 2 ranks on {card}, {ranks[0]['backend']} / {ranks[1]['backend']}: spawned, "
        f"ran and joined in {time.perf_counter() - t0:.1f} s")
    lead = ranks[0]
    for tag, arch, base in TP_FULL:
        cfg = get_config(arch)
        a, b = one[tag], lead[tag]
        tol = 2 * BF16_U * math.sqrt(2 * cfg.num_layers)
        # the slots whose sequences so far are the same in both runs
        same = torch.tensor([s for s, (x, y) in enumerate(zip(a["history"], b["history"]))
                             if x is not None and x == y], dtype=torch.long)
        flips, what = None, "slots whose sequences agree"
        if cfg.num_experts:
            assert all(torch.equal(x["topk"], y["topk"]) for x, y in
                       zip(ranks[1][tag]["routes"], b["routes"])), f"{tag}: the ranks routed apart"
            n_same = len(same)
            same, flips = tp_route_flips(a, b, same)
            what = (f"of the {n_same} slots whose sequences agree, whose every token chose the "
                    f"same experts at all {cfg.num_layers} layers of every forward so far; "
                    f"(token, layer) routes flipped: {flips['mixed']} at the mixed steps and "
                    f"{flips['decode']} at the decode step, of {flips['routes']}")
        if len(same):
            rel = float((b["logits"][same] - a["logits"][same]).norm()
                        / a["logits"][same].norm())
            err = float((b["logits"][same] - a["logits"][same]).abs().max())
            assert rel <= tol, (tag, rel, tol, len(same), flips)
            held = (f"||tp2 - tp1|| / ||tp1|| {rel:.3e} <= 2u sqrt(2L) = {tol:.3e}, max|err| "
                    f"{err:.3e}")
        else:  # every slot's routes flipped somewhere: the taught steps below hold it
            assert cfg.num_experts, (tag, "no slot's sequence agrees")
            rel = err = None
            held = f"no slot to hold to 2u sqrt(2L) = {tol:.3e}"
        agree = [next((i for i, (x, y) in enumerate(zip(p, q)) if x != y), len(p))
                 for p, q in zip(a["tokens"], b["tokens"])]
        n_tok = sum(len(p) for p in a["tokens"])
        log(f"[tp-{tag}] {arch} full width, {base} base, tp 2 on one card: first decode logits "
            f"against tp 1 on the card over the {len(same)} {what}: {held}; greedy tokens agree "
            f"on {sum(agree)} of {n_tok} before a request's first parting ({agree} of "
            f"{[len(p) for p in a['tokens']]}) [{card}]")
        b["route_flips"], b["logits_rel"], b["compared_slots"] = flips, rel, len(same)
        tp_taught(tag, cfg, b, tol, card)
        for r, res in enumerate(ranks):
            x = res[tag]
            assert x["pool_bytes"] == a["pool_bytes"] == TP * x["pool_bytes_per_shard"], \
                (tag, r, x["pool_bytes"], a["pool_bytes"], x["pool_bytes_per_shard"])
            assert x["steps"] == b["steps"] and x["transfers"] == x["steps"], (tag, r)
            if x["ids"] is not None:  # the combined ids stay inside the rank's stacks
                top, stacks = x["ids"]
                assert len(stacks) == 1 and top < stacks[0], (tag, r, top, stacks)
        ids = ""
        if b["ids"] is not None:
            ids = (f"; the apply's combined ids at most {b['ids'][0]} < {b['ids'][1][0]} "
                   f"stack rows a rank ((tenants + 1) x {cfg.num_experts // TP} local experts)")
        experts = (f"; {cfg.num_experts // TP} of {cfg.num_experts} experts a rank"
                   if cfg.num_experts else "")
        log(f"[tp-{tag}] pool bytes: {a['pool_bytes']:,} at tp 1 and in total at tp 2, "
            f"{b['pool_bytes_per_shard']:,} a rank (= total / 2); base bytes a rank "
            f"{[res[tag]['base_bytes'] for res in ranks]} against {a['base_bytes']:,} at tp 1 "
            f"(the embedding stays whole on each rank{experts}); steps {b['steps']}, one fetch "
            f"a step on each rank{ids} [{card}]")
        log(f"[tp-{tag}] step wall of two ranks sharing one card (not a TP speed): mean "
            f"{json.dumps({k: round(v, 3) for k, v in b['step_ms'].items()})} ms against tp 1's "
            f"{json.dumps({k: round(v, 3) for k, v in a['step_ms'].items()})} ms; the run "
            f"{b['wall_s']:.3f} s against {a['wall_s']:.3f} s [{card}]")
    for name in TP_TWINS:
        got, card1 = lead[name]["tokens"], one[name]["tokens"]
        assert got == card1 == cpu[name], (name, got, card1, cpu[name])
        log(f"[tp-reduced] {name}: greedy tokens at tp 2 on the card identical to tp 1 on the "
            f"card and on the CPU ({sum(len(t) for t in got)} tokens) [{card}]")
    runs = [tag for tag, _, _ in TP_FULL] + list(TP_TWINS)
    for r, res in enumerate(ranks):
        for tag in runs:
            must = TP_MUST.get(tag, ()) + (() if tag in TP_TWINS else TP_MUST_FULL)
            for name in must:
                assert res[tag]["launches"].get(name, 0) > 0, \
                    f"rank {r}'s {tag} run at tp 2 never launched {name}"
    by_model = {}
    for tag, arch, _ in TP_FULL:
        m = {"qwen2-1.5b": "qwen2", "olmoe-1b-7b": "olmoe", "qwen2-vl-2b": "vl"}[arch]
        for res in ranks:
            for name, n in res[tag]["launches"].items():
                by_model.setdefault(m, {})[name] = by_model.get(m, {}).get(name, 0) + n
    launches = {name: sum(res[tag]["launches"].get(name, 0) for res in ranks for tag in runs)
                for name in TENSOR_PARALLEL}
    for name, n in launches.items():
        assert n > 0, f"the tensor-parallel path never launched {name}"
    log(f"[tp] wrapper launches on the tp = 2 path's runs, both ranks (each run counted from 0 "
        f"at its start, warm-ups not counted): {json.dumps(launches)}; the full-width runs' "
        f"launches by model: {json.dumps(by_model)} [{card}]")
    keep = ("logits", "history", "routes", "teacher")
    return launches, by_model, {k: {kk: vv for kk, vv in v.items() if kk not in keep}
                                for k, v in lead.items() if isinstance(v, dict)}


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
    if sys.argv[1:] == ["--reduced-train-distances"]:
        reduced_train_distances(card)
        return 0
    if sys.argv[1:] == ["--decode-row-variants"]:
        decode_row_variants(card)
        return 0
    if sys.argv[1:] == ["--linear-variants"]:
        linear_variants(card)
        return 0
    if sys.argv[1:] == ["--attention-variants"]:
        attention_variants(card)
        return 0
    if sys.argv[1:] == ["--delta-variants"]:
        delta_variants(card)
        return 0
    if sys.argv[1:] == ["--sparse-dx"]:
        secs, build_log = build.timed_build()
        log(f"[build] {len(build.SIGNATURES)} C entry points built in {secs:.1f} s")
        sparse_dx_variants(card)
        with open(os.path.join(OUT_DIR, "chip_smoke.log"), "w") as f:
            f.write("\n".join(LOG) + "\n")
        return 0
    if sys.argv[1:] == ["--lifecycle"]:
        secs, build_log = build.timed_build()
        log(f"[build] {len(build.SIGNATURES)} C entry points built in {secs:.1f} s")
        dev, gen = torch.device("cuda"), torch.Generator(device="cuda").manual_seed(1234)
        summary = {n: {} for n in ("fused_linear_q", "paged_decode_attention_q",
                                   "decode_attention_q")}
        lifecycle_kernels(gen, dev, summary, [], card, SLOTS * (-(-MAX_LEN // PAGE)),
                          [1, 17, 300, MAX_LEN - 1, 512, 0, 640, 33])
        train = {"long": phase_train(card, "bf16", batch=LONG_BATCH, seq=LONG_SEQ,
                                     steps=REMAT_STEPS),
                 "olmoe": phase_train(card, "bf16", MOE_ARCH, steps=REMAT_STEPS)}
        lifecycle(card, train, lambda name: None)
        with open(os.path.join(OUT_DIR, "chip_smoke.log"), "w") as f:
            f.write("\n".join(LOG) + "\n")
        return 0
    if sys.argv[1:] == ["--peft"]:
        secs, build_log = build.timed_build()
        log(f"[build] {len(build.SIGNATURES)} C entry points built in {secs:.1f} s")
        dev, gen = torch.device("cuda"), torch.Generator(device="cuda").manual_seed(1234)
        summary = {"topk_select": {}}
        selection_modes(gen, dev, summary, [], card)
        peft_slice(card, {"bf16": phase_train(card, "bf16")}, lambda name: None)
        with open(os.path.join(OUT_DIR, "chip_smoke.log"), "w") as f:
            f.write("\n".join(LOG) + "\n")
        return 0
    if sys.argv[1:] == ["--serve-lifecycle"]:
        secs, build_log = build.timed_build()
        log(f"[build] {len(build.SIGNATURES)} C entry points built in {secs:.1f} s")
        stamps = [("build", time.perf_counter())]
        serve_lifecycle(card, lambda name: stamps.append((name, time.perf_counter())))
        log("[timing] seconds by phase: " + ", ".join(
            f"{name} {t1 - t0:.1f}" for (_, t0), (name, t1) in zip(stamps, stamps[1:])))
        with open(os.path.join(OUT_DIR, "chip_smoke.log"), "w") as f:
            f.write("\n".join(LOG) + "\n")
        return 0
    if sys.argv[1:] == ["--families"]:
        secs, build_log = build.timed_build()
        log(f"[build] {len(build.SIGNATURES)} C entry points built in {secs:.1f} s")
        stamps = [("build", time.perf_counter())]
        stamp = lambda name: stamps.append((name, time.perf_counter()))  # noqa: E731
        summary = {}
        family_kernels(torch.Generator(device="cuda").manual_seed(1234), torch.device("cuda"),
                       summary, [], card)
        stamp("family kernels")
        families(card, summary, stamp)
        log("[timing] seconds by phase: " + ", ".join(
            f"{name} {t1 - t0:.1f}" for (_, t0), (name, t1) in zip(stamps, stamps[1:])))
        with open(os.path.join(OUT_DIR, "chip_smoke.log"), "w") as f:
            f.write("\n".join(LOG) + "\n")
        return 0
    if sys.argv[1:] == ["--tp"]:
        secs, build_log = build.timed_build()
        log(f"[build] {len(build.SIGNATURES)} C entry points built in {secs:.1f} s")
        t0 = time.perf_counter()
        rows, apply = phase_tp(card)
        log(f"[timing] seconds by phase: build {secs:.1f}, tensor-parallel "
            f"{time.perf_counter() - t0:.1f}")
        log(f"[card] {card}")
        with open(os.path.join(OUT_DIR, "chip_smoke.log"), "w") as f:
            f.write("\n".join(LOG) + "\n")
        rows.append(dict(apply, name="sparse_delta_batched", route="cuda", source=sd_mod.SOURCE,
                         replaces=sd_mod.REPLACES, kernel_ms=apply["ms"]))
        print(json.dumps({"kernels": rows}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2

    secs, build_log = build.timed_build()
    with open(os.path.join(OUT_DIR, "kernel_build.log"), "w") as f:
        f.write(build_log)
    log(f"[build] {len(build.SIGNATURES)} C entry points built in {secs:.1f} s "
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
    phase_reduced_spec()
    stamp("reduced serving")
    launches, packed_serving, gate = phase_full(card)
    stamp("full serving")
    serve_lifecycle(card, stamp, gate)
    del gate
    for base in ("bf16",) + PACKED:
        phase_reduced_train(card, base)
    phase_reduced_train(card, "bf16", flash=True)
    stamp("reduced training")
    train = {base: phase_train(card, base) for base in ("bf16",) + PACKED}
    stamp("full training")
    torch.cuda.empty_cache()
    train["long"] = phase_train(card, "bf16", batch=LONG_BATCH, seq=LONG_SEQ)
    long, fl = train["long"], summary["flash_attention_fwd"]
    n_flash = long["launches"]["flash_attention_fwd"] // TRAIN_STEPS
    log(f"[train-long] flash attention a step: forward kernel "
        f"{long['buckets'].get('flash_attention_fwd', 0.0) / 1e3:.2f} ms of device time in the "
        f"profiled step ({n_flash} launches; {fl['ms']:.4f} ms a call in the kernel phase), "
        f"plain backward ≈ {n_flash * fl['backward_plain_ms']:.2f} ms ({n_flash} x "
        f"{fl['backward_plain_ms']:.4f} ms a layer, timed in the kernel phase) [{card}]")
    stamp("long-context training")
    torch.cuda.empty_cache()
    phase_reduced_train(card, "bf16", MOE_ARCH)
    phase_reduced_train(card, "bf16", MOE_ARCH, flash=True)
    phase_reduced("fp32", arch=MOE_ARCH)
    stamp("reduced olmoe")
    train["olmoe"] = phase_train(card, "bf16", MOE_ARCH)
    stamp("olmoe training and serving")
    lifecycle(card, train, stamp)
    peft = peft_slice(card, train, stamp)
    family_kernels(torch.Generator(device="cuda").manual_seed(1234), torch.device("cuda"),
                   summary, detail, card)
    with open(os.path.join(OUT_DIR, "chip_smoke_kernels.json"), "w") as f:
        json.dump({"card": card, "rows": detail}, f, indent=1)
    stamp("family kernels")
    fams = families(card, summary, stamp)
    torch.cuda.empty_cache()
    tp_rows, tp_apply = phase_tp(card)
    stamp("tensor-parallel")
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
    # slice 13: QLoRA's measured steps (the base products at k = 0)
    by_phase.update({f"train-lora-{b}": int(peft["methods"][f"lora-{b}"]["launches_per_step"]
                                             ["fused_linear_q"] * REMAT_STEPS) for b in PACKED})
    launches["fused_linear_q"] = sum(by_phase.values())

    # this slice's path: the long-context run's measured steps (flash) and
    # its selection (one topk_select launch a stack)
    launches["flash_attention_fwd"] = long["launches"]["flash_attention_fwd"]
    launches["topk_select"] = long["select_launches"]
    select_by_phase = {("train-" + b if b != "bf16" else "train"): train[b]["select_launches"]
                       for b in train}
    # slice 13: the strategies' full-width selections and the masked run's set-up
    select_by_phase.update({f"strategy-{k}": v["launches"]
                            for k, v in peft["strategies"].items()})
    select_by_phase["method-masked"] = peft["methods"]["masked-bf16"]["select_launches"]
    olmoe_launches = {**train["olmoe"]["serve_launches"], **train["olmoe"]["launches"],
                      "topk_select": train["olmoe"]["select_launches"]}
    # slice 12's olmoe paths: the packed bases' training steps and gate runs,
    # the int8 KV gate runs
    olmoe_q = {f"{p}-olmoe-{qd}": train[f"olmoe-{qd}"][k]["fused_linear_q"]
               for qd in PACKED for p, k in (("train", "launches"), ("serve", "serve_launches"))}
    kv = train["olmoe"]["serve_launches"]
    olmoe_launches.update({
        "fused_linear_q": sum(olmoe_q.values()),
        "paged_decode_attention_q": kv["paged_decode_attention_q (paged-int8)"],
        "paged_prefill_attention_q": kv["paged_prefill_attention_q (paged-int8)"],
        "decode_attention_q": kv["decode_attention_q (dense-int8)"]})
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
        if name == "fused_linear":
            row.update({key: s[key] for key in ("launch_route", "k0_ms", "old_ms", "encode_us")})
        if name == "flash_attention_fwd":
            row.update({key: s[key] for key in ("backward_plain_ms", "launch_route", "mma_ms")})
        if name in DECODE_NAMES:
            row["launch_route"] = dec_mod.ROUTE
        if name == "sparse_delta_batched":
            # the gate run's launches by route: rows at the decode steps (M =
            # slots), tiles at the mixed steps, both with the serving epilogue
            row.update({key: s[key] for key in ("fused", "decode", "decode_fused")},
                       launches_by_route=launches["apply_by_route"])
            # slice 18: one olmoe rank's local expert stacks at tp 2, and the
            # launches on the tensor-parallel path by model (both ranks)
            row["tp"] = tp_apply
        if name == "sparse_delta_dval":
            row.update(m4096=s["m4096"], launch_route=sd_mod.DVAL_ROUTE)
        if name == "topk_select":
            # the smallest-first mode (reverse) and float32 scores (gradient, random)
            row.update(launches_by_phase=select_by_phase, smallest_first=s["smallest_first"],
                       f32_scores=s["f32_scores"])
        if "spec" in s:
            # the speculative round's shapes (kernel phase) and the full-width
            # spec gate runs' launches by drafter
            row["spec"] = dict(s["spec"], launches_by_drafter={
                d: n[name] for d, n in launches["spec"].items() if n.get(name)})
        phases = (("train", "train_launches"), ("generate", "gen_launches"),
                  ("serve", "serve_launches"), ("serve-int8-kv", "kv_launches"))
        fam_launches = {arch: {phase: f[key][name] for phase, key in phases
                               if f.get(key, {}).get(name)} for arch, f in fams.items()}
        for arch, f in fams.items():
            if name == "topk_select":
                fam_launches[arch]["select"] = f["select_launches"]
            # slice 16: the packed bases' measured steps, generation and selection
            for qd in PACKED:
                p = f[f"packed_{qd}"]
                for phase in ("train", "gen"):
                    if p[f"{phase}_launches"].get(name):
                        fam_launches[arch][f"{phase}-{qd}"] = p[f"{phase}_launches"][name]
                if name == "topk_select":
                    fam_launches[arch][f"select-{qd}"] = p["select_launches"]
        fam_launches = {arch: n for arch, n in fam_launches.items() if n}
        if "families" in s or fam_launches:
            # slice 15: the new shapes' times and bounds (kernel phase) and the
            # launches on each family's paths (measured training steps,
            # selection, generation, the VLM's gate run)
            row["families"] = {"shapes": s.get("families", {}), "launches": fam_launches}
        if "olmoe" in s:
            # olmoe's own shapes and launches: the training run's measured
            # steps for the training kernels (its seq 512 runs no flash), its
            # selection for topk_select, its serving gate run for the rest
            row.update(olmoe=dict(s["olmoe"], launches=olmoe_launches.get(name, 0)))
            if name == "fused_linear_q":
                row["olmoe"]["launches_by_phase"] = olmoe_q
        kernels.append(row)
    kernels.extend(tp_rows)
    log(f"[card] {card}")
    with open(os.path.join(OUT_DIR, "chip_smoke.log"), "w") as f:
        f.write("\n".join(LOG) + "\n")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
