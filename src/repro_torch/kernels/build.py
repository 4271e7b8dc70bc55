"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/*.cu`` compiles in its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects link into one shared library with a
plain C interface, loaded with ``ctypes``. Every C entry point returns the
``cudaError_t`` of its launch, and the wrappers raise when it is not 0.

The library lands in ``kernels/_build/<hash>/`` inside the package (the
directory is listed in ``.gitignore``), keyed on a hash of the sources and
the flags: an edited source rebuilds, an unchanged one just loads. Nothing
here runs at import time — this machine may have no ``nvcc`` at all, and
then only :func:`library` raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
LIB_NAME = "librepro_torch_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", *ARCH_FLAGS)

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes; every function returns an int cudaError_t
SIGNATURES = {
    # x, idx, val, aid, y | M, d_in, d_out, n_ad, k, x_dtype, v_dtype | stream
    "rt_sparse_delta_batched": [_P] * 5 + [_I] * 7 + [_P],
    # q, k_pool, v_pool, table, kv_valid_len, out, partials | B, n_blocks, page, hkv,
    # hd, g, n_pages, pages_per_split, n_split, dtype | stream
    "rt_paged_decode_attention": [_P] * 7 + [_I] * 10 + [_P],
    # q, k_pool, v_pool, k_scale, v_scale, table, kv_valid_len, out, partials |
    # the same ints | stream (int8 pools, float32 scales)
    "rt_paged_decode_attention_q": [_P] * 9 + [_I] * 10 + [_P],
    # q, k_pool, v_pool, table, q_offset, kv_valid_len, out | B, C, n_blocks, page,
    # hkv, hd, g, n_pages, dtype | stream
    "rt_paged_prefill_attention": [_P] * 7 + [_I] * 9 + [_P],
    # q, k_pool, v_pool, k_scale, v_scale, table, q_offset, kv_valid_len, out |
    # the same ints | stream (int8 pools, float32 scales)
    "rt_paged_prefill_attention_q": [_P] * 9 + [_I] * 9 + [_P],
    # q, k, v, kv_valid_len, out, partials | B, smax, tile, hkv, hd, g,
    # tiles_per_split, n_split, dtype | stream
    "rt_decode_attention": [_P] * 6 + [_I] * 9 + [_P],
    # q, k, v, k_scale, v_scale, kv_valid_len, out, partials | the same ints |
    # stream (int8 cache, float32 scales)
    "rt_decode_attention_q": [_P] * 8 + [_I] * 9 + [_P],
    # x, w, idx, val, bias (may be null), y | M, N, K, k, x_dtype, v_dtype | stream
    "rt_fused_linear": [_P] * 6 + [_I] * 6 + [_P],
    # x, idx, val, y | B, M, d_in, d_out, k, x_dtype, v_dtype | stream
    "rt_sparse_delta": [_P] * 4 + [_I] * 7 + [_P],
    # x, idx, dy, partials, dval | B, M, d_in, d_out, k, rows_per_split, n_split,
    # dtype | stream
    "rt_sparse_delta_dval": [_P] * 5 + [_I] * 8 + [_P],
    # x, data, scales, idx, val, bias (idx/val/bias may be null), y | M, N, K, k,
    # block, qdtype, x_dtype, v_dtype | stream
    "rt_fused_linear_q": [_P] * 7 + [_I] * 8 + [_P],
}


def source_hash() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found: the port's kernels build on a machine with the "
            "CUDA toolkit (looked on PATH and in /usr/local/cuda/bin)"
        )
    return found


def build() -> Path:
    """Compile (if needed) and return the path of the shared library.

    ``-Xptxas=-v`` reports each kernel's registers, shared memory and
    spills; the whole compiler output is kept in ``build.log`` beside the
    library.
    """
    out_dir = BUILD_DIR / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        sources = sorted(CSRC.glob("*.cu"))
        objs = [tmp / (s.stem + ".o") for s in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-Xptxas=-v", "-c", str(s), "-o", str(o)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for s, o in zip(sources, objs)
        ]
        logs, failed = [], []
        for s, p in zip(sources, procs):
            out, _ = p.communicate()
            logs.append(f"== {s.name}\n{out}")
            if p.returncode:
                failed.append(s.name)
        if not failed:
            link = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp / LIB_NAME),
                 *map(str, objs)],
                capture_output=True, text=True,
            )
            logs.append(f"== link\n{link.stdout}{link.stderr}")
            if link.returncode:
                failed.append("link")
        (out_dir / "build.log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError(
                f"kernel build failed at {failed}:\n" + "\n".join(logs)
            )
        os.replace(tmp / LIB_NAME, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), argtypes set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def timed_build() -> tuple[float, str]:
    """Build (or load) the library; returns (seconds, build log text)."""
    t0 = time.perf_counter()
    library()
    log = BUILD_DIR / source_hash() / "build.log"
    return time.perf_counter() - t0, log.read_text() if log.exists() else ""


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {rc}")
