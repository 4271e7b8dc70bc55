"""The port's tensor-parallel layout against the reference's sharding rules.

Each param leaf's split dimension (``split_dim``) equals the position of
``model`` in ``repro.distributed.sharding.spec_for_param`` for every
architecture's reduced params (every family) at tp 2 and 4, through a
stand-in mesh with ``axis_names`` and ``shape`` (as
``tests/serve/test_sharded.py`` builds one); the same for a delta's split
(``delta_split_dim`` against ``delta_spec_from``, training deltas and
serving stacks) and the cache leaves (``kv_axis_spec``,
``kv_scale_spec``). ``shard_params`` cuts slices that concatenate back to
the whole, plain and packed (int8 / NF4), with the embedding kept whole; a
row-parallel split that cuts a scale block or an NF4 byte pair raises.
``shard_adapters``: column-parallel stacks slice with their host, and the
ranks' masked row-parallel bypasses sum to the whole bypass.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config, reduced
from repro.core.adapt import path_str as j_path_str
from repro.distributed import sharding as jsh
from repro.models import get_model as j_get_model
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import ref
from repro_torch.models import get_model
from repro_torch.peft import quantize_base
from repro_torch.quant import QuantizedTensor, dequantize, quantize
from repro_torch.tree import flatten, path_str

torch.set_num_threads(2)


class StandInMesh:
    axis_names = ("model",)

    def __init__(self, tp):
        self.shape = {"model": tp}


def model_dim(spec) -> int | None:
    dims = [i for i, e in enumerate(tuple(spec)) if e == "model"]
    assert len(dims) <= 1, spec
    return dims[0] if dims else None


@pytest.fixture(scope="module")
def param_shapes():
    """{arch: (family, [(path, shape)])} of every architecture's reduced
    params, from the reference's init traced abstractly."""
    out = {}
    for arch in ARCH_IDS:
        cfg = reduced(get_config(arch))
        m = j_get_model(cfg)
        tree = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0)))
        leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: x is None)[0]
        out[arch] = (cfg.family, [(j_path_str(p), tuple(x.shape)) for p, x in leaves
                                  if x is not None])
    return out


@pytest.mark.parametrize("tp", [2, 4])
def test_split_dims_match_spec_for_param(param_shapes, tp):
    mesh = StandInMesh(tp)
    seen = 0
    for arch, (family, leaves) in param_shapes.items():
        for name, shape in leaves:
            want = model_dim(jsh.spec_for_param(name, shape, mesh, family, fsdp=False))
            assert sh.split_dim(name, shape, family, tp) == want, (arch, name, shape)
            seen += want is not None
    assert seen > 50  # the rules fire, not only the replicated fall-back


@pytest.mark.parametrize("tp", [2, 4])
def test_delta_and_cache_split_dims_match_reference(param_shapes, tp):
    mesh = StandInMesh(tp)
    for arch, (family, leaves) in param_shapes.items():
        for name, shape in leaves:
            if len(shape) < 2 or not name.endswith("/w"):
                continue
            wspec = jsh.spec_for_param(name, shape, mesh, family, fsdp=False)
            host = sh.split_dim(name, shape, family, tp)
            train = (*shape[:-2], 3, shape[-1])  # a training delta (…, k, d_out)
            stack = (*shape[:1], 5, *shape[1:-2], 3, shape[-1]) if len(shape) > 2 \
                else (5, 3, shape[-1])  # a serving stack: the tenant axis after L
            for dshape in (train, stack):
                want = model_dim(jsh.delta_spec_from(wspec, dshape))
                got = sh.delta_split_dim(host, len(shape), len(dshape))
                assert got == want, (arch, name, shape, dshape)
    for shape in ((2, 9, 16, 4, 8), (2, 9, 16, 3, 8), (2, 5, 64, 8, 16)):
        assert sh.kv_split_dim(shape, tp) == model_dim(jsh.kv_axis_spec(shape, mesh))
        scale = shape[:3] + shape[3:4]
        assert sh.kv_scale_split_dim(scale, tp) == model_dim(jsh.kv_scale_spec(scale, mesh))


def world(base: str, block: int = 16):
    cfg = t_reduced(t_get_config("qwen2-1.5b")).replace(dtype="float32", num_kv_heads=4,
                                                         num_heads=8)
    params = get_model(cfg).init(seed=0, device="cpu")
    return cfg, quantize_base(params, base, block=block)


def logical(x):
    return dequantize(x) if isinstance(x, QuantizedTensor) else x


@pytest.mark.parametrize("base", ["fp32", "int8", "nf4"])
@pytest.mark.parametrize("tp", [2, 4])
def test_shards_concatenate_to_the_whole(base, tp):
    cfg, params = world(base)
    shards = [dict(flatten(sh.shard_params(params, cfg.family, r, tp))) for r in range(tp)]
    n_split = 0
    for path, x in flatten(params):
        if x is None:
            continue
        name = path_str(path)
        dim = None if name == "embed/w" else sh.split_dim(name, tuple(x.shape), cfg.family, tp)
        parts = [s[path] for s in shards]
        if dim is None:
            for p in parts:
                torch.testing.assert_close(logical(p), logical(x), rtol=0, atol=0)
            continue
        n_split += 1
        assert all(p.shape[dim] * tp == x.shape[dim] for p in parts), name
        if isinstance(x, QuantizedTensor):
            data = torch.cat([p.data for p in parts], dim)
            scales = torch.cat([p.scales for p in parts], dim)
            assert torch.equal(data, x.data) and torch.equal(scales, x.scales), name
        else:
            assert torch.equal(torch.cat(parts, dim), x), name
    assert n_split == 7 + 3  # wq wk wv wo wgate wup wdown, and the q/k/v biases


@pytest.mark.parametrize("qdtype,block,tp,msg", [("int8", 64, 4, "cuts a scale block"),
                                                 ("nf4", 64, 4, "cuts a scale block"),
                                                 ("nf4", 2, 2, "cuts an NF4 byte pair")])
def test_row_split_that_cuts_a_block_is_refused(qdtype, block, tp, msg):
    if block == 2:  # a d_in of 6 rows: 3 a rank, an odd count of NF4 rows
        w = torch.randn(2, 6, 8)
        params = {"blocks": {"wo": {"w": quantize(w, qdtype, block)}}}
    else:  # wo's d_in of 128 over 4 ranks: 32 rows, half a 64-row block
        _, params = world(qdtype, block)
    with pytest.raises(ValueError, match=msg):
        sh.shard_params(params, "dense", 0, tp)


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_adapters_slice_columns_and_mask_rows(tp):
    cfg, params = world("fp32")
    shapes = sh.param_shapes(params)
    rng = np.random.default_rng(0)
    L, N, k = cfg.num_layers, 3, 2
    idx, val = {"blocks": {}}, {"blocks": {}}
    for name in ("wq", "wo", "wdown"):
        d_in, d_out = shapes[f"blocks/{name}/w"][-2:]
        idx["blocks"][name] = {"w": torch.from_numpy(
            rng.integers(0, d_in, (L, N, k, d_out)).astype(np.int32))}
        val["blocks"][name] = {"w": torch.from_numpy(
            rng.standard_normal((L, N, k, d_out)).astype(np.float32))}
    parts = [sh.shard_adapters(idx, val, shapes, cfg.family, r, tp) for r in range(tp)]
    # column-parallel wq: sliced along d_out with its host, indices unchanged
    assert torch.equal(torch.cat([p[0]["blocks"]["wq"]["w"] for p in parts], -1),
                       idx["blocks"]["wq"]["w"])
    for name in ("wo", "wdown"):  # row-parallel: the ranks' partial bypasses sum to the whole
        d_in = shapes[f"blocks/{name}/w"][-2]
        i, v = idx["blocks"][name]["w"][0, 1], val["blocks"][name]["w"][0, 1]
        x = torch.from_numpy(rng.standard_normal((5, d_in)).astype(np.float32))
        want = ref.sparse_delta_ref(x[None], i[None], v[None])
        got = 0
        for r, (pi, pv) in enumerate(parts):
            li, lv = pi["blocks"][name]["w"][0, 1], pv["blocks"][name]["w"][0, 1]
            lo, hi = sh.local_range(d_in, r, tp)
            assert li.shape == i.shape and int(li.max()) < hi - lo
            got = got + ref.sparse_delta_ref(x[None, :, lo:hi], li[None], lv[None])
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
