"""The port's packed (int8 / NF4) frozen base against the JAX reference, on
the CPU.

Packing is byte-identical to ``repro.quant.quantize`` (ragged ``d_in``,
all-zero blocks, blocks 2/32/64/128, float32 and bf16 inputs) and so is the
base policy of ``quantize_base`` (embeddings stay dense); magnitude
selection on a packed base picks the reference's indices; three training
steps on an int8 and on an NF4 base match the reference's
``make_train_step`` (loss, grad norm and values; fp32, the tolerances of
``test_torch_train.py``) and never change a byte of the base; packed
checkpoints cross between the packages both ways byte for byte; the layer
loop slices a packed stack per layer; the launchers take ``--base-dtype``
and ``--quant-block``. Greedy serving on a packed base is held against the
reference engine in ``test_torch_quant_serve.py``, the plain
``fused_linear_q`` and its gradient in ``test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import load_pytree as j_load_pytree
from repro.checkpoint.manager import save_pytree as j_save_pytree
from repro.configs import PeftConfig as JPeftConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config, reduced
from repro.data.synthetic import TASKS as J_TASKS
from repro.models import get_model as j_get_model
from repro.peft import get_peft as j_get_peft
from repro.peft import quantize_base as j_quantize_base
from repro.quant import QuantizedTensor as JQT
from repro.quant import quantize as j_quantize
from repro.quant import tree_bytes as j_tree_bytes
from repro.train import TrainState as JState
from repro.train import make_train_step as j_make_train_step
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.configs import PeftConfig, TrainConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import to_tensor, tree_to_numpy, tree_to_torch
from repro_torch.core.adapt import merge_adapters
from repro_torch.kernels import COUNTERS, reset_counters
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import get_model
from repro_torch.models.transformer import layer_views
from repro_torch.peft import get_peft, quantize_base, stats
from repro_torch.quant import QuantizedTensor, dequantize, quantize, tree_bytes
from repro_torch.train import Trainer, TrainState, make_train_step
from repro_torch.tree import flatten

torch.set_num_threads(2)
IS_LEAF = lambda x: x is None or isinstance(x, JQT)  # noqa: E731


def np_tree(tree):
    """Reference tree -> numpy leaves; packed leaves keep their class."""
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree,
                        is_leaf=lambda x: x is None)


def packed_leaves(tree, cls):
    return [(p, x) for p, x in flatten(tree) if isinstance(x, cls)]


@pytest.fixture(scope="module")
def world():
    cfg = reduced(get_config("qwen2-1.5b")).replace(dtype="float32")
    jm = j_get_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = get_model(t_reduced(t_get_config("qwen2-1.5b")).replace(dtype="float32"))
    tp = tree_to_torch(np_tree(jp))
    return {"cfg": cfg, "jm": jm, "jp": jp, "tm": tm, "tp": tp}


# ---------------------------------------------------------------- (a) packing


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("block", [2, 32, 64, 128])
@pytest.mark.parametrize("qdtype", ["int8", "nf4"])
def test_packing_is_byte_identical_to_reference(qdtype, block, dtype):
    rng = np.random.default_rng(block)
    d_in = 71 if qdtype == "int8" else 70  # ragged against every block but 2
    w = rng.normal(size=(2, d_in, 24)).astype(np.float32)
    w[0, :block, :5] = 0.0  # all-zero blocks: the safe scale is 1
    jw = jnp.asarray(w, dtype)
    want = j_quantize(jw, qdtype, block)
    got = quantize(to_tensor(np.asarray(jw)), qdtype, block)
    assert got.data.numpy().dtype == np.asarray(want.data).dtype
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    assert (got.qdtype, got.block, got.dtype_name) == (want.qdtype, want.block,
                                                         want.dtype_name)
    assert got.shape == tuple(want.shape) and got.nbytes == want.nbytes
    from repro.quant import dequantize as j_dequantize
    np.testing.assert_array_equal(dequantize(got).float().numpy(),
                                  np.asarray(j_dequantize(want), np.float32))


def test_quantize_rejects_what_the_reference_rejects():
    w = torch.zeros(7, 4)
    with pytest.raises(ValueError, match="even d_in"):
        quantize(w, "nf4", 2)
    for block in (0, 3):
        with pytest.raises(ValueError, match="block"):
            quantize(w, "int8", block)
    with pytest.raises(ValueError, match="qdtype"):
        quantize(w, "int4")


@pytest.mark.parametrize("qdtype", ["int8", "nf4"])
def test_quantize_base_policy_and_bytes_match_reference(world, qdtype):
    jq = j_quantize_base(world["jp"], qdtype, block=32)
    tq = quantize_base(world["tp"], qdtype, block=32)
    want = {"/".join(str(getattr(k, "key", k)) for k in p): x
            for p, x in jax.tree_util.tree_flatten_with_path(jq, is_leaf=IS_LEAF)[0]
            if isinstance(x, JQT)}
    got = {"/".join(p): x for p, x in packed_leaves(tq, QuantizedTensor)}
    assert set(got) == set(want) and len(got) == 7
    assert not any("embed" in k for k in got)
    for key, x in got.items():
        np.testing.assert_array_equal(x.data.numpy(), np.asarray(want[key].data))
        np.testing.assert_array_equal(x.scales.numpy(), np.asarray(want[key].scales))
    assert tree_bytes(tq) == j_tree_bytes(jq) < tree_bytes(world["tp"])
    assert quantize_base(world["tp"], "fp32") is world["tp"]
    assert stats(tq, {})["base_bytes"] == tree_bytes(tq)
    assert stats(tq, {})["total"] == stats(world["tp"], {})["total"]


# -------------------------------------------------------- (c) training


@pytest.mark.parametrize("qdtype", ["int8", "nf4"])
def test_selection_and_three_train_steps_match_reference(world, qdtype):
    """Magnitude indices on the packed base equal the reference's; loss,
    grad norm and values after each of three steps match the reference's
    jitted step on its jnp backend (fp32; tolerances as in
    ``test_torch_train.py``); the packed base never changes a byte."""
    cfg = world["cfg"]
    jq = j_quantize_base(world["jp"], qdtype)
    tq = quantize_base(world["tp"], qdtype)
    before = [(x.data.clone(), x.scales.clone()) for _, x in packed_leaves(tq, QuantizedTensor)]
    jpeft = j_get_peft(JPeftConfig(k=1, delta_dtype="float32"))
    jstep, jopt = j_make_train_step(world["jm"], jpeft, JTrainConfig(steps=3))
    jstep = jax.jit(jstep)
    jvals, jidx = jpeft.init(jq, jax.random.PRNGKey(0))
    jstate = JState(jvals, jopt.init(jvals), jnp.zeros((), jnp.int32))

    peft = get_peft(PeftConfig(k=1, delta_dtype="float32"))
    tc = TrainConfig(steps=3)
    step, opt = make_train_step(world["tm"], peft, tc)
    vals, idx = peft.init(tq)
    n = 0
    for (p, a), (_, b) in zip(flatten(idx), flatten(tree_to_torch(np_tree(jidx)))):
        assert (a is None) == (b is None), p
        if a is not None:
            assert torch.equal(a, b), p
            n += 1
    assert n == 7
    state = TrainState(vals, opt.init(vals), torch.zeros((), dtype=torch.int32))
    reset_counters()
    for i in range(3):
        batch = J_TASKS["reasoning"](cfg.vocab_size, 4, 16, 0, i)
        jstate, jm = jstep(jq, jidx, jstate, {k: jnp.asarray(x) for k, x in batch.items()})
        state, m = step(tq, idx, state, {k: torch.from_numpy(x) for k, x in batch.items()})
        for key in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i} {key}")
        want = dict(flatten(np_tree(jstate.trainable)))
        for path, v in flatten(state.trainable):
            if v is not None:
                np.testing.assert_allclose(v.numpy(), want[path], rtol=1e-5,
                                           atol=1e-4 * tc.learning_rate,
                                           err_msg=f"step {i} {path}")
    # every projection of every layer through the packed kernel's plain
    # version (CPU tensors), forward and dval; the dense kernel never
    layers = cfg.num_layers
    assert COUNTERS["fused_linear_q"].plain == 3 * 7 * layers
    assert COUNTERS["sparse_delta_dval"].plain == 3 * 7 * layers
    assert COUNTERS["fused_linear"].plain == 0
    for (d0, s0), (_, x) in zip(before, packed_leaves(tq, QuantizedTensor)):
        assert torch.equal(d0, x.data) and torch.equal(s0, x.scales)


def test_trainer_on_a_packed_base_merges_dense(world):
    tq = quantize_base(world["tp"], "nf4")
    trainer = Trainer(world["tm"], get_peft(PeftConfig(k=1, delta_dtype="float32")),
                      TrainConfig(steps=2, learning_rate=1e-2), tq)
    trainer.run(iter([J_TASKS["lm"](world["cfg"].vocab_size, 2, 8, 0, i) for i in range(2)]))
    merged = trainer.merged_params()
    assert not packed_leaves(merged, QuantizedTensor)
    want = merge_adapters({"w": dequantize(tq["blocks"]["wq"]["w"])},
                          {"w": trainer.aux["blocks"]["wq"]["w"]},
                          {"w": trainer.state.trainable["blocks"]["wq"]["w"]})["w"]
    assert torch.equal(merged["blocks"]["wq"]["w"], want)
    assert float(trainer.state.trainable["blocks"]["wq"]["w"].abs().max()) > 0


# ------------------------------------------------------- (e) checkpoints


def test_packed_checkpoints_cross_packages_byte_exact(world, tmp_path):
    jq = j_quantize_base(world["jp"], "nf4", block=32)
    jq["blocks"]["wq"]["w"] = j_quantize(world["jp"]["blocks"]["wq"]["w"].astype(jnp.bfloat16),
                                         "int8", 64)
    j_save_pytree(str(tmp_path / "j.npz"), jq)
    got = load_pytree(str(tmp_path / "j.npz"))
    want = {"/".join(str(getattr(k, "key", k)) for k in p): x
            for p, x in jax.tree_util.tree_flatten_with_path(jq, is_leaf=IS_LEAF)[0]}
    n = 0
    for path, x in flatten(got):
        w = want["/".join(path)]
        if isinstance(w, JQT):
            assert isinstance(x, QuantizedTensor)
            assert (x.qdtype, x.block, x.dtype_name) == (w.qdtype, w.block, w.dtype_name)
            assert x.data.numpy().tobytes() == np.asarray(w.data).tobytes()
            assert x.scales.numpy().tobytes() == np.asarray(w.scales).tobytes()
            n += 1
    assert n == 7
    # and back: the port's save loads in the reference, packed bytes equal
    save_pytree(str(tmp_path / "t.npz"), got)
    back = j_load_pytree(str(tmp_path / "t.npz"))
    for path, x in flatten(got):
        node = back
        for key in path:
            node = node[key]
        if isinstance(x, QuantizedTensor):
            assert isinstance(node, JQT) and node.dtype_name == x.dtype_name
            assert np.asarray(node.data).tobytes() == x.data.numpy().tobytes()
            assert np.asarray(node.scales).tobytes() == x.scales.numpy().tobytes()
    # the converter keeps every byte too, both ways
    conv = tree_to_numpy(tree_to_torch(np_tree(jq)))
    wq = JQT(*conv["blocks"]["wq"]["w"])  # the same fields in the same order
    assert isinstance(wq, JQT) and wq.dtype_name == "bfloat16" and wq.data.dtype == np.int8
    assert wq.data.tobytes() == np.asarray(jq["blocks"]["wq"]["w"].data).tobytes()


# ------------------------------------------------------------ (f) layers


def test_layer_views_slice_a_packed_stack_per_layer(world):
    tq = quantize_base(world["tp"], "int8")
    stack = tq["blocks"]["wq"]["w"]
    assert not isinstance(stack, tuple)  # a tuple's [i] would return data itself
    views = layer_views(tq)
    assert len(views) == world["cfg"].num_layers
    for i, layer in enumerate(views):
        w = layer["wq"]["w"]
        assert isinstance(w, QuantizedTensor) and w.shape == stack.shape[1:]
        assert torch.equal(w.data, stack.data[i]) and torch.equal(w.scales, stack.scales[i])
    with pytest.raises(IndexError):
        views[0]["wq"]["w"][0]  # a per-layer matrix has no layer axis left


# ------------------------------------------------------------ (h) launchers


def test_launchers_take_a_packed_base_and_reject_a_bad_block(tmp_path, caplog, capsys):
    out = tmp_path / "a.npz"
    with caplog.at_level("INFO"):
        hist = launch_train.main(["--reduced", "--device", "cpu", "--steps", "2", "--batch",
                                  "2", "--seq", "8", "--base-dtype", "nf4", "--quant-block",
                                  "32", "--export-adapter", str(out)])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert "base quantized to nf4" in caplog.text
    launch_serve.main(["--reduced", "--device", "cpu", "--base-dtype", "int8",
                       "--quant-block", "32", "--max-new", "3", "--adapters", str(out)])
    text = capsys.readouterr().out
    assert "base quantized to int8" in text and "tenant1" in text
    for launcher in (launch_train, launch_serve):
        with pytest.raises(SystemExit, match="quant-block"):
            launcher.main(["--reduced", "--device", "cpu", "--base-dtype", "int8",
                           "--quant-block", "5"])
