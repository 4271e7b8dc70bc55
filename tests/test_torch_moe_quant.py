"""olmoe on a packed (int8 / NF4) frozen base in the port against the JAX
reference, on the CPU.

Reduced olmoe-1b-7b in fp32 (2 layers, 4 experts top-2, untied head), the
reference's params packed by both packages: ``quantize_base`` packs the
(L, E, d_in, d_out) expert stacks, the attention projections and the head
byte for byte as the reference does, and leaves the router, embeddings and
norms dense; selection picks the reference's indices one expert matrix at
a time; forward logits, the loss and the value gradients match the
reference's jnp path; three AdamW steps match ``make_train_step``; the
packed expert product (``ops.bmm_q``) keeps no dense stack and gives the
codes no gradient; packed MoE trees cross the packages through
``convert`` and npz files. Greedy serving on a packed olmoe base is in
``test_torch_moe_quant_serve.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import save_pytree as j_save_pytree
from repro.configs import PeftConfig as JPeftConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config, reduced
from repro.core.adapt import init_adapters as j_init_adapters
from repro.core.adapt import zip_adapters as j_zip
from repro.data import peek_batch as j_peek
from repro.data.synthetic import TASKS as J_TASKS
from repro.models import get_model as j_get_model
from repro.models.transformer import forward_train as j_forward_train
from repro.peft import get_peft as j_get_peft
from repro.peft import quantize_base as j_quantize_base
from repro.quant import QuantizedTensor as JQT
from repro.train import TrainState as JState
from repro.train import make_train_step as j_make_train_step
from repro_torch.checkpoint import load_pytree
from repro_torch.configs import PeftConfig, TrainConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import tree_to_numpy, tree_to_torch
from repro_torch.core.adapt import init_adapters, zip_adapters
from repro_torch.kernels import COUNTERS, ops, reset_counters
from repro_torch.models import get_model
from repro_torch.peft import get_peft, quantize_base
from repro_torch.quant import QuantizedTensor, dequantize
from repro_torch.train import TrainState, make_train_step
from repro_torch.tree import flatten, map_leaves

torch.set_num_threads(2)
NONE = lambda x: x is None  # noqa: E731
IS_LEAF = lambda x: x is None or isinstance(x, JQT)  # noqa: E731
BLOCK = 32
PACKED_NAMES = ("blocks/wq/w", "blocks/wk/w", "blocks/wv/w", "blocks/wo/w", "blocks/wgate/w",
                "blocks/wup/w", "blocks/wdown/w", "head/w")


def np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree, is_leaf=NONE)


def j_packed_np(tree):
    """Reference tree -> numpy leaves, packed leaves kept as the class."""
    return jax.tree.map(lambda x: x if x is None or isinstance(x, JQT) else np.asarray(x), tree,
                        is_leaf=IS_LEAF)


@pytest.fixture(scope="module")
def world():
    cfg = reduced(get_config("olmoe-1b-7b")).replace(dtype="float32", num_layers=2)
    jm = j_get_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = get_model(t_reduced(t_get_config("olmoe-1b-7b")).replace(dtype="float32",
                                                                 num_layers=2))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist() for n in (4, 21, 9, 30)]
    out = {"cfg": cfg, "jm": jm, "tm": tm, "prompts": prompts, "jp_dense": jp}
    for base in ("int8", "nf4"):
        jq = j_quantize_base(jp, base, block=BLOCK)
        idx, val = jax.jit(lambda p: j_init_adapters(p, 2))(jq)
        val = jax.tree.map(lambda v: None if v is None else
                           jnp.asarray(0.05 * rng.standard_normal(v.shape), jnp.float32),
                           val, is_leaf=NONE)
        out[base] = {"jp": jq, "tp": quantize_base(tree_to_torch(np_tree(jp)), base, block=BLOCK),
                     "idx": idx, "val": val}
    return out


BASES = ["int8", "nf4"]


@pytest.mark.parametrize("base", BASES)
def test_quantize_base_packs_the_expert_stacks_like_the_reference(world, base):
    jq, tq = world[base]["jp"], world[base]["tp"]
    want = {"/".join(str(getattr(k, "key", k)) for k in p): x
            for p, x in jax.tree_util.tree_flatten_with_path(jq, is_leaf=IS_LEAF)[0]}
    packed = {"/".join(p): x for p, x in flatten(tq) if isinstance(x, QuantizedTensor)}
    assert sorted(packed) == sorted(PACKED_NAMES)
    for name, x in packed.items():
        w = want[name]
        assert isinstance(w, JQT) and (x.qdtype, x.block) == (w.qdtype, w.block)
        assert x.data.numpy().tobytes() == np.asarray(w.data).tobytes(), name
        assert x.scales.numpy().tobytes() == np.asarray(w.scales).tobytes(), name
    cfg = world["cfg"]
    stack = packed["blocks/wgate/w"]
    assert stack.shape == (2, cfg.num_experts, cfg.d_model, cfg.d_ff)
    # block scales along d_in, per expert
    assert tuple(stack.scales.shape) == (2, cfg.num_experts, -(-cfg.d_model // BLOCK), cfg.d_ff)
    assert stack[1][3].shape == (cfg.d_model, cfg.d_ff)  # a layer, then an expert
    assert isinstance(tq["blocks"]["router"]["w"], torch.Tensor)
    assert isinstance(tq["embed"]["w"], torch.Tensor)


@pytest.mark.parametrize("base", BASES)
def test_selection_matches_the_reference_one_expert_at_a_time(world, base, monkeypatch):
    cfg = world["cfg"]
    shapes = []
    real = dequantize

    def spy(qt):
        shapes.append(qt.shape)
        return real(qt)

    import repro_torch.core.adapt as adapt_mod
    monkeypatch.setattr(adapt_mod, "dequantize", spy)
    reset_counters()
    idx, _ = init_adapters(world[base]["tp"], 2)
    want = dict(flatten(np_tree(world[base]["idx"])))
    for path, leaf in flatten(idx):
        assert (leaf is None) == (want[path] is None), path
        if leaf is not None:
            np.testing.assert_array_equal(leaf.numpy(), want[path], err_msg=str(path))
    assert all(len(s) == 2 for s in shapes)  # never a whole stack
    L, E = cfg.num_layers, cfg.num_experts
    assert COUNTERS["topk_select"].plain == 4 * L + 3 * L * E + 1 == len(shapes)


@pytest.mark.parametrize("base", BASES)
def test_forward_loss_and_value_gradients_match_the_reference(world, base):
    w = world[base]
    batch = j_peek("lm", world["cfg"].vocab_size, 2, 16, seed=3)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    jlogits, _ = jax.jit(lambda p, v: j_forward_train(world["cfg"], p, j_zip(w["idx"], v), jb))(
        w["jp"], w["val"])
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(
        lambda v, p: world["jm"].loss(p, j_zip(w["idx"], v), jb), has_aux=True))(w["val"], w["jp"])
    tv = map_leaves(lambda v: None if v is None else v.requires_grad_(),
                    tree_to_torch(np_tree(w["val"])))
    adapters = zip_adapters(tree_to_torch(np_tree(w["idx"])), tv)
    tb = {k: torch.from_numpy(np.asarray(x)) for k, x in batch.items()}
    with torch.no_grad():
        logits, _ = world["tm"].forward_train(w["tp"], adapters, tb)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    loss, metrics = world["tm"].loss(w["tp"], adapters, tb)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"]), float(jmet["aux"]), rtol=1e-5)
    want = dict(flatten(np_tree(jg)))
    n = 0
    for path, v in flatten(tv):
        if v is not None:
            np.testing.assert_allclose(v.grad.numpy(), want[path], rtol=1e-4,
                                       atol=1e-4 * np.abs(want[path]).max(), err_msg=str(path))
            n += 1
    assert n == 8


@pytest.mark.parametrize("base", BASES)
def test_three_train_steps_match_the_reference(world, base):
    w = world[base]
    cfg = world["cfg"]
    jpeft = j_get_peft(JPeftConfig(k=1, delta_dtype="float32"))
    jstep, jopt = j_make_train_step(world["jm"], jpeft, JTrainConfig(steps=3))
    jstep = jax.jit(jstep)
    jvals, jidx = jpeft.init(w["jp"], jax.random.PRNGKey(0))
    jstate = JState(jvals, jopt.init(jvals), jnp.zeros((), jnp.int32))
    peft = get_peft(PeftConfig(k=1, delta_dtype="float32"))
    tc = TrainConfig(steps=3)
    step, opt = make_train_step(world["tm"], peft, tc)
    vals, idx = peft.init(w["tp"])
    state = TrainState(vals, opt.init(vals), torch.zeros((), dtype=torch.int32))
    before = [(x.data.clone(), x.scales.clone()) for _, x in flatten(w["tp"])
              if isinstance(x, QuantizedTensor)]
    for i in range(3):
        batch = J_TASKS["reasoning"](cfg.vocab_size, 4, 16, 0, i)
        jstate, jm = jstep(w["jp"], jidx, jstate, {k: jnp.asarray(x) for k, x in batch.items()})
        state, m = step(w["tp"], idx, state, {k: torch.from_numpy(x) for k, x in batch.items()})
        for key in ("loss", "ce", "aux", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i} {key}")
        # the whole value tree: ||port - ref|| / ||ref||. Element by element
        # a value whose first gradient nearly vanishes moves by lr·g/(|g| +
        # eps) and so amplifies f32 rounding (reduced olmoe's known
        # ill-conditioning, ROADMAP §3)
        want = dict(flatten(np_tree(jstate.trainable)))
        pairs = [(v.numpy(), want[p]) for p, v in flatten(state.trainable) if v is not None]
        diff = np.sqrt(sum(np.sum((a - b) ** 2) for a, b in pairs))
        norm = np.sqrt(sum(np.sum(b ** 2) for _, b in pairs))
        assert len(pairs) == 8 and diff <= 1e-5 * norm, (i, diff / norm)
    after = [x for _, x in flatten(w["tp"]) if isinstance(x, QuantizedTensor)]
    assert all(torch.equal(d, x.data) and torch.equal(s, x.scales)
               for (d, s), x in zip(before, after))


def test_packed_expert_product_saves_no_dense_stack():
    """``ops.bmm_q``: the product and ``dx`` equal autograd through the
    dequantized stack; only the codes and scales are saved; the codes get
    no gradient."""
    from repro_torch.quant import quantize

    g = torch.Generator().manual_seed(0)
    qt = quantize(torch.randn(3, 16, 8, generator=g), "nf4", 4)
    eh = torch.randn(3, 5, 16, generator=g, requires_grad=True)
    y = ops.bmm_q(eh, qt)
    saved = y.grad_fn.saved_tensors
    assert {t.data_ptr() for t in saved} == {qt.data.data_ptr(), qt.scales.data_ptr()}
    dy = torch.randn(3, 5, 8, generator=g)
    (dx,) = torch.autograd.grad(y, eh, dy)
    eh2 = eh.detach().requires_grad_()
    want = torch.bmm(eh2, dequantize(qt))
    (dx2,) = torch.autograd.grad(want, eh2, dy)
    assert torch.equal(y, want) and torch.equal(dx, dx2)
    assert not qt.data.requires_grad


def test_packed_moe_trees_cross_the_packages(world, tmp_path):
    jq = world["int8"]["jp"]
    j_save_pytree(str(tmp_path / "j.npz"), jq)
    got = load_pytree(str(tmp_path / "j.npz"))
    conv = tree_to_torch(j_packed_np(jq))
    for (p, a), (_, b) in zip(flatten(got), flatten(conv)):
        if isinstance(a, QuantizedTensor):
            assert isinstance(b, QuantizedTensor) and a.shape == b.shape, p
            assert torch.equal(a.data, b.data) and torch.equal(a.scales, b.scales), p
        else:
            assert torch.equal(a, b), p
    back = tree_to_numpy(got)["blocks"]["wdown"]["w"]
    assert JQT(*back).data.tobytes() == np.asarray(jq["blocks"]["wdown"]["w"].data).tobytes()
