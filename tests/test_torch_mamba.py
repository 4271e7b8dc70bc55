"""falcon-mamba-7b (the SSM family) in the port against the JAX reference,
on the CPU: reduced config (2 layers, d 64, d_inner 128, N 8, dt rank 8,
scan chunk 8, untied head) in float32, the reference's random params
converted leaf by leaf, inputs from a numpy seed.

* ``get_model`` builds every family, seamless-m4t-large-v2's encdec too;
  the chunked prefill and verification, the paged cache and int8 KV raise
  with the reference's words;
* selection: the reference's indices; only the ``…/w`` leaves of
  ``in_proj``, ``x_proj``, ``dt_proj``, ``out_proj`` and the untied head
  are adapted (never ``conv_w``, ``conv_b``, ``A_log``, ``skip_D`` or the
  norms), and the trainable count is ``repro.core.count_trainable``'s;
* logits within 1e-4, the loss within 1e-5 and every value gradient
  within rtol 1e-4 against the reference's jnp backend; the head's delta
  is never applied (as in the reference), so its gradient is zero in both;
* three AdamW steps against the reference's ``make_train_step``, and the
  port's ``remat="full"`` bit for bit equal to its ``none``;
* ``prefill`` + ``decode_step`` equal to the full forward at positions
  S-1 and S, and eight greedy tokens from ``prefill`` + ``decode_step``
  with an adapter equal to the reference's;
* every PEFT method's trainable count equal to the reference's (the
  reference's launcher trains them all on this family), the train launcher
  with its adapter export, the serve launcher's refusal (the reference
  engine's ``ValueError``).

The helpers here serve ``test_torch_zamba2.py`` and
``test_torch_encdec.py`` as well: ``extra`` inputs (the encoder-decoder's
``frames``) join every batch they build. The scans' own
tolerances are argued in ``test_torch_ssm.py``; the whole model's sums add
only float32 rounding of the same order.
"""

import logging
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import PeftConfig as JPeftConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config, reduced
from repro.core.adapt import count_trainable as j_count_trainable
from repro.core.adapt import init_adapters as j_init_adapters
from repro.core.adapt import zip_adapters as j_zip
from repro.data.synthetic import TASKS as J_TASKS
from repro.launch import serve as j_serve
from repro.models import get_model as j_get_model
from repro.peft import get_peft as j_get_peft
from repro.train import TrainState as JState
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import PeftConfig, TrainConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import tree_to_torch
from repro_torch.core.adapt import count_trainable, init_adapters, zip_adapters
from repro_torch.kernels import COUNTERS, reset_counters
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import get_model
from repro_torch.peft import get_peft
from repro_torch.train import TrainState, make_train_step
from repro_torch.tree import flatten, map_leaves

torch.set_num_threads(2)
NONE = lambda x: x is None  # noqa: E731
ARCH = "falcon-mamba-7b"


def np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree, is_leaf=NONE)


def make_world(arch, k=2, **cfg_kw):
    """Reference and port models on the same fp32 params, k-sparse
    adapters with random values (reference trees and the port's)."""
    cfg = reduced(get_config(arch)).replace(dtype="float32", **cfg_kw)
    jm = j_get_model(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = get_model(t_reduced(t_get_config(arch)).replace(dtype="float32", **cfg_kw))
    idx, val = jax.jit(lambda p: j_init_adapters(p, k))(jp)
    r = np.random.default_rng(7)
    val = jax.tree.map(lambda v: None if v is None else
                       jnp.asarray(0.05 * r.standard_normal(v.shape), jnp.float32),
                       val, is_leaf=NONE)
    return {"cfg": cfg, "jm": jm, "jp": jp, "tm": tm, "tp": tree_to_torch(np_tree(jp)),
            "idx": idx, "val": val}


def port_adapters(world, grad=False):
    tv = map_leaves(lambda v: None if v is None else (v.requires_grad_() if grad else v),
                    tree_to_torch(np_tree(world["val"])))
    return zip_adapters(tree_to_torch(np_tree(world["idx"])), tv), tv


def tokens(world, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, world["cfg"].vocab_size,
                                                (b, s)).astype(np.int32)


def adapted_paths(tree) -> set:
    return {"/".join(p) for p, v in flatten(tree) if v is not None}


def check_selection(world, want_adapted):
    idx, vals = init_adapters(world["tp"], 2)
    want = dict(flatten(np_tree(world["idx"])))
    got = dict(flatten(idx))
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        assert (leaf is None) == (want[path] is None), path
        if leaf is not None:
            np.testing.assert_array_equal(leaf.numpy(), want[path], err_msg=str(path))
    assert adapted_paths(idx) == want_adapted
    assert count_trainable(vals) == j_count_trainable(world["val"])


def check_loss_and_grads(world, batch, n_adapted):
    """Logits (1e-4), loss (1e-5) and value gradients (rtol 1e-4) against
    the reference's jnp backend; returns the port's gradient tree."""
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    jm, jp = world["jm"], world["jp"]

    def ref(v):
        grad = jax.value_and_grad(lambda v: jm.loss(jp, j_zip(world["idx"], v), jb)[0])
        return grad(v), jm.forward(jp, j_zip(world["idx"], v), jb)[0]

    (jloss, jg), jlogits = jax.jit(ref)(world["val"])
    ad, tv = port_adapters(world, grad=True)
    tb = {k: torch.from_numpy(np.asarray(x)) for k, x in batch.items()}
    with torch.no_grad():
        logits, _ = world["tm"].forward_train(world["tp"], ad, tb)
    reset_counters()  # the launches of the loss and its backward alone
    loss, _ = world["tm"].loss(world["tp"], ad, tb)
    loss.backward()
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5, atol=1e-5)
    want = dict(flatten(np_tree(jg)))
    # a value no forward reads (the head's) gets no .grad: zero, as the trainer takes it
    grads = {p: torch.zeros_like(v) if v.grad is None else v.grad
             for p, v in flatten(tv) if v is not None}
    assert len(grads) == n_adapted
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[path], rtol=1e-4,
                                   atol=1e-4 * max(np.abs(want[path]).max(), 1e-12),
                                   err_msg=str(path))
    return grads


def port_steps(world, remat: str, n: int = 3, extra=None):
    """The port's values and metrics after each of ``n`` AdamW steps (k = 1)
    on the reasoning task's batches (with ``extra`` inputs)."""
    peft = get_peft(PeftConfig(k=1, delta_dtype="float32"))
    step, opt = make_train_step(world["tm"], peft, TrainConfig(steps=3, remat=remat))
    vals, idx = peft.init(world["tp"])
    state = TrainState(vals, opt.init(vals), torch.zeros((), dtype=torch.int32))
    out = []
    for i in range(n):
        batch = dict(J_TASKS["reasoning"](world["cfg"].vocab_size, 4, 16, 0, i), **(extra or {}))
        state, m = step(world["tp"], idx, state, {k: torch.from_numpy(x) for k, x in batch.items()})
        out.append((state.trainable, m))
    return out


def check_three_steps(world, n_adapted, extra=None):
    """Three AdamW steps (k = 1) against the reference's jitted step: the
    metrics within rtol 1e-5, the values within rtol 1e-5 and 5e-4 × lr.
    Adam's first update is lr · g / (|g| + ε), so where a gradient is small
    (1e-6 to 1e-5 on ``dt_proj``, ε = 1e-8) the scans' float32 rounding of g
    reaches the update scaled up: up to 1.5e-4 × lr here. The port's
    ``remat="full"`` (the scan's written-out backward recomputed under
    ``torch.utils.checkpoint``) gives the same values bit for bit."""
    cfg = world["cfg"]
    jpeft = j_get_peft(JPeftConfig(k=1, delta_dtype="float32"))
    jstep, jopt = j_make_train_step(world["jm"], jpeft, JTrainConfig(steps=3))
    jstep = jax.jit(jstep)
    jvals, jidx = jpeft.init(world["jp"], jax.random.PRNGKey(0))
    jstate = JState(jvals, jopt.init(jvals), jnp.zeros((), jnp.int32))
    lr = TrainConfig().learning_rate
    for i, ((vals, m), (fvals, fm)) in enumerate(zip(port_steps(world, "none", extra=extra),
                                                     port_steps(world, "full", extra=extra))):
        batch = dict(J_TASKS["reasoning"](cfg.vocab_size, 4, 16, 0, i), **(extra or {}))
        jstate, jmet = jstep(world["jp"], jidx, jstate,
                             {k: jnp.asarray(x) for k, x in batch.items()})
        for key in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jmet[key]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i} {key}")
            assert torch.equal(m[key], fm[key]), (i, key)
        want = dict(flatten(np_tree(jstate.trainable)))
        got = [(p, v) for p, v in flatten(vals) if v is not None]
        assert len(got) == n_adapted
        full = dict(flatten(fvals))
        for path, v in got:
            np.testing.assert_allclose(v.numpy(), want[path], rtol=1e-5, atol=5e-4 * lr,
                                       err_msg=f"step {i} {path}")
            assert torch.equal(v, full[path]), (i, path)


def check_method_counts(world, method):
    """Trainable counts of a PEFT method's init equal the reference's."""
    pc = dict(method=method, k=1, delta_dtype="float32")
    jtr, _ = jax.eval_shape(lambda: j_get_peft(JPeftConfig(**pc)).init(
        world["jp"], jax.random.PRNGKey(0)))  # shapes alone: no values needed
    tr, _ = get_peft(PeftConfig(**pc)).init(world["tp"], torch.Generator().manual_seed(0))
    # repro.core.count_trainable's sum, over the shapes
    want = sum(math.prod(v.shape) for v in jax.tree.leaves(jtr) if v is not None)
    assert count_trainable(tr) == want > 0


def pad_seq(x, axis):
    """One more zero row on the sequence axis ``axis`` of a cache leaf."""
    pad = [0, 0] * (x.ndim - axis - 1) + [0, 1]
    return F.pad(x, pad)


def check_prefill_decode(world, pad_cache, s=16, extra=None):
    """prefill over S tokens then one decode step equal the full forward at
    positions S-1 and S (2e-4: a prefill's sums are the forward's; the
    decode's recurrence adds one float32 step), with and without adapters."""
    toks = tokens(world, 2, s + 1)
    tm, tp = world["tm"], world["tp"]
    ex = {k: torch.from_numpy(x) for k, x in (extra or {}).items()}
    for ad in (None, port_adapters(world)[0]):
        with torch.no_grad():
            full, _ = tm.forward_train(tp, ad, {"tokens": torch.from_numpy(toks), **ex})
            lg, cache = tm.prefill(tp, ad, {"tokens": torch.from_numpy(toks[:, :s]), **ex})
            cache = pad_cache(cache)
            nxt = tm.decode_step(tp, ad, cache, {"token": torch.from_numpy(toks[:, s]),
                                                 "pos": torch.full((2,), s, dtype=torch.int32)})
        np.testing.assert_allclose(lg.numpy(), full[:, s - 1].numpy(), atol=2e-4)
        np.testing.assert_allclose(nxt.numpy(), full[:, s].numpy(), atol=2e-4)


def greedy(world, pad_cache, s=12, steps=8, extra=None):
    """(port tokens, reference tokens): prefill over S prompt tokens (and
    ``extra`` inputs) then ``steps`` greedy decode steps with the adapters,
    in each package."""
    toks = tokens(world, 2, s, seed=4)
    tm, tp, jm, jp = world["tm"], world["tp"], world["jm"], world["jp"]
    ad = port_adapters(world)[0]
    extra = extra or {}
    out = []
    with torch.no_grad():
        lg, cache = tm.prefill(tp, ad, {"tokens": torch.from_numpy(toks),
                                        **{k: torch.from_numpy(x) for k, x in extra.items()}})
        for _ in range(steps):
            cache = pad_cache(cache)
        for i in range(steps):
            tok = lg.argmax(-1).to(torch.int32)
            out.append(tok.numpy())
            lg = tm.decode_step(tp, ad, cache, {"token": tok,
                                                "pos": torch.full((2,), s + i, dtype=torch.int32)})
    jad = j_zip(world["idx"], world["val"])
    jlg, jcache = jax.jit(lambda t, e: jm.prefill(jp, jad, {"tokens": t, **e}))(
        jnp.asarray(toks), {k: jnp.asarray(x) for k, x in extra.items()})
    pad = ((0, 0), (0, 0), (0, steps), (0, 0), (0, 0))  # room for the new tokens' k/v
    jcache = {k: jnp.pad(v, pad) if k in ("k", "v", "shared_k", "shared_v", "self_k", "self_v")
              else v for k, v in jcache.items()}
    dstep = jax.jit(lambda c, t, p: jm.decode_step(jp, jad, c, {"token": t, "pos": p}))
    ref = []
    for i in range(steps):
        tok = jnp.argmax(jlg, -1).astype(jnp.int32)
        ref.append(np.asarray(tok))
        jlg, jcache = dstep(jcache, tok, jnp.int32(s + i))
    return np.stack(out), np.stack(ref)


@pytest.fixture(scope="module")
def world():
    return make_world(ARCH)


# ------------------------------------------------------------------ tests


def test_registry_builds_the_families_and_refuses_with_the_reference_words(world):
    for arch in ("qwen2-vl-2b", "falcon-mamba-7b", "zamba2-2.7b", "seamless-m4t-large-v2"):
        assert get_model(t_get_config(arch)).cfg.name == arch
    for arch in ("falcon-mamba-7b", "zamba2-2.7b"):
        jm, tm = j_get_model(reduced(get_config(arch))), get_model(t_reduced(t_get_config(arch)))
        calls = (("prefill_chunk", lambda m: m.prefill_chunk(None, None, None, None)),
                 ("verify_chunk", lambda m: m.verify_chunk(None, None, None, None)))
        for _, call in calls:
            msgs = []
            for m in (jm, tm):
                with pytest.raises(ValueError) as ei:
                    call(m)
                msgs.append(str(ei.value))
            assert msgs[0] == msgs[1]
        with pytest.raises(ValueError) as je:
            jm.init_paged_cache(4, 16)
        with pytest.raises(ValueError) as te:
            tm.init_paged_cache(4, 16, "cpu")
        assert str(je.value) == str(te.value)
        with pytest.raises(ValueError) as je:
            jm.init_cache(2, 16, kv_dtype="int8")
        with pytest.raises(ValueError) as te:
            tm.init_cache(2, 16, "cpu", kv_dtype="int8")
        assert str(je.value) == str(te.value)


def test_init_shapes_and_dtypes_are_the_references():
    cfg = t_reduced(t_get_config(ARCH))
    jp = jax.eval_shape(j_get_model(reduced(get_config(ARCH))).init, jax.random.PRNGKey(0))
    tp = get_model(cfg).init(seed=0, device="cpu")
    want = {tuple(str(k.key) for k in p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {p: (tuple(x.shape), str(x.dtype).replace("torch.", "")) for p, x in flatten(tp)}
    assert got == want


def test_selection_adapts_only_the_projections_and_the_head(world):
    check_selection(world, {"blocks/in_proj/w", "blocks/x_proj/w", "blocks/dt_proj/w",
                            "blocks/out_proj/w", "head/w"})


def test_loss_logits_and_value_gradients_match_reference(world):
    batch = {"tokens": tokens(world, 2, 16), "targets": tokens(world, 2, 16, seed=2)}
    grads = check_loss_and_grads(world, batch, 5)
    assert not grads[("head", "w")].any()  # the reference applies no head delta
    # per layer: in_proj, x_proj, dt_proj, out_proj through the fused kernel
    assert COUNTERS["fused_linear"].plain == 4 * world["cfg"].num_layers
    assert COUNTERS["sparse_delta_dval"].plain == 4 * world["cfg"].num_layers


def test_three_train_steps_match_reference(world):
    check_three_steps(world, n_adapted=5)


def test_prefill_and_decode_match_the_full_forward(world):
    check_prefill_decode(world, lambda c: c)


def test_greedy_tokens_match_reference(world):
    port, ref = greedy(world, lambda c: c)
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("method", ["neuroada", "lora", "bitfit", "masked", "full"])
def test_peft_method_counts_equal_the_reference(world, method):
    check_method_counts(world, method)


def test_train_launcher_trains_and_exports_on_the_cpu(tmp_path, caplog):
    out = tmp_path / "a.npz"
    with caplog.at_level(logging.INFO):
        hist = t_train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
                             "--batch", "2", "--seq", "8", "--export-adapter", str(out)])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert "trainable=1,456/126,912" in caplog.text  # the reference launcher's count
    from repro.peft import load_adapter as j_load_adapter

    idx, _ = j_load_adapter(str(out))
    assert idx["blocks"]["x_proj"]["w"].shape == (2, 1, 24)


def test_serve_launcher_refuses_as_the_reference():
    msgs = []
    for main, extra in ((j_serve.main, []), (t_serve.main, ["--device", "cpu"])):
        with pytest.raises(ValueError) as ei:
            main(["--arch", ARCH, "--reduced", "--max-new", "1", *extra])
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] == "ServeEngine supports KV LMs, got ssm"
