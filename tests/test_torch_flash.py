"""Long-context training attention of the port against the JAX reference,
on the CPU.

* the plain forward (``ref.flash_attention_fwd_ref``) against the Pallas
  kernel in interpret mode (heads folded into the batch, blocks of 64;
  fp32 within 2e-5, bf16 within 2e-2) and its GQA wrapper, and its
  logsumexp against the reference's ``_flash_fwd_scan``;
* the port's ``flash_attention`` and its dq, dk, dv through
  ``torch.autograd`` against ``jax.vjp`` of the reference's
  ``flash_attention`` (fp32, rtol 1e-4), and its refusal of a ragged Skv;
  non-causal with Sq != Skv under GQA (the cross-attention) through the
  training dispatch, within 2e-5;
* reduced qwen2-1.5b and olmoe-1b-7b with ``flash_threshold`` and
  ``flash_block`` lowered so that every layer takes the flash path: loss
  and value gradients against the reference's loss on its jnp backend,
  and three AdamW steps against its ``make_train_step``;
* the launcher at sequence 2048 (the published threshold).

The kernel itself runs on the card only: the ``gpu`` test holds it against
the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PeftConfig as JPeftConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config, reduced
from repro.core.adapt import init_adapters as j_init_adapters
from repro.core.adapt import zip_adapters as j_zip
from repro.data import peek_batch as j_peek
from repro.data.synthetic import TASKS as J_TASKS
from repro.kernels.flash_attention import flash_attention_fwd_pallas, flash_attention_gqa_pallas
from repro.models import get_model as j_get_model
from repro.models.attention import _flash_fwd_scan
from repro.models.attention import flash_attention as j_flash_attention
from repro.peft import get_peft as j_get_peft
from repro.train import TrainState as JState
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import PeftConfig, TrainConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import tree_to_torch
from repro_torch.core.adapt import zip_adapters
from repro_torch.kernels import COUNTERS, LONG_CONTEXT, TRAINING, reset_counters
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.launch import train as launch
from repro_torch.models import get_model
from repro_torch.models.attention import dense_attention, flash_attention
from repro_torch.peft import get_peft
from repro_torch.train import TrainState, make_train_step
from repro_torch.tree import flatten, map_leaves

torch.set_num_threads(2)
NONE = lambda x: x is None  # noqa: E731
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# every layer's attention on the flash path at seq 128: threshold 64, block 32
FLASH = dict(flash_threshold=64, flash_block=32)
SEQ = 128


def np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree, is_leaf=NONE)


def inputs(rng, b, s, h, hkv, hd):
    return [rng.standard_normal((b, s, n, hd)).astype(np.float32) for n in (h, hkv, hkv)]


def to_dtype(a, dtype):
    """(jax array, torch tensor) holding the same values in ``dtype``."""
    j = jnp.asarray(a, dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(torch.bfloat16) if dtype == "bfloat16" else t


# ------------------------------------------------------------- forward


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_matches_pallas_kernel_interpret(causal, dtype):
    """Heads folded into the batch, as the Pallas kernel takes them: a
    (BH, S, hd) tensor is the plain version's (1, S, BH, hd) with one q head
    per kv head."""
    rng = np.random.default_rng(0)
    bh, s, hd = 3, 128, 32
    q, k, v = (rng.standard_normal((bh, s, hd)).astype(np.float32) for _ in range(3))
    (jq, tq), (jk, tk), (jv, tv) = (to_dtype(a, dtype) for a in (q, k, v))
    want = flash_attention_fwd_pallas(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                                      interpret=True)
    got, _ = ref.flash_attention_fwd_ref(*(t.permute(1, 0, 2)[None] for t in (tq, tk, tv)),
                                         causal=causal)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(got[0].permute(1, 0, 2).float().numpy(),
                               np.asarray(want.astype(jnp.float32)), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_matches_pallas_gqa_wrapper(causal):
    rng = np.random.default_rng(1)
    q, k, v = inputs(rng, 2, 128, 6, 2, 16)
    want = flash_attention_gqa_pallas(*map(jnp.asarray, (q, k, v)), causal=causal, block_q=64,
                                      block_k=64, interpret=True)
    got, _ = fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_logsumexp_matches_reference_scan(causal):
    rng = np.random.default_rng(2)
    b, s, h, hkv, hd = 2, 96, 4, 2, 16
    q, k, v = inputs(rng, b, s, h, hkv, hd)
    qg = jnp.asarray(q).reshape(b, s, hkv, h // hkv, hd).transpose(0, 2, 3, 1, 4)
    want_out, want_lse = _flash_fwd_scan(qg, jnp.asarray(k), jnp.asarray(v), causal, 0, 32)
    reset_counters()
    out, lse = fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert (COUNTERS["flash_attention_fwd"].plain, COUNTERS["flash_attention_fwd"].kernel) == (1, 0)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse).reshape(b, h, s), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(want_out).transpose(0, 3, 1, 2, 4).reshape(b, s, h, hd),
        rtol=2e-5, atol=2e-5)


# --------------------------------------------------- forward and gradients


@pytest.mark.parametrize("causal,block,h,hkv", [(True, 32, 4, 2), (False, 32, 4, 2),
                                                (True, 64, 2, 2), (True, 16, 6, 1)])
def test_flash_attention_and_gradients_match_reference_vjp(causal, block, h, hkv):
    rng = np.random.default_rng(3)
    b, s, hd = 2, 128, 16
    q, k, v = inputs(rng, b, s, h, hkv, hd)
    dout = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    want, vjp = jax.vjp(lambda *a: j_flash_attention(*a, causal=causal, block=block),
                        *map(jnp.asarray, (q, k, v)))
    wants = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=causal, block=block)
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(dout))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    for name, g, w in zip("qkv", grads, wants):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("sq,skv,block,h,hkv", [(48, 128, 32, 4, 2), (128, 64, 16, 6, 2),
                                               (16, 96, 32, 4, 1)])
def test_noncausal_cross_attention_matches_reference_vjp(sq, skv, block, h, hkv):
    """The encoder-decoder's cross-attention: ``causal=False`` with Sq !=
    Skv under GQA, reached through the training dispatch
    (``train_attention``) at ``flash_threshold`` <= Skv: out, dq, dk and dv
    against ``jax.vjp`` of the reference's ``flash_attention`` within 2e-5."""
    from types import SimpleNamespace

    from repro_torch.models.attention import train_attention

    rng = np.random.default_rng(5)
    b, hd = 2, 16
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, skv, hkv, hd)).astype(np.float32) for _ in range(2))
    dout = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    want, vjp = jax.vjp(lambda *a: j_flash_attention(*a, causal=False, block=block),
                        *map(jnp.asarray, (q, k, v)))
    wants = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    reset_counters()
    got = train_attention(tq, tk, tv, SimpleNamespace(flash_threshold=skv, flash_block=block),
                          causal=False)
    assert COUNTERS["flash_attention_fwd"].plain == 1
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(dout))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    for name, g, w in zip("qkv", grads, wants):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5,
                                   err_msg=f"d{name}")


def test_flash_attention_refuses_a_ragged_skv():
    q = torch.zeros(1, 100, 4, 16)
    kv = torch.zeros(1, 100, 2, 16)
    with pytest.raises(ValueError, match="multiple of block"):
        flash_attention(q, kv, kv, causal=True, block=32)
    with pytest.raises(ValueError, match="multiple of block"):
        j_flash_attention(jnp.zeros((1, 100, 4, 16)), jnp.zeros((1, 100, 2, 16)),
                          jnp.zeros((1, 100, 2, 16)), causal=True, block=32)
    assert flash_attention(q, kv, kv, causal=True, block=25).shape == q.shape


@pytest.mark.parametrize("case", ["rank", "hd_odd", "hd_wide", "heads", "dtype", "strided",
                                  "bf16_stride"])
def test_wrapper_checks_reject_what_the_kernel_does_not_take(case):
    q, kv = torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 2, 16)
    bad = {"rank": (q[0], kv, kv), "hd_odd": (q[..., :12], kv[..., :12], kv[..., :12]),
           "hd_wide": (torch.zeros(1, 8, 4, 144), torch.zeros(1, 8, 2, 144),
                       torch.zeros(1, 8, 2, 144)),
           "heads": (torch.zeros(1, 8, 3, 16), kv, kv), "dtype": (q.double(), kv, kv),
           "strided": (q.transpose(2, 3), kv, kv),
           "bf16_stride": (torch.zeros(1, 8, 4, 20, dtype=torch.bfloat16)[..., :16],
                           kv.bfloat16(), kv.bfloat16())}[case]
    with pytest.raises((ValueError, TypeError)):
        fa._check(*bad)
    fa._check(q, kv, kv)
    fa._check(q.bfloat16(), kv.bfloat16(), kv.bfloat16())


def test_flash_attention_agrees_with_dense_attention_in_bf16():
    """The dispatch's two sides on bf16 inputs: the same function up to
    bf16 rounding of the output."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in inputs(rng, 1, 64, 4, 2, 16))
    got = flash_attention(q, k, v, causal=True, block=32)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), dense_attention(q, k, v, causal=True).float(),
                               atol=2e-2, rtol=2e-2)


# ------------------------------------------------------ reduced training


def make_world(arch):
    cfg = reduced(get_config(arch)).replace(dtype="float32", **FLASH)
    jm = j_get_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = get_model(t_reduced(t_get_config(arch)).replace(dtype="float32", **FLASH))
    idx, val = j_init_adapters(jp, 2)
    rng = np.random.default_rng(7)
    val = jax.tree.map(lambda v: None if v is None else
                       jnp.asarray(0.05 * rng.standard_normal(v.shape), jnp.float32),
                       val, is_leaf=NONE)
    return {"cfg": cfg, "jm": jm, "jp": jp, "tm": tm, "tp": tree_to_torch(np_tree(jp)),
            "idx": idx, "val": val}


@pytest.fixture(scope="module", params=["qwen2-1.5b", "olmoe-1b-7b"])
def world(request):
    return make_world(request.param)


def test_reduced_loss_and_value_gradients_match_reference_jnp(world):
    batch = j_peek("lm", world["cfg"].vocab_size, 2, SEQ, seed=3)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    (jloss, _), jg = jax.value_and_grad(
        lambda v: world["jm"].loss(world["jp"], j_zip(world["idx"], v), jb), has_aux=True
    )(world["val"])
    tv = map_leaves(lambda v: None if v is None else v.requires_grad_(),
                    tree_to_torch(np_tree(world["val"])))
    reset_counters()
    loss, _ = world["tm"].loss(world["tp"], zip_adapters(tree_to_torch(np_tree(world["idx"])), tv),
                               {k: torch.from_numpy(np.asarray(x)) for k, x in batch.items()})
    loss.backward()
    # every layer's attention went through the flash forward (its plain
    # version, on the CPU)
    assert COUNTERS["flash_attention_fwd"].plain == world["cfg"].num_layers
    assert all(COUNTERS[n].kernel == 0 for n in LONG_CONTEXT + TRAINING)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5, atol=1e-5)
    want = dict(flatten(np_tree(jg)))
    grads = {p: v.grad for p, v in flatten(tv) if v is not None}
    assert set(grads) == {p for p, v in want.items() if v is not None}
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[path], rtol=1e-4,
                                   atol=1e-4 * np.abs(want[path]).max(), err_msg=str(path))


def test_reduced_three_train_steps_match_reference(world):
    cfg = world["cfg"]
    jpeft = j_get_peft(JPeftConfig(k=1, delta_dtype="float32"))
    jstep, jopt = j_make_train_step(world["jm"], jpeft, JTrainConfig(steps=3))
    jstep = jax.jit(jstep)
    jvals, jidx = jpeft.init(world["jp"], jax.random.PRNGKey(0))
    jstate = JState(jvals, jopt.init(jvals), jnp.zeros((), jnp.int32))
    peft = get_peft(PeftConfig(k=1, delta_dtype="float32"))
    tc = TrainConfig(steps=3)
    step, opt = make_train_step(world["tm"], peft, tc)
    vals, idx = peft.init(world["tp"])
    state = TrainState(vals, opt.init(vals), torch.zeros((), dtype=torch.int32))
    for i in range(3):
        batch = J_TASKS["reasoning"](cfg.vocab_size, 2, SEQ, 0, i)
        jstate, jm = jstep(world["jp"], jidx, jstate, {k: jnp.asarray(x) for k, x in batch.items()})
        state, m = step(world["tp"], idx, state,
                        {k: torch.from_numpy(x) for k, x in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5, atol=1e-5,
                                   err_msg=f"step {i} loss")
        assert int(m["skipped"]) == int(jm["skipped"]) == 0
        want = dict(flatten(np_tree(jstate.trainable)))
        for path, v in flatten(state.trainable):
            if v is not None:
                np.testing.assert_allclose(v.numpy(), want[path], rtol=1e-4,
                                           atol=1e-4 * tc.learning_rate,
                                           err_msg=f"step {i} {path}")


def test_launcher_trains_at_the_flash_threshold_on_the_cpu(caplog):
    """Sequence 2048 is the published threshold: reduced qwen2-1.5b takes
    the flash path (block 512) in both layers."""
    reset_counters()
    with caplog.at_level("INFO"):
        hist = launch.main(["--reduced", "--device", "cpu", "--steps", "1", "--batch", "1",
                            "--seq", "2048"])
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    assert COUNTERS["flash_attention_fwd"].plain == 2


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_kernel_matches_plain_version(cuda, dtype):
    """Ragged S, hd 16 / 64 / 128, GQA groups 1 and 6, causal and full. lse
    is float32 arithmetic on both sides: 1e-4 absolute in both dtypes. bf16
    out is also held as a whole against the plain version in float32 on the
    same inputs: at most three times the relative error of rounding that
    exact output to bf16 once (the kernel rounds twice, p and out)."""
    rng = np.random.default_rng(5)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    reset_counters()
    for b, s, h, hkv, hd in ((1, 130, 4, 4, 16), (2, 200, 12, 2, 64), (1, 77, 6, 1, 128)):
        q, k, v = (torch.from_numpy(a).to(dtype).to(cuda) for a in inputs(rng, b, s, h, hkv, hd))
        for causal in (True, False):
            out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
            want, want_lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
            torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
            torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
            if dtype == torch.bfloat16:
                exact = fa.flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                                     causal=causal)[0]
                rounding = (exact.to(dtype).float() - exact).norm()
                assert (out.float() - exact).norm() <= 3 * rounding
    torch.cuda.synchronize()
    assert COUNTERS["flash_attention_fwd"].kernel == 6
