"""qwen2-vl-2b (the VLM family) in the port against the JAX reference, on
the CPU: reduced config (2 layers, d 64, 4 heads of 16 over 2 kv heads,
M-RoPE sections (2, 3, 3), QKV bias, tied embedding) in float32, the
reference's random params converted leaf by leaf, inputs from a numpy
seed.

* ``mrope_angles`` + ``apply_rope`` against the reference's
  ``apply_mrope``: the angles exact in float32 (each pair's stream, the
  same products), the rotated values within 1e-6 (XLA's and PyTorch's
  cos / sin part by an ulp); one stream for all sections is plain RoPE bit
  for bit; a section split that does not cover hd/2 raises;
* a VLM batch — patch embeddings before the text, (3, B, S_total) M-RoPE
  positions: logits within 1e-4, the loss (text positions only) within
  1e-5, every value gradient within rtol 1e-4 against the reference's jnp
  backend; ``vlm_split`` as the reference's;
* three AdamW steps on VLM batches with two microbatches (``patches``
  split on axis 0, ``positions`` on axis 1) against the reference's
  ``make_train_step``;
* ``prefill`` over patches and the first S text tokens, then
  ``decode_step`` with ``mrope_pos`` (3, B, 1): the full forward's logits
  at S-1 and S; right-padded prompts through ``last_pos`` give each
  prompt's own logits; text prefill + eight greedy decode steps (plain
  RoPE) with an adapter equal to the reference's tokens;
* the paged engine with two tenants and the base (text prompts, plain
  RoPE as in the reference's engine): greedy tokens equal to
  ``repro.serve.ServeEngine(paged=True)``'s; the serve launcher on
  ``--arch qwen2-vl-2b``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import PeftConfig as JPeftConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.core.adapt import init_adapters as j_init_adapters
from repro.core.adapt import zip_adapters as j_zip
from repro.models import layers as jlayers
from repro.peft import get_peft as j_get_peft
from repro.train import TrainState as JState
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import PeftConfig, TrainConfig
from repro_torch.kernels import COUNTERS, reset_counters
from repro_torch.launch import serve as t_serve
from repro_torch.models.layers import apply_rope, mrope_angles, rope_angles, rope_freqs
from repro_torch.peft import get_peft
from repro_torch.train import TrainState, make_train_step
from repro_torch.tree import flatten
from test_torch_mamba import (
    check_loss_and_grads,
    greedy,
    make_world,
    np_tree,
    pad_seq,
    port_adapters,
    tokens,
)
from test_torch_serve import run_pair

torch.set_num_threads(2)
ARCH = "qwen2-vl-2b"


@pytest.fixture(scope="module")
def world():
    w = make_world(ARCH)
    r = np.random.default_rng(5)
    w["tenants"] = []
    for seed in (11, 12):
        idx, val = jax.jit(lambda p: j_init_adapters(p, 2))(w["jp"])
        rv = np.random.default_rng(seed)
        val = jax.tree.map(lambda v: None if v is None else
                           (0.05 * rv.standard_normal(v.shape)).astype(np.float32),
                           val, is_leaf=lambda x: x is None)
        w["tenants"].append((np_tree(idx), val))
    w["prompts"] = [r.integers(3, w["cfg"].vocab_size, size=n).tolist() for n in (4, 21, 9, 30)]
    return w


def vlm_batch(world, b=2, s_txt=12, n_img=4, seed=3):
    """Patches (B, n_img, D), text tokens and targets (B, s_txt), and M-RoPE
    positions (3, B, n_img + s_txt): the patches on a 2 x 2 grid at t = 0,
    the text after them with t = h = w."""
    r = np.random.default_rng(seed)
    cfg = world["cfg"]
    grid = np.stack([np.zeros(n_img), np.arange(n_img) // 2, np.arange(n_img) % 2])
    text = np.arange(s_txt)[None, :] + 2 + np.zeros((3, 1))
    pos = np.concatenate([grid, text], axis=1).astype(np.int32)
    return {"tokens": r.integers(0, cfg.vocab_size, (b, s_txt)).astype(np.int32),
            "targets": r.integers(0, cfg.vocab_size, (b, s_txt)).astype(np.int32),
            "patches": r.standard_normal((b, n_img, cfg.d_model)).astype(np.float32),
            "positions": np.broadcast_to(pos[:, None], (3, b, n_img + s_txt)).copy()}


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ------------------------------------------------------------------ M-RoPE


def test_mrope_angles_with_apply_rope_match_apply_mrope():
    """Each frequency pair turns by its section's stream: the angles are
    bit for bit the float32 products ``position × inv_freq`` the reference
    forms; XLA's and PyTorch's cos / sin differ by up to an ulp, so the
    rotated values are held to 1e-6 against ``apply_mrope``."""
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos3 = r.integers(0, 4096, (3, 2, 7)).astype(np.int32)
    for sections, theta in (((2, 3, 3), 1e6), ((1, 1, 6), 1e4)):
        inv = rope_freqs(16, theta)
        cos, sin = mrope_angles(torch.from_numpy(pos3), inv, sections)
        sec = np.repeat(np.arange(3), sections)
        ang = pos3[sec].transpose(1, 2, 0).astype(np.float32) * inv.numpy()  # (B, S, 8)
        assert torch.equal(cos[:, :, 0], torch.cos(torch.from_numpy(ang)))
        assert torch.equal(sin[:, :, 0], torch.sin(torch.from_numpy(ang)))
        want = np.asarray(jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), theta,
                                              sections))
        got = apply_rope(torch.from_numpy(x), cos, sin)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # one stream for every section is plain RoPE, bit for bit
    same = np.broadcast_to(pos3[:1], pos3.shape).copy()
    cos, sin = mrope_angles(torch.from_numpy(same), rope_freqs(16, 1e6), (2, 3, 3))
    pc, ps = rope_angles(torch.from_numpy(pos3[0]), rope_freqs(16, 1e6))
    assert torch.equal(cos, pc) and torch.equal(sin, ps)
    with pytest.raises(ValueError, match="do not cover"):
        mrope_angles(torch.from_numpy(pos3), rope_freqs(16, 1e6), (2, 3, 2))


# -------------------------------------------------------------- training


def test_vlm_split_is_the_references(world):
    assert world["tm"].vlm_split(4096) == world["jm"].vlm_split(4096) == (1024, 3072)
    assert world["tm"].vlm_split(17) == world["jm"].vlm_split(17)


def test_patch_batch_loss_logits_and_value_gradients_match_reference(world):
    batch = vlm_batch(world)
    check_loss_and_grads(world, batch, 7)
    assert COUNTERS["fused_linear"].plain == 7 * world["cfg"].num_layers


def test_three_microbatched_train_steps_match_reference(world):
    """Two microbatches of a B = 4 VLM batch: ``positions`` split on axis 1."""
    jpeft = j_get_peft(JPeftConfig(k=1, delta_dtype="float32"))
    jstep, jopt = j_make_train_step(world["jm"], jpeft, JTrainConfig(steps=3, microbatches=2))
    jstep = jax.jit(jstep)
    jvals, jidx = jpeft.init(world["jp"], jax.random.PRNGKey(0))
    jstate = JState(jvals, jopt.init(jvals), jnp.zeros((), jnp.int32))
    peft = get_peft(PeftConfig(k=1, delta_dtype="float32"))
    tc = TrainConfig(steps=3, microbatches=2)
    step, opt = make_train_step(world["tm"], peft, tc)
    vals, idx = peft.init(world["tp"])
    state = TrainState(vals, opt.init(vals), torch.zeros((), dtype=torch.int32))
    for i in range(3):
        batch = vlm_batch(world, b=4, seed=20 + i)
        jstate, jm = jstep(world["jp"], jidx, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(world["tp"], idx, state, torch_batch(batch))
        for key in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i} {key}")
        want = dict(flatten(np_tree(jstate.trainable)))
        n = 0
        for path, v in flatten(state.trainable):
            if v is not None:
                np.testing.assert_allclose(v.numpy(), want[path], rtol=1e-5,
                                           atol=1e-4 * tc.learning_rate, err_msg=f"{i} {path}")
                n += 1
        assert n == 7


# ---------------------------------------------------------------- decode


def test_patch_prefill_then_mrope_decode_match_the_full_forward(world):
    batch = vlm_batch(world, s_txt=13)
    tm, tp = world["tm"], world["tp"]
    ad = port_adapters(world)[0]
    full_b = torch_batch(batch)
    pre = dict(full_b, tokens=full_b["tokens"][:, :-1], positions=full_b["positions"][..., :-1])
    with torch.no_grad():
        full, _ = tm.forward_train(tp, ad, full_b)
        lg, cache = tm.prefill(tp, ad, pre)
        cache = {k: pad_seq(v, 2) for k, v in cache.items()}
        s = pre["positions"].shape[-1]
        nxt = tm.decode_step(tp, ad, cache, {
            "token": full_b["tokens"][:, -1], "pos": torch.full((2,), s, dtype=torch.int32),
            "mrope_pos": full_b["positions"][..., -1:]})
    np.testing.assert_allclose(lg.numpy(), full[:, -2].numpy(), atol=2e-5)
    np.testing.assert_allclose(nxt.numpy(), full[:, -1].numpy(), atol=2e-5)
    # the same through the reference
    jlg, _ = world["jm"].prefill(world["jp"], j_zip(world["idx"], world["val"]),
                                 {k: jnp.asarray(v.numpy()) for k, v in pre.items()})
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4)


def test_right_padded_prompts_take_their_last_real_position(world):
    tm, tp = world["tm"], world["tp"]
    toks = tokens(world, 2, 10, seed=8)
    padded = toks.copy()
    padded[1, 7:] = 0
    with torch.no_grad():
        lg, cache = tm.prefill(tp, None, {"tokens": torch.from_numpy(padded),
                                          "last_pos": torch.tensor([9, 6], dtype=torch.int32)})
        own0, _ = tm.prefill(tp, None, {"tokens": torch.from_numpy(toks[:1])})
        own1, _ = tm.prefill(tp, None, {"tokens": torch.from_numpy(toks[1:2, :7])})
    np.testing.assert_allclose(lg[0].numpy(), own0[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(lg[1].numpy(), own1[0].numpy(), atol=1e-5)
    jlg, _ = world["jm"].prefill(world["jp"], None, {"tokens": jnp.asarray(padded),
                                                     "last_pos": jnp.asarray([9, 6])})
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4)
    # the cache: (L, B + 1, S, KV, hd), the trash slot zero
    cfg = world["cfg"]
    assert cache["k"].shape == (cfg.num_layers, 3, 10, cfg.num_kv_heads, 16)
    assert not cache["k"][:, 2].any()


def test_greedy_text_decode_matches_reference(world):
    reset_counters()
    port, ref = greedy(world, lambda c: {k: F.pad(v, (0, 0, 0, 0, 0, 1)) for k, v in c.items()})
    np.testing.assert_array_equal(port, ref)
    # every decode step's attention through the dense decode kernel's plain version
    assert COUNTERS["decode_attention"].plain == 8 * world["cfg"].num_layers


# --------------------------------------------------------------- serving


def test_paged_engine_two_tenants_and_base_match_reference(world):
    jo, to, _, te = run_pair(world, tenants=True, max_new=(3, 7, 12, 5), decode_chunk=2)
    assert to == jo
    assert [len(o) for o in to] == [3, 7, 12, 5]


def test_serve_launcher_serves_the_vlm(capsys):
    t_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--prompts",
                  "1,17,25;1,40,41,42", "--max-new", "3"])
    out = capsys.readouterr().out
    assert out.count("req") >= 2 and "steps=" in out
