"""seamless-m4t-large-v2 (the encoder-decoder family) in the port against
the JAX reference, on the CPU: reduced config (2 encoder + 2 decoder
layers, d 64, 4 heads over 2 kv heads of 16, d_ff 128, untied head) in
float32, the reference's params converted leaf by leaf, frames and tokens
from a numpy seed.

Every parity check runs on two attention paths (the ``world`` fixture's
parameter):

* ``dense``: 24 frames, every attention the dense softmax;
* ``flash``: ``flash_threshold`` 32 and ``flash_block`` 8 over 32 frames,
  so the encoder's self-attention (Sq = Skv = 32) and the cross-attention
  (Sq = 16 or 12 decoder rows against 32 frames) take the non-causal flash
  path, with its plain backward, while the decoder's causal self-attention
  (16 rows) stays dense.

It checks selection over ``enc_blocks``, ``dec_blocks`` and ``head`` (the
reference's indices) and every PEFT method's trainable count; logits within
1e-4, the loss within 1e-5 and every value gradient within rtol 1e-4
against the reference's jnp backend, the head's gradient exactly 0 (the
reference applies no head delta); three AdamW steps against the
reference's ``make_train_step``; ``prefill`` + ``decode_step`` equal to the
full forward at S-1 and S, each decode step's self-attention through the
dense decode kernel's plain version, one launch a decoder layer; eight
greedy tokens equal to the reference's; the cache shapes; the engine's
refusal in the reference's words.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import get_model as j_get_model
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.kernels import COUNTERS, reset_counters
from repro_torch.models import get_model
from repro_torch.tree import flatten
from test_torch_mamba import (
    check_loss_and_grads,
    check_method_counts,
    check_prefill_decode,
    check_selection,
    check_three_steps,
    greedy,
    make_world,
    pad_seq,
    tokens,
)

torch.set_num_threads(2)
ARCH = "seamless-m4t-large-v2"
ENC = ("wq", "wk", "wv", "wo", "wgate", "wup", "wdown")
DEC = ("self_wq", "self_wk", "self_wv", "self_wo", "cross_wq", "cross_wk", "cross_wv",
       "cross_wo", "wgate", "wup", "wdown")
# attention path -> (config overrides, frames)
PATHS = {"dense": ({}, 24), "flash": ({"flash_threshold": 32, "flash_block": 8}, 32)}


@pytest.fixture(scope="module", params=list(PATHS))
def world(request):
    cfg_kw, n_frames = PATHS[request.param]
    w = make_world(ARCH, **cfg_kw)
    w["path"] = request.param
    w["frames"] = lambda b, seed=5: np.random.default_rng(seed).standard_normal(
        (b, n_frames, w["cfg"].d_model)).astype(np.float32)
    return w


def pad_self(cache):
    return dict(cache, self_k=pad_seq(cache["self_k"], 2), self_v=pad_seq(cache["self_v"], 2))


def test_registry_builds_it_with_the_references_init_shapes():
    tm = get_model(t_get_config(ARCH))
    assert (tm.cfg.family, tm.cfg.encoder_layers, tm.cfg.num_layers) == ("encdec", 24, 24)
    jp = jax.eval_shape(j_get_model(reduced(get_config(ARCH))).init, jax.random.PRNGKey(0))
    tp = get_model(t_reduced(t_get_config(ARCH))).init(seed=0, device="cpu")
    want = {tuple(str(k.key) for k in p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {p: (tuple(x.shape), str(x.dtype).replace("torch.", "")) for p, x in flatten(tp)}
    assert got == want


def test_selection_covers_both_stacks_and_the_head(world):
    check_selection(world, {f"enc_blocks/{n}/w" for n in ENC}
                    | {f"dec_blocks/{n}/w" for n in DEC} | {"head/w"})
    cfg = world["cfg"]
    assert np.asarray(world["idx"]["dec_blocks"]["cross_wk"]["w"]).shape == (
        cfg.num_layers, 2, cfg.num_kv_heads * cfg.resolved_head_dim)


@pytest.mark.parametrize("method", ["neuroada", "lora", "bitfit", "masked", "full"])
def test_peft_method_counts_equal_the_reference(world, method):
    check_method_counts(world, method)


def test_loss_logits_and_value_gradients_match_reference(world):
    cfg = world["cfg"]
    batch = {"frames": world["frames"](2), "tokens": tokens(world, 2, 16),
             "targets": tokens(world, 2, 16, seed=2)}
    grads = check_loss_and_grads(world, batch, 7 + 11 + 1)
    assert not grads[("head", "w")].any()  # the reference applies no head delta
    n_proj = 7 * cfg.encoder_layers + 11 * cfg.num_layers
    assert COUNTERS["fused_linear"].plain == n_proj
    assert COUNTERS["sparse_delta_dval"].plain == n_proj
    # the encoder's self-attention and the cross-attention, a layer each
    want = cfg.encoder_layers + cfg.num_layers if world["path"] == "flash" else 0
    assert COUNTERS["flash_attention_fwd"].plain == want


def test_three_train_steps_match_reference(world):
    check_three_steps(world, n_adapted=7 + 11 + 1, extra={"frames": world["frames"](4)})


def test_prefill_and_decode_match_the_full_forward(world):
    reset_counters()
    check_prefill_decode(world, pad_self, extra={"frames": world["frames"](2)})
    # two decode steps (without and with adapters) x the decoder's layers
    assert COUNTERS["decode_attention"].plain == 2 * world["cfg"].num_layers


def test_greedy_tokens_match_reference(world):
    port, ref = greedy(world, pad_self, extra={"frames": world["frames"](2, seed=6)})
    np.testing.assert_array_equal(port, ref)


def test_cache_shapes_are_the_references(world):
    jc = jax.eval_shape(lambda: world["jm"].init_cache(3, 20))
    tc = world["tm"].init_cache(3, 20, "cpu")
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in jc.items()}
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tc.items()} == want
    # the prefill's cross k/v are computed once, at the batch's frame count
    with torch.no_grad():
        _, cache = world["tm"].prefill(world["tp"], None, {
            "frames": torch.from_numpy(world["frames"](2)),
            "tokens": torch.from_numpy(tokens(world, 2, 5))})
    cfg = world["cfg"]
    tail = (cfg.num_kv_heads, cfg.resolved_head_dim)
    assert cache["self_k"].shape == (cfg.num_layers, 2, 5, *tail)
    assert cache["cross_v"].shape == (cfg.num_layers, 2, PATHS[world["path"]][1], *tail)


def test_engine_and_the_kv_lm_calls_refuse_as_the_reference(world):
    from repro.serve import ServeEngine as JEngine
    from repro_torch.serve import ServeEngine

    msgs = []
    for make in (lambda: JEngine(world["jm"], world["jp"]),
                 lambda: ServeEngine(world["tm"], world["tp"], device="cpu")):
        with pytest.raises(ValueError) as ei:
            make()
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] == "ServeEngine supports KV LMs, got encdec"
    jm, tm = world["jm"], world["tm"]
    for jcall, tcall in ((lambda: jm.prefill_chunk(None, None, None, None),
                          lambda: tm.prefill_chunk(None, None, None, None)),
                         (lambda: jm.init_paged_cache(4, 16),
                          lambda: tm.init_paged_cache(4, 16, "cpu")),
                         (lambda: jm.init_cache(2, 16, kv_dtype="int8"),
                          lambda: tm.init_cache(2, 16, "cpu", kv_dtype="int8"))):
        with pytest.raises(ValueError) as je:
            jcall()
        with pytest.raises(ValueError) as te:
            tcall()
        assert str(je.value) == str(te.value)
