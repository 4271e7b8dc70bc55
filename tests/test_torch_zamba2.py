"""zamba2-2.7b (the hybrid family) in the port against the JAX reference,
on the CPU: reduced config cut to 4 Mamba-2 layers in 2 groups of 2 (so the
two-level ``(g, per, ...)`` stacks have both axes above 1, and the tied
shared block runs at 2 sites), d 64, d_inner 128, 8 SSM heads of 16, N 8,
scan chunk 8, attention 4 heads of 16 over 2 kv heads, float32, the
reference's params converted leaf by leaf, inputs from a numpy seed.

* selection: the reference's ``(g, per, k, d_out)`` indices over the
  Mamba-2 stacks and ``(k, d_out)`` over the shared block's seven
  projections and the head; never ``conv_*``, ``A_log``, ``skip_D`` or the
  norms; the reference's trainable counts for every PEFT method;
* logits within 1e-4, the loss within 1e-5 and every value gradient within
  rtol 1e-4 against the reference's jnp backend: the shared block's
  deltas are tied across its sites, so their gradients are sums over the
  sites (held to the reference's and, for one projection, to the sum of
  the per-site gradients of untied copies); the head's delta is never
  applied, as in the reference;
* three AdamW steps against the reference's ``make_train_step`` (and
  ``remat="full"`` bit for bit equal to ``none``);
* ``prefill`` + ``decode_step`` equal to the full forward at S-1 and S,
  each decode step's shared attention through the dense decode kernel's
  plain version, one launch a site; eight greedy tokens equal to the
  reference's;
* the serving engine's refusal, the reference engine's ``ValueError``.
"""

import jax
import numpy as np
import pytest
import torch

from repro_torch.core.delta import Delta
from repro_torch.kernels import COUNTERS, reset_counters
from test_torch_mamba import (
    check_loss_and_grads,
    check_method_counts,
    check_prefill_decode,
    check_selection,
    check_three_steps,
    greedy,
    make_world,
    pad_seq,
    port_adapters,
    tokens,
)

torch.set_num_threads(2)
ARCH = "zamba2-2.7b"
SHARED = ("wq", "wk", "wv", "wo", "wgate", "wup", "wdown")
MAMBA2 = ("in_proj", "bc_proj", "dt_proj", "out_proj")


@pytest.fixture(scope="module")
def world():
    return make_world(ARCH, num_layers=4, attn_every=2)


def pad_kv(cache):
    return dict(cache, shared_k=pad_seq(cache["shared_k"], 2),
                shared_v=pad_seq(cache["shared_v"], 2))


def test_selection_covers_both_stack_levels_and_the_shared_block(world):
    check_selection(world, {f"shared/{n}/w" for n in SHARED}
                    | {f"blocks/{n}/w" for n in MAMBA2} | {"head/w"})
    idx = world["idx"]
    cfg = world["cfg"]
    assert np.asarray(idx["blocks"]["bc_proj"]["w"]).shape == (2, 2, 2, 2 * cfg.ssm_state)
    assert np.asarray(idx["shared"]["wq"]["w"]).shape == (2, cfg.num_heads * 16)


@pytest.mark.parametrize("method", ["neuroada", "lora", "bitfit", "masked", "full"])
def test_peft_method_counts_equal_the_reference(world, method):
    check_method_counts(world, method)


def test_loss_logits_and_value_gradients_match_reference(world):
    batch = {"tokens": tokens(world, 2, 16), "targets": tokens(world, 2, 16, seed=2)}
    grads = check_loss_and_grads(world, batch, 12)
    assert not grads[("head", "w")].any()
    # per group: the shared block's 7 projections, then per x 4 Mamba-2 ones
    assert COUNTERS["fused_linear"].plain == 2 * (7 + 2 * 4)
    assert COUNTERS["sparse_delta_dval"].plain == 2 * (7 + 2 * 4)


def test_the_tied_shared_delta_gradient_is_the_sum_over_its_sites(world):
    """Untie ``shared/wq``'s delta: a copy a site, each with its own leaf;
    the tied gradient is the sum of the copies' gradients."""
    from repro_torch.models import zamba2

    tm, tp, cfg = world["tm"], world["tp"], world["cfg"]
    ad, tv = port_adapters(world, grad=True)
    batch = {"tokens": torch.from_numpy(tokens(world, 2, 16)),
             "targets": torch.from_numpy(tokens(world, 2, 16, seed=2))}
    tm.loss(tp, ad, batch)[0].backward()
    tied = tv["shared"]["wq"]["w"].grad.clone()
    d = ad["shared"]["wq"]["w"]
    copies = [d.val.detach().clone().requires_grad_() for _ in range(2)]
    site = iter(range(10**9))
    real = zamba2.shared_block

    def untied(cfg_, p, a, h, cos, sin):
        a = dict(a, wq={"w": Delta(d.idx, copies[next(site) % 2])})
        return real(cfg_, p, a, h, cos, sin)

    zamba2.shared_block = untied
    try:
        tm.loss(tp, ad, batch)[0].backward()
    finally:
        zamba2.shared_block = real
    torch.testing.assert_close(copies[0].grad + copies[1].grad, tied, rtol=1e-5, atol=1e-7)
    assert copies[0].grad.abs().sum() > 0 and copies[1].grad.abs().sum() > 0


def test_three_train_steps_match_reference(world):
    check_three_steps(world, n_adapted=12)


def test_prefill_and_decode_match_the_full_forward(world):
    reset_counters()
    check_prefill_decode(world, pad_kv)
    # two decode steps (without and with adapters) x 2 sites
    assert COUNTERS["decode_attention"].plain == 4


def test_greedy_tokens_match_reference(world):
    port, ref = greedy(world, pad_kv)
    np.testing.assert_array_equal(port, ref)


def test_cache_shapes_are_the_references(world):
    jc = jax.eval_shape(lambda: world["jm"].init_cache(3, 20))
    tc = world["tm"].init_cache(3, 20, "cpu")
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in jc.items()}
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tc.items()} == want


def test_engines_refuse_as_the_reference(world):
    """The serve launchers build their engine from the model and refuse
    there (``test_torch_mamba.py`` drives both launchers on the SSM family)."""
    from repro.serve import ServeEngine as JEngine
    from repro_torch.serve import ServeEngine

    msgs = []
    for make in (lambda: JEngine(world["jm"], world["jp"]),
                 lambda: ServeEngine(world["tm"], world["tp"], device="cpu")):
        with pytest.raises(ValueError) as ei:
            make()
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] == "ServeEngine supports KV LMs, got hybrid"
