"""The port's state-space blocks (``repro_torch.models.ssm``) against the
JAX reference's (``repro.models.ssm``), on the CPU in float32, with inputs
made from a numpy seed.

* ``causal_conv`` and ``conv_step``: the same float32 taps in the same
  order, held to 1e-6;
* ``selective_scan`` (Mamba-1: the log-step doubling scan here, the
  reference's ``lax.associative_scan``) and ``ssd_scan`` (Mamba-2, the
  quadratic-in-chunk form in both) at a chunk of S, a divisor of S and a
  non-divisor (the reference pads the last chunk; the port runs it short):
  outputs and final states, and the gradients of a weighted sum of both
  with respect to every input, held to rtol 1e-5 and an absolute 1e-5 ×
  the largest magnitude. The two sums of up to S products differ only in
  their order: float32 rounding, a few ulps of the largest term;
* a long chunk with large decays, where the reference's SSD forms
  ``exp(cum_t - cum_s)`` above the diagonal, overflows and turns the
  masked entries into NaN: the port masks the exponent first and stays
  equal to a sequential float64 recurrence;
* ``mamba1_block`` / ``mamba2_block`` (with ``return_state``) and their
  single-token decodes under random NeuroAda deltas: outputs, states and
  the value gradients (rtol 1e-4), the bypass through the fused linear's
  plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core.delta import Delta as JDelta
from repro.models import ssm as jssm
from repro_torch.core.delta import Delta
from repro_torch.kernels import COUNTERS, reset_counters
from repro_torch.models import ssm

torch.set_num_threads(2)


def rng(seed=5):
    return np.random.default_rng(seed)


def close(got, want, rtol=1e-5, what=""):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def t(x, grad=False):
    out = torch.tensor(np.asarray(x, np.float32))
    return out.requires_grad_() if grad else out


# ----------------------------------------------------------------- convs


def test_causal_conv_and_conv_step_match_reference():
    r = rng()
    x = r.normal(size=(2, 11, 6)).astype(np.float32)
    w = r.normal(size=(4, 6)).astype(np.float32)
    b = r.normal(size=(6,)).astype(np.float32)
    got = ssm.causal_conv(t(x), t(w), t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(jssm.causal_conv(x, w, b)), atol=1e-6)
    state = r.normal(size=(2, 3, 6)).astype(np.float32)
    y, st = ssm.conv_step(t(x[:, 0]), t(state), t(w), t(b))
    jy, jst = jssm.conv_step(jnp.asarray(x[:, 0]), jnp.asarray(state), w, b)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-6)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    # the decode conv continues the sequence conv: the window of the last 3 inputs
    seq = ssm.causal_conv(t(x), t(w), t(b))
    y, _ = ssm.conv_step(t(x[:, 7]), t(x[:, 4:7]), t(w), t(b))
    np.testing.assert_allclose(y.numpy(), seq[:, 7].numpy(), atol=1e-6)


# ----------------------------------------------------------------- scans


def mamba1_inputs(s, seed=5):
    r = rng(seed)
    b, di, n = 2, 6, 4
    return (r.normal(size=(b, s, di)), r.uniform(0.01, 0.2, size=(b, s, di)),
            -r.uniform(0.5, 2.0, size=(di, n)), r.normal(size=(b, s, n)),
            r.normal(size=(b, s, n)))


def ssd_inputs(s, seed=6, dt_hi=0.3):
    r = rng(seed)
    b, hh, pp, n = 2, 3, 4, 5
    return (r.normal(size=(b, s, hh, pp)), r.uniform(0.01, dt_hi, size=(b, s, hh)),
            -r.uniform(0.5, 2.0, size=(hh,)), r.normal(size=(b, s, n)), r.normal(size=(b, s, n)))


def scan_and_grads(port_scan, ref_scan, inputs, chunk):
    """Outputs, states and d(Σ y·wy + Σ h·wh)/d(every input) of both."""
    r = rng(11)
    inputs = [np.asarray(a, np.float32) for a in inputs]
    ty = [t(a, grad=True) for a in inputs]
    y, h = port_scan(*ty, chunk)
    wy = r.normal(size=y.shape).astype(np.float32)
    wh = r.normal(size=h.shape).astype(np.float32)
    ((y * t(wy)).sum() + (h * t(wh)).sum()).backward()

    def ref_obj(*args):
        jy, jh = ref_scan(*args, chunk)
        return (jy * wy).sum() + (jh * wh).sum(), (jy, jh)

    jg, (jy, jh) = jax.jit(jax.grad(ref_obj, argnums=tuple(range(5)), has_aux=True))(
        *[jnp.asarray(a) for a in inputs])
    return (y, h, [a.grad for a in ty]), (jy, jh, jg)


@pytest.mark.parametrize("s,chunk", [(16, 16), (16, 4), (24, 7)],
                         ids=["chunk=S", "divisor", "non-divisor"])
def test_selective_scan_and_gradients_match_reference(s, chunk):
    (y, h, g), (jy, jh, jg) = scan_and_grads(ssm.selective_scan, jssm.selective_scan,
                                             mamba1_inputs(s), chunk)
    close(y, jy, what="y")
    close(h, jh, what="h")
    for name, a, b in zip(("x", "dt", "A", "B", "C"), g, jg):
        close(a, b, what=f"d{name}")


@pytest.mark.parametrize("s,chunk", [(16, 16), (20, 4), (20, 8)],
                         ids=["chunk=S", "divisor", "non-divisor"])
def test_ssd_scan_and_gradients_match_reference(s, chunk):
    (y, h, g), (jy, jh, jg) = scan_and_grads(ssm.ssd_scan, jssm.ssd_scan, ssd_inputs(s), chunk)
    close(y, jy, what="y")
    close(h, jh, what="h")
    for name, a, b in zip(("x", "dt", "A", "B", "C"), g, jg):
        close(a, b, what=f"d{name}")


def ssd_sequential(x, dt, a_head, b_in, c_in):
    b, s, hh, pp = x.shape
    h = np.zeros((b, hh, pp, b_in.shape[-1]))
    ys = np.zeros((b, s, hh, pp))
    for i in range(s):
        h = np.exp(dt[:, i] * a_head)[..., None, None] * h + np.einsum(
            "bh,bhp,bn->bhpn", dt[:, i], x[:, i], b_in[:, i])
        ys[:, i] = np.einsum("bhpn,bn->bhp", h, c_in[:, i])
    return ys, h


def test_ssd_scan_stays_finite_where_the_reference_overflows():
    """A 256-step chunk with decays summing to ≈ 256: the reference's
    ``exp(cum_t - cum_s)`` above the diagonal overflows, inf × 0 = NaN; the
    port's masked exponent gives the sequential recurrence (float64)."""
    x, dt, a, b, c = ssd_inputs(256, dt_hi=2.0)
    jy, _ = jssm.ssd_scan(*[jnp.asarray(v, jnp.float32) for v in (x, dt, a, b, c)], 256)
    assert np.isnan(np.asarray(jy)).any()
    y, h = ssm.ssd_scan(*[t(v) for v in (x, dt, a, b, c)], 256)
    y_ref, h_ref = ssd_sequential(x, dt, a, b, c)
    close(y, y_ref, rtol=1e-4, what="y")
    close(h, h_ref, rtol=1e-4, what="h")


# ----------------------------------------------------------------- blocks


def block_world(arch):
    cfg = reduced(get_config(arch)).replace(dtype="float32")
    key = jax.random.PRNGKey(3)
    if cfg.family == "ssm":
        jp = jax.tree.map(lambda x: x[0], jssm.init_mamba1_block(cfg, key, jnp.float32))
    else:
        jp = jax.tree.map(lambda x: x[0], jssm.init_mamba2_block(cfg, key, jnp.float32, (1,)))
    # random norms, conv bias, skip and A so every term is exercised
    r = rng(8)
    jp = jax.tree.map(lambda x: x + 0.1 * r.standard_normal(x.shape).astype(np.float32), jp)
    adapted = [n for n in jp if isinstance(jp[n], dict)]
    idx, val = {}, {}
    for n in adapted:
        d_in, d_out = jp[n]["w"].shape
        idx[n] = np.stack([r.permutation(d_in)[:2] for _ in range(d_out)], 1).astype(np.int32)
        val[n] = (0.05 * r.standard_normal((2, d_out))).astype(np.float32)
    return cfg, jax.tree.map(np.asarray, jp), idx, val


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_blocks_states_decode_and_value_gradients_match_reference(arch):
    cfg, jp, idx, val = block_world(arch)
    block, decode = ((ssm.mamba1_block, ssm.mamba1_decode) if cfg.family == "ssm"
                     else (ssm.mamba2_block, ssm.mamba2_decode))
    jblock, jdecode = ((jssm.mamba1_block, jssm.mamba1_decode) if cfg.family == "ssm"
                       else (jssm.mamba2_block, jssm.mamba2_decode))
    h = rng(9).normal(size=(2, 13, cfg.d_model)).astype(np.float32)
    tp = jax.tree.map(lambda x: torch.tensor(x), jp)
    tv = {n: t(v, grad=True) for n, v in val.items()}
    ta = {n: Delta(torch.tensor(idx[n]), tv[n]) for n in idx}
    reset_counters()
    out, (conv, state) = block(cfg, tp, ta, t(h), return_state=True)
    out.sum().backward()
    assert COUNTERS["fused_linear"].plain == len(idx)  # every projection through its kernel

    def ref(v):
        o, st = jblock(cfg, jp, {n: JDelta(jnp.asarray(idx[n]), v[n]) for n in idx},
                       jnp.asarray(h), return_state=True)
        return o.sum(), (o, st)

    jg, (jo, (jconv, jstate)) = jax.jit(jax.grad(ref, has_aux=True))(
        {n: jnp.asarray(v) for n, v in val.items()})
    close(out, jo, rtol=1e-5, what="out")
    close(conv, jconv, rtol=1e-5, what="conv")
    close(state, jstate, rtol=1e-5, what="state")
    for n in idx:
        close(tv[n].grad, jg[n], rtol=1e-4, what=f"d{n}")
    # one decode step from the block's states equals the reference's
    x1 = rng(10).normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        o1, c1, s1 = decode(cfg, tp, ta, t(x1), conv, state)
    jo1, jc1, js1 = jdecode(cfg, jp, {n: JDelta(jnp.asarray(idx[n]), jnp.asarray(val[n]))
                                      for n in idx}, jnp.asarray(x1), jconv, jstate)
    close(o1, jo1, rtol=1e-5, what="decode out")
    close(c1, jc1, rtol=1e-6, what="decode conv")
    close(s1, js1, rtol=1e-5, what="decode state")
