"""The port's Mamba-1 and Mamba-2 blocks against the reference's with its
Pallas kernels in interpret mode (``fused_linear_pallas`` forward,
``sparse_delta_dval_pallas`` in its backward), on the CPU: the output and
the value gradient of every adapted projection under random NeuroAda
deltas, in float32 (rtol 1e-5 and 1e-4, as on the jnp backend in
``test_torch_ssm.py``).

The blocks are called directly, as the reference's scan body: its
``custom_vjp`` around ``fused_linear_pallas`` cannot run under its own
``lax.scan`` and ``jax.grad`` on jax 0.9 (see
``test_torch_train_interpret.py``), and one block holds every projection
shape the family adapts. The zamba2 shared block is the transformer's
block, held in interpret mode in ``test_torch_train_interpret.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.delta import Delta as JDelta
from repro.kernels import ops as jops
from repro.models import ssm as jssm
from repro_torch.core.delta import Delta
from repro_torch.models import ssm
from test_torch_ssm import block_world, close, t

torch.set_num_threads(2)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_block_and_value_gradients_match_the_interpreted_kernels(arch):
    cfg, jp, idx, val = block_world(arch)
    block = ssm.mamba1_block if cfg.family == "ssm" else ssm.mamba2_block
    jblock = jssm.mamba1_block if cfg.family == "ssm" else jssm.mamba2_block
    h = np.random.default_rng(9).normal(size=(2, 13, cfg.d_model)).astype(np.float32)
    tp = jax.tree.map(lambda x: torch.tensor(x), jp)
    tv = {n: t(v, grad=True) for n, v in val.items()}
    out = block(cfg, tp, {n: Delta(torch.tensor(idx[n]), tv[n]) for n in idx}, t(h))
    out.sum().backward()

    def ref(v):
        o = jblock(cfg, jp, {n: JDelta(jnp.asarray(idx[n]), v[n]) for n in idx}, jnp.asarray(h))
        return o.sum(), o

    with jops.use_backend("pallas_interpret"):
        jg, jo = jax.grad(ref, has_aux=True)({n: jnp.asarray(v) for n, v in val.items()})
    close(out, jo, rtol=1e-5, what="out")
    for n in idx:
        close(tv[n].grad, jg[n], rtol=1e-4, what=f"d{n}")
