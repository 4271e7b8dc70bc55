"""The port's MoE training loss and value gradients against the
reference's Pallas kernels in interpret mode, on the CPU.

Reduced olmoe-1b-7b in fp32 cut to one layer (the interpret-mode reference
runs eagerly, ~30 s for the layer and the head; the two-layer stack is held
against the jnp backend in ``test_torch_moe_train.py``): the loss within
1e-5 and the value gradients of every adapted matrix — the four attention
projections through ``fused_linear_pallas``, the three expert stacks and
the untied head through ``sparse_delta_pallas`` (vmapped over the experts
as ``moe.py`` does) and ``sparse_delta_dval_pallas`` — within rtol 1e-4.

The reference's ``loss_fn`` cannot run its Pallas path under ``jax.grad``:
its layer loop is a ``lax.scan``, and the ``custom_vjp`` around
``_delta_apply_pallas`` (as around ``_fused_linear_pallas``) takes
``interpret`` as a traced argument, which ``pallas_call`` rejects under
jax 0.9. So :func:`unrolled_loss` calls the reference's own block, head and
loss functions in a Python loop over the layers, the aux loss included;
nothing in the reference changes.
"""

import jax
import jax.numpy as jnp
import numpy as np

from repro.core.delta import Delta as JDelta
from repro.core.adapt import zip_adapters as j_zip
from repro.data import peek_batch as j_peek
from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from test_torch_moe_train import assert_grads_close, make_world, port_loss_and_grads

IS_LEAF = lambda x: x is None or isinstance(x, JDelta)  # noqa: E731


def unrolled_loss(cfg, params, adapters, batch):
    """The reference's ``loss_fn`` with its ``lax.scan`` unrolled."""
    h, positions, mrope = jtr._embed_inputs(cfg, params, batch)
    blocks, a_blocks = jtr._split_blocks(params, adapters)
    aux = 0.0
    for i in range(cfg.num_layers):
        p = jax.tree.map(lambda x: x[i], blocks)
        a = jax.tree.map(lambda d: None if d is None else JDelta(d.idx[i], d.val[i]),
                         a_blocks, is_leaf=IS_LEAF)
        h, aux_l = jtr._block_train(cfg, h, p, a, positions, mrope)
        aux = aux + aux_l
    h = jlayers.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = jtr._head_logits(cfg, params, adapters, h)
    ce = jlayers.softmax_cross_entropy(logits[:, :-1], batch["targets"][:, 1:],
                                       batch.get("loss_mask"), real_vocab=cfg.vocab_size)
    return ce + cfg.router_aux_coef * aux / cfg.num_layers


def test_loss_and_value_gradients_match_reference_pallas_interpret():
    w = make_world(num_layers=1)
    batch = j_peek("reasoning", w["cfg"].vocab_size, 2, 16, seed=4)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    with jops.use_backend("pallas_interpret"):
        jloss, jg = jax.value_and_grad(
            lambda v: unrolled_loss(w["cfg"], w["jp"], j_zip(w["idx"], v), jb))(w["val"])
    loss, _, grads = port_loss_and_grads(w, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-5)
    assert_grads_close(grads, jg)
