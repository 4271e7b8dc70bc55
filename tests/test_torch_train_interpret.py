"""The port's training loss and value gradients against the reference's
Pallas kernels (``fused_linear_pallas``, ``sparse_delta_dval_pallas``) in
interpret mode, on the CPU.

Reduced qwen2-1.5b cut to one layer (the interpret-mode reference runs
eagerly, ~15 s a layer; the two-layer stack is held against the jnp
backend in ``test_torch_train.py``), its params converted leaf by leaf: in
fp32 the loss within 1e-5 and every adapted matrix's ``dval`` within rtol
1e-4; in bf16 both within 2e-2 (the reference's jnp path sums the bypass
in bf16, its kernels and the port in f32, so bf16 is held against the
kernels only).

The reference's ``loss_fn`` cannot run its Pallas path under
``jax.grad``: its layer loop is a ``lax.scan``, and the ``custom_vjp``
around ``fused_linear_pallas`` takes ``interpret`` as a traced argument,
which ``pallas_call`` rejects under jax 0.9. So :func:`unrolled_loss`
calls the reference's own block, head and loss functions in a Python loop
over the layers; nothing in the reference changes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core.adapt import init_adapters as j_init_adapters
from repro.core.adapt import zip_adapters as j_zip
from repro.core.delta import Delta as JDelta
from repro.data import peek_batch as j_peek
from repro.kernels import ops as jops
from repro.models import get_model as j_get_model
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import to_numpy, tree_to_torch
from repro_torch.core.adapt import zip_adapters
from repro_torch.kernels import COUNTERS, TRAINING, reset_counters
from repro_torch.models import get_model
from repro_torch.tree import flatten, map_leaves

torch.set_num_threads(2)
IS_LEAF = lambda x: x is None or isinstance(x, JDelta)  # noqa: E731
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}  # (loss, dval)


def np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree,
                        is_leaf=lambda x: x is None)


def unrolled_loss(cfg, params, adapters, batch):
    """The reference's ``loss_fn`` with its ``lax.scan`` unrolled."""
    h, positions, mrope = jtr._embed_inputs(cfg, params, batch)
    blocks, a_blocks = jtr._split_blocks(params, adapters)
    for i in range(cfg.num_layers):
        p = jax.tree.map(lambda x: x[i], blocks)
        a = jax.tree.map(lambda d: None if d is None else JDelta(d.idx[i], d.val[i]),
                         a_blocks, is_leaf=IS_LEAF)
        h, _ = jtr._block_train(cfg, h, p, a, positions, mrope)
    h = jlayers.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = jtr._head_logits(cfg, params, adapters, h)
    return jlayers.softmax_cross_entropy(logits[:, :-1], batch["targets"][:, 1:],
                                         batch.get("loss_mask"), real_vocab=cfg.vocab_size)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_value_gradients_match_reference_pallas_interpret(dtype):
    cfg = reduced(get_config("qwen2-1.5b")).replace(dtype=dtype, num_layers=1)
    jparams = j_get_model(cfg).init(jax.random.PRNGKey(1))
    idx, val = j_init_adapters(jparams, 2)
    rng = np.random.default_rng(11)
    val = jax.tree.map(lambda v: None if v is None else
                       jnp.asarray(0.05 * rng.standard_normal(v.shape), dtype),
                       val, is_leaf=lambda x: x is None)
    batch = j_peek("reasoning", cfg.vocab_size, 2, 16, seed=4)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    with jops.use_backend("pallas_interpret"):
        jloss, jg = jax.value_and_grad(
            lambda v: unrolled_loss(cfg, jparams, j_zip(idx, v), jb))(val)

    model = get_model(t_reduced(t_get_config("qwen2-1.5b")).replace(dtype=dtype, num_layers=1))
    tv = map_leaves(lambda v: None if v is None else v.requires_grad_(),
                    tree_to_torch(np_tree(val)))
    reset_counters()
    loss, _ = model.loss(tree_to_torch(np_tree(jparams)),
                         zip_adapters(tree_to_torch(np_tree(idx)), tv),
                         {k: torch.from_numpy(x) for k, x in batch.items()})
    loss.backward()
    # every projection, forward and value gradient, went through the
    # kernels' plain versions (CPU tensors)
    assert [COUNTERS[n].plain for n in TRAINING] == [7, 7]
    tol_loss, tol_dval = TOL[dtype]
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=tol_loss,
                               atol=tol_loss)
    want = dict(flatten(np_tree(jg)))
    n = 0
    for path, v in flatten(tv):
        if v is None:
            continue
        assert v.grad.dtype == v.dtype
        w = np.asarray(want[path], np.float32)
        np.testing.assert_allclose(to_numpy(v.grad), w, rtol=tol_dval,
                                   atol=tol_dval * np.abs(w).max(), err_msg=str(path))
        n += 1
    assert n == 7
