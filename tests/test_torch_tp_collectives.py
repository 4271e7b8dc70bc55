"""The port's collectives and gradient compression against the reference.

``quantize``, ``dequantize``, ``ef_int8`` (three steps of error-feedback
residuals) and ``collective_bytes_saved`` against
``repro.distributed.collectives`` on the same numpy inputs (1e-6); the
tensor-parallel collectives (``tp_all_reduce``, ``tp_all_gather``, the
control record's broadcast) over 2 and 4 spawned CPU ranks (gloo, a
``file://`` rendezvous in a temporary directory), every case of one tp in
one spawn; a rank that dies fails the run within the groups' timeout;
and a ``Trainer`` whose ``grad_transform`` is the int8 transform
taking three steps equal to the reference's ``Trainer(grad_transform=)``.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PeftConfig as JPeftConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config, reduced
from repro.data.synthetic import TASKS as J_TASKS
from repro.distributed import collectives as jcol
from repro.models import get_model as j_get_model
from repro.peft import get_peft as j_get_peft
from repro.train import Trainer as JTrainer
from repro_torch.configs import PeftConfig, TrainConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import tree_to_torch
from repro_torch.distributed import collectives as col
from repro_torch.models import get_model
from repro_torch.peft import get_peft
from repro_torch.train import Trainer
from repro_torch.tree import flatten, map_leaves

torch.set_num_threads(2)
NONE = lambda x: x is None  # noqa: E731


def np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree, is_leaf=NONE)


def j_tree(tree):
    return jax.tree.map(lambda x: None if x is None else jnp.asarray(x), tree, is_leaf=NONE)


def t_tree(tree):
    return map_leaves(lambda x: None if x is None else torch.from_numpy(np.array(x)), tree)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0])
def test_quantize_and_dequantize_match_reference(scale):
    x = (scale * np.random.default_rng(0).standard_normal((37, 5))).astype(np.float32)
    jq, js = jcol.quantize(jnp.asarray(x))
    q, s = col.quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(s), float(js), rtol=1e-6)
    np.testing.assert_allclose(col.dequantize(q, s).numpy(), np.asarray(jcol.dequantize(jq, js)),
                               rtol=1e-6, atol=1e-6 * max(scale, 1e-12))


def test_ef_int8_three_steps_match_reference():
    """Three steps of one gradient tree (with a None leaf) through both
    transforms: the sent gradients and the residuals agree to 1e-6."""
    rng = np.random.default_rng(1)
    grads = [{"a": {"w": (rng.standard_normal((6, 4)) * 10.0 ** -i).astype(np.float32),
                    "b": None},
              "c": rng.standard_normal((9,)).astype(np.float32)} for i in range(3)]
    jinit, japply = jcol.ef_int8()
    init, apply = col.ef_int8()
    jstate = jinit(j_tree(grads[0]))
    state = init(t_tree(grads[0]))
    for i, g in enumerate(grads):
        jout, jstate = japply(j_tree(g), jstate)
        out, state = apply(t_tree(g), state)
        for what, mine, theirs in (("out", out, jout), ("residual", state.residual,
                                                         jstate.residual)):
            want = dict(flatten(np_tree(theirs)))  # (jax orders dict keys)
            for path, a in flatten(mine):
                assert (a is None) == (want[path] is None), path
                if a is not None:
                    np.testing.assert_allclose(a.numpy(), want[path], rtol=1e-6, atol=1e-6,
                                               err_msg=f"{what} step {i} {path}")


@pytest.mark.parametrize("k,d_in", [(1, 5120), (2, 1536), (8, 8960)])
def test_collective_bytes_saved_matches_reference(k, d_in):
    assert col.collective_bytes_saved(k, d_in) == jcol.collective_bytes_saved(k, d_in)


def collectives_rank(rank, tp, init_method):
    """Every collective of one rank of a CPU group: its inputs come from a
    seed of its own, so the parent can form the expected results."""
    group = col.init_tp(rank, tp, "cpu", init_method, timeout=60)
    try:
        x = torch.from_numpy(np.random.default_rng(rank).standard_normal((3, 5)).astype(
            np.float32))
        reduced_x = col.tp_all_reduce(x.clone(), group)
        last = col.tp_all_gather(x, group, -1)
        first = col.tp_all_gather(x, group, 0)
        record = col.broadcast_record({"now": 1.5, "ops": [("cancel", 3)]} if group.leader
                                      else None, group)
        return {"sum": reduced_x.numpy(), "last": last.numpy(), "first": first.numpy(),
                "record": record, "backend": group.backend}
    finally:
        col.close_tp()


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_collectives_on_cpu_ranks(tp):
    outs = col.run_ranks(collectives_rank, tp, timeout=120)
    xs = [np.random.default_rng(r).standard_normal((3, 5)).astype(np.float32) for r in range(tp)]
    for rank, out in enumerate(outs):
        assert out["backend"] == "gloo"
        np.testing.assert_allclose(out["sum"], np.sum(xs, axis=0), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(out["last"], np.concatenate(xs, -1))
        np.testing.assert_array_equal(out["first"], np.concatenate(xs, 0))
        assert out["record"] == {"now": 1.5, "ops": [("cancel", 3)]}
        # every rank holds the same bits of the sum
        np.testing.assert_array_equal(out["sum"], outs[0]["sum"])


def dying_rank(rank, tp, init_method):
    """Rank 1 exits after joining; rank 0's next collective must fail."""
    group = col.init_tp(rank, tp, "cpu", init_method, timeout=20)
    if rank == 1:
        os._exit(3)
    try:
        col.tp_all_reduce(torch.ones(4), group)
    finally:
        col.close_tp()


def test_a_dead_rank_fails_the_run_instead_of_hanging_it():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank"):
        col.run_ranks(dying_rank, 2, timeout=60)
    assert time.monotonic() - t0 < 60


def test_trainer_with_int8_grad_transform_matches_reference():
    """Three steps of both Trainers with ``grad_transform`` = one int8
    round trip of the gradients (``ef_int8``'s apply from a zero residual,
    the stateless form a jitted step can carry): loss, gradient norm and the
    trained values agree."""
    cfg = reduced(get_config("qwen2-1.5b")).replace(dtype="float32")
    jm = j_get_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = get_model(t_reduced(t_get_config("qwen2-1.5b")).replace(dtype="float32"))
    tp = tree_to_torch(np_tree(jp))
    jinit, japply = jcol.ef_int8()
    init, apply = col.ef_int8()
    jt = JTrainer(jm, j_get_peft(JPeftConfig(k=1, delta_dtype="float32")),
                  JTrainConfig(steps=3), jp, grad_transform=lambda g: japply(g, jinit(g))[0])
    tt = Trainer(tm, get_peft(PeftConfig(k=1, delta_dtype="float32")), TrainConfig(steps=3), tp,
                 grad_transform=lambda g: apply(g, init(g))[0])
    batches = [J_TASKS["reasoning"](cfg.vocab_size, 4, 16, 0, i) for i in range(3)]
    jh = jt.run(iter(batches), 3)
    th = tt.run(iter(batches), 3)
    for i, (a, b) in enumerate(zip(th, jh)):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i} {key}")
        assert a["skipped"] == b["skipped"] == 0
    want = dict(flatten(np_tree(jt.state.trainable)))
    for path, v in flatten(tt.state.trainable):
        if v is not None:
            np.testing.assert_allclose(v.numpy(), want[path], rtol=1e-5, atol=1e-4 * 3e-3,
                                       err_msg=str(path))
