"""The port's training path against the JAX reference, on the CPU.

Reduced qwen2-1.5b in fp32, the reference's random params converted leaf
by leaf: ``Model.loss`` and the gradient of every adapted matrix's values
against ``jax.value_and_grad`` of the reference's ``loss_fn`` on its jnp
backend (loss 1e-5, dval rtol 1e-4: the same f32 sums in another order);
three train steps against the reference's ``make_train_step`` with one
and two microbatches; the data loaders; the launcher; the trainer's step
regions (a tracer changes no bit; none without one). The Pallas
(interpret-mode) reference is in ``test_torch_train_interpret.py``.
"""

import json

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
from repro.data import DataLoader as JLoader
from repro.data import peek_batch as j_peek
from repro.data.synthetic import TASKS as J_TASKS
from repro.models import get_model as j_get_model
from repro.peft import get_peft as j_get_peft
from repro.train import TrainState as JState
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import PeftConfig, TrainConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import tree_to_torch
from repro_torch.core.adapt import zip_adapters
from repro_torch.data import TASKS, DataLoader, peek_batch
from repro_torch.kernels import COUNTERS, reset_counters
from repro_torch.launch import train as launch
from repro_torch import obs as tobs
from repro_torch.models import get_model
from repro_torch.obs import trace as ttrace
from repro_torch.optim import adamw, get_schedule
from repro_torch.peft import get_peft, stats
from repro_torch.train import Trainer, TrainState, make_train_step
from repro_torch.tree import flatten, map_leaves

torch.set_num_threads(2)
NONE = lambda x: x is None  # noqa: E731


def np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree, is_leaf=NONE)


@pytest.fixture(scope="module")
def world():
    cfg = reduced(get_config("qwen2-1.5b")).replace(dtype="float32")
    jm = j_get_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = get_model(t_reduced(t_get_config("qwen2-1.5b")).replace(dtype="float32"))
    tp = tree_to_torch(np_tree(jp))
    idx, val = j_init_adapters(jp, 2)
    rng = np.random.default_rng(7)
    val = jax.tree.map(lambda v: None if v is None else
                       jnp.asarray(0.05 * rng.standard_normal(v.shape), jnp.float32),
                       val, is_leaf=NONE)
    return {"cfg": cfg, "jm": jm, "jp": jp, "tm": tm, "tp": tp, "idx": idx, "val": val}


def port_loss_and_grads(world, idx, val, batch):
    tv = map_leaves(lambda v: None if v is None else v.requires_grad_(), tree_to_torch(np_tree(val)))
    loss, metrics = world["tm"].loss(world["tp"], zip_adapters(tree_to_torch(np_tree(idx)), tv),
                                     {k: torch.from_numpy(np.asarray(x)) for k, x in batch.items()})
    loss.backward()
    grads = {p: v.grad for p, v in flatten(tv) if v is not None}
    return loss.detach(), metrics, grads


@pytest.mark.parametrize("task", ["lm", "reasoning"])
def test_loss_and_value_gradients_match_reference_jnp(world, task):
    batch = j_peek(task, world["cfg"].vocab_size, 2, 16, seed=3)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    (jloss, jmet), jg = jax.value_and_grad(
        lambda v: world["jm"].loss(world["jp"], j_zip(world["idx"], v), jb), has_aux=True
    )(world["val"])
    loss, metrics, grads = port_loss_and_grads(world, world["idx"], world["val"], batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"].detach()), float(jmet["ce"]), rtol=1e-5, atol=1e-5)
    assert float(metrics["aux"]) == 0.0
    want = dict(flatten(np_tree(jg)))
    assert set(grads) == {p for p, v in want.items() if v is not None}
    assert len(grads) == 7  # every projection of the layer stack
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[path], rtol=1e-4,
                                   atol=1e-4 * np.abs(want[path]).max(), err_msg=str(path))


def test_loss_masks_vocab_padding_and_weights_positions():
    from repro.models.layers import softmax_cross_entropy as j_ce
    from repro_torch.models.layers import softmax_cross_entropy

    rng = np.random.default_rng(8)
    logits = rng.normal(size=(2, 5, 24)).astype(np.float32)
    targets = rng.integers(0, 20, size=(2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.5).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = j_ce(jnp.asarray(logits), jnp.asarray(targets),
                    None if m is None else jnp.asarray(m), real_vocab=20)
        got = softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                                    None if m is None else torch.from_numpy(m), real_vocab=20)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def test_attention_at_the_flash_threshold_raises(world):
    """The threshold no longer raises: at ``Skv >= flash_threshold`` training
    attention dispatches to ``flash_attention`` (one flash forward, which
    agrees with ``dense_attention``), below it to ``dense_attention``; a
    ragged Skv at the threshold raises the reference's ``ValueError``."""
    from repro_torch.models.attention import dense_attention, train_attention

    cfg = world["tm"].cfg.replace(flash_threshold=8, flash_block=4)
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((1, 8, 4, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(np.float32))
            for _ in range(2))
    reset_counters()
    got = train_attention(q, k, v, cfg)
    assert COUNTERS["flash_attention_fwd"].plain == 1
    torch.testing.assert_close(got, dense_attention(q, k, v, causal=True), atol=2e-6, rtol=2e-6)
    assert train_attention(q[:, :7], k[:, :7], v[:, :7], cfg).shape == (1, 7, 4, 16)
    assert COUNTERS["flash_attention_fwd"].plain == 1
    with pytest.raises(ValueError, match="multiple of block"):
        train_attention(q, k, v, cfg.replace(flash_block=3))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_train_steps_match_reference(world, microbatches):
    """Loss, grad_norm and the values after each of three steps against the
    reference's jitted step on its jnp backend. Values in float32 here: in
    bf16 one value that rounds the other way (an update on a rounding
    boundary) moves the next step's gradient norm by ~1e-4, which would hide
    a real fault of the same size."""
    cfg = world["cfg"]
    jpeft = j_get_peft(JPeftConfig(k=1, delta_dtype="float32"))
    jtc = JTrainConfig(steps=3, microbatches=microbatches)
    jstep, jopt = j_make_train_step(world["jm"], jpeft, jtc)
    jstep = jax.jit(jstep)
    jvals, jidx = jpeft.init(world["jp"], jax.random.PRNGKey(0))
    jstate = JState(jvals, jopt.init(jvals), jnp.zeros((), jnp.int32))

    peft = get_peft(PeftConfig(k=1, delta_dtype="float32"))
    tc = TrainConfig(steps=3, microbatches=microbatches)
    step, opt = make_train_step(world["tm"], peft, tc)
    vals, idx = peft.init(world["tp"])
    for (p, a), (_, b) in zip(flatten(idx), flatten(tree_to_torch(np_tree(jidx)))):
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), p
    state = TrainState(vals, opt.init(vals), torch.zeros((), dtype=torch.int32))
    for i in range(3):
        batch = J_TASKS["reasoning"](cfg.vocab_size, 4, 16, 0, i)
        jstate, jm = jstep(world["jp"], jidx, jstate, {k: jnp.asarray(x) for k, x in batch.items()})
        state, m = step(world["tp"], idx, state,
                        {k: torch.from_numpy(x) for k, x in batch.items()})
        for key in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i} {key}")
        assert int(m["skipped"]) == int(jm["skipped"]) == 0
        want = dict(flatten(np_tree(jstate.trainable)))
        for path, v in flatten(state.trainable):
            if v is None:
                continue
            assert v.dtype == torch.float32
            # atol 1e-4 x lr: Adam normalises each gradient by its own
            # history, so a value whose gradients nearly cancel amplifies
            # the two packages' f32 summation-order difference
            np.testing.assert_allclose(v.numpy(), want[path], rtol=1e-5, atol=1e-4 * tc.learning_rate,
                                       err_msg=f"step {i} {path}")
    assert int(state.step) == int(jstate.step) == 3


def test_nan_guard_keeps_the_old_state(world):
    peft = get_peft(PeftConfig(k=1, delta_dtype="float32"))
    step, opt = make_train_step(world["tm"], peft, TrainConfig(steps=2))
    vals, idx = peft.init(world["tp"])
    state = TrainState(vals, opt.init(vals), torch.zeros((), dtype=torch.int32))
    batch = {k: torch.from_numpy(x) for k, x in peek_batch("lm", 512, 2, 8).items()}
    bad = dict(world["tp"], final_norm=torch.full_like(world["tp"]["final_norm"], float("nan")))
    new, m = step(bad, idx, state, batch)
    assert int(m["skipped"]) == 1 and int(new.step) == 1
    assert int(new.opt_state.step) == 0
    for (_, a), (_, b) in zip(flatten(new.trainable), flatten(vals)):
        assert a is None or torch.equal(a, b)
    new, m = step(world["tp"], idx, new, batch)
    assert int(m["skipped"]) == 0 and int(new.opt_state.step) == 1


def test_schedules_and_adamw_follow_the_reference():
    from repro.optim import adamw as j_adamw
    from repro.optim import get_schedule as j_get_schedule

    for name in ("linear", "cosine", "constant"):
        js, ts = j_get_schedule(name, 3e-3, 20, 0.1), get_schedule(name, 3e-3, 20, 0.1)
        for s in (0, 1, 2, 7, 19, 20, 25):
            assert float(ts(torch.tensor(s, dtype=torch.int32))) == float(js(jnp.int32(s)))
    rng = np.random.default_rng(9)
    p0 = rng.normal(size=(3, 5)).astype(np.float32)
    jo, to = j_adamw(1e-2, weight_decay=0.1), adamw(1e-2, weight_decay=0.1)
    jp, tp = {"a": jnp.asarray(p0), "b": None}, {"a": torch.from_numpy(p0), "b": None}
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(3):
        g = rng.normal(size=(3, 5)).astype(np.float32)
        ju, js = jo.update({"a": jnp.asarray(g), "b": None}, js, jp)
        tu, ts = to.update({"a": torch.from_numpy(g), "b": None}, ts, tp)
        jp = {"a": jp["a"] + ju["a"], "b": None}
        tp = {"a": tp["a"] + tu["a"], "b": None}
        np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]), rtol=1e-6, atol=1e-7)
    assert tu["b"] is None and int(ts.step) == 3


@pytest.mark.parametrize("task", ["lm", "reasoning", "arithmetic"])
def test_data_loaders_give_the_reference_batches(task):
    jl = JLoader(task, 512, 4, 24, seed=5, host_id=1, host_count=2, start_step=2)
    tl = DataLoader(task, 512, 4, 24, seed=5, host_id=1, host_count=2, start_step=2)
    try:
        for _ in range(3):
            a, b = next(jl), next(tl)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    finally:
        jl.close()
        tl.close()
    a, b = j_peek(task, 512, 3, 20, seed=1), peek_batch(task, 512, 3, 20, seed=1)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert set(TASKS) == set(J_TASKS)


def test_trainer_counts_the_papers_trainables(world):
    """k = 1: one value per output neuron of every adapted projection."""
    cfg = world["tm"].cfg
    trainer = Trainer(world["tm"], get_peft(PeftConfig(k=1)), TrainConfig(steps=2),
                      world["tp"])
    st = stats(world["tp"], trainer.state.trainable)
    hd = cfg.resolved_head_dim
    per_layer = (cfg.num_heads * hd + 2 * cfg.num_kv_heads * hd + cfg.d_model
                 + 2 * cfg.d_ff + cfg.d_model)
    assert st["trainable"] == cfg.num_layers * per_layer
    assert st["fraction"] == st["trainable"] / st["total"]
    hist = trainer.run(iter([peek_batch("lm", 512, 2, 8)] * 2))
    assert [h["step"] for h in hist] == [0, 1] and trainer.nan_guard.skipped == 0


STEP_CHILDREN = ["train.upload", "train.forward", "train.backward", "train.optimizer",
                 "train.read"]


def test_a_traced_trainer_trains_bit_identically_and_records_each_step(world):
    """A tracer changes no bit of the trainables or the moments, and each
    step records ``train.step`` with its five children in order."""
    batches = [peek_batch("lm", 512, 2, 8, seed=s) for s in range(2)]
    tracer = tobs.Tracer()
    plain, traced = (Trainer(world["tm"], get_peft(PeftConfig(k=1)), TrainConfig(steps=2),
                             world["tp"], tracer=t) for t in (None, tracer))
    for b in batches:
        assert plain.step(b) == traced.step(b)
    for tree in ("trainable", "opt_state"):
        got = flatten(getattr(traced.state, tree))
        for (p, a), (_, b) in zip(flatten(getattr(plain.state, tree)), got, strict=True):
            assert (a is None and b is None) or torch.equal(a, b), (tree, p)
    roots = [i for i, r in enumerate(tracer.regions) if r.parent is None]
    assert [(tracer.regions[i].name, tracer.regions[i].rid) for i in roots] == [
        ("train.step", 0), ("train.step", 1)]
    for i in roots:
        kids = [r for r in tracer.regions if r.parent == i]
        assert [r.name for r in kids] == STEP_CHILDREN
        assert all(r.rid == tracer.regions[i].rid for r in kids)
        assert tracer.self_seconds(i) < 0.05 * (tracer.regions[i].t1 - tracer.regions[i].t0)
    assert ttrace.current() is None and len(tracer) == 0


def test_an_untraced_step_makes_no_event_and_no_region(world, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("an untraced step made a region or a CUDA event")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(tobs.Tracer, "region", refuse)
    trainer = Trainer(world["tm"], get_peft(PeftConfig(k=1)), TrainConfig(steps=1),
                      world["tp"])
    assert np.isfinite(trainer.step(peek_batch("lm", 512, 2, 8))["loss"])
    assert ttrace.last_profiled() is None and ttrace.current() is None


def test_launcher_writes_the_training_regions(tmp_path):
    out = tmp_path / "t.json"
    hist = launch.main(["--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
                        "--seq", "8", "--trace-out", str(out)])
    assert len(hist) == 2
    ev = json.loads(out.read_text())["traceEvents"]
    host = [e["name"] for e in ev if e["ph"] == "X" and e["tid"] == 0]
    assert host == (["train.step"] + STEP_CHILDREN) * 2


def test_launcher_trains_and_exports_on_the_cpu(tmp_path, caplog):
    from repro.peft import load_adapter as j_load_adapter

    out = tmp_path / "a.npz"
    with caplog.at_level("INFO"):
        hist = launch.main(["--reduced", "--device", "cpu", "--steps", "4", "--batch", "4",
                            "--seq", "16", "--export-adapter", str(out)])
    assert len(hist) == 4 and all(np.isfinite(h["loss"]) for h in hist)
    assert "done: trainable=" in caplog.text and "->" in caplog.text
    idx, val = j_load_adapter(str(out))
    assert val["blocks"]["wq"]["w"].dtype == jnp.bfloat16
    assert idx["blocks"]["wq"]["w"].shape == val["blocks"]["wq"]["w"].shape


def test_launcher_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.main(["--reduced", "--steps", "1"])


@pytest.mark.parametrize("argv", [
    ["--peft", "lora"],
    ["--strategy", "random"],
    ["--peft", "bitfit"],
    ["--peft", "masked"],
    ["--peft", "full"],
    ["--strategy", "reverse"],
    ["--peft", "lora", "--lora-rank", "2", "--base-dtype", "int8"],
    ["--peft", "masked", "--strategy", "reverse", "--k", "3"],
])
def test_launcher_trains_every_method_and_strategy(argv, tmp_path):
    """The methods and strategies the launcher once refused now train a
    step or two on the CPU, and export their merged params."""
    out = tmp_path / "m.npz"
    hist = launch.main(["--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
                        "--seq", "8", "--export", str(out), *argv])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) and h["skipped"] == 0 for h in hist)
    assert out.exists()


@pytest.mark.parametrize("argv,err", [
    (["--strategy", "gradient"], ValueError),  # the launcher forms no |dL/dW|, as the reference's
    (["--peft", "masked", "--base-dtype", "int8"], SystemExit),
    (["--peft", "full", "--base-dtype", "nf4"], SystemExit),
    (["--peft", "lora", "--export-adapter", "a.npz"], SystemExit),
    (["--peft", "bitfit", "--export-adapter", "a.npz"], SystemExit),
    (["--peft", "lora", "--arch", "olmoe-1b-7b"], SystemExit),
    (["--lora-rank", "0"], SystemExit),
    (["--batch", "3", "--microbatches", "2"], SystemExit),
    (["--seq", "1"], SystemExit),
])
def test_launcher_rejects_what_is_not_ported(argv, err):
    with pytest.raises(err, match="requires|--"):
        launch.main(["--reduced", "--device", "cpu", "--steps", "1", *argv])
