"""Trainer: the train step with microbatch accumulation, activation
recomputation (``tcfg.remat``) and the NaN guard, and the loop around it
with asynchronous checkpoints and resume (port of ``repro.train.trainer``).

The step is method-agnostic: it differentiates only the ``trainable`` tree
(for NeuroAda the ``(…, k, d_out)`` bypass values — the paper's memory
story follows from this). Frozen params never have ``requires_grad``, so
autograd forms no dense weight gradient and the optimizer keeps no dense
state — unless the method's trainable tree is itself dense (``masked``,
``full``). For those the step lets go of each dense tree as soon as the
next one no longer needs it, and the NaN guard's select writes into the
new tensors, so a step holds one new copy of the trainables and moments
beside the old, never two.

Given a :class:`repro_torch.obs.Tracer` (or, with none, while a torch
profiler records: :func:`repro_torch.obs.trace.profiled`), each step runs
in the regions ``train.step`` > ``train.upload``, ``train.forward`` and
``train.backward`` (once per microbatch), ``train.optimizer``,
``train.read``, with the MoE layers' ``moe.dispatch`` / ``moe.combine``
under ``train.forward``. The children cover the step but, with
microbatches, the float32 accumulation between them. Without a tracer the
step pays one ``is None`` test a site: no event, no device operation.
"""

from __future__ import annotations

import logging
from typing import Any, NamedTuple

import torch

from repro_torch.checkpoint import CheckpointManager, restore_into
from repro_torch.distributed.fault import NanGuard, StragglerMonitor
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import adamw, apply_updates, clip_by_global_norm, get_schedule, global_norm
from repro_torch.tree import flatten, map_leaves

log = logging.getLogger("repro_torch.train")

_AXIS1_KEYS = ("positions", "mrope_pos")  # batch dim is axis 1


class TrainState(NamedTuple):
    trainable: Any
    opt_state: Any
    step: torch.Tensor


def _select(cond, new, old):
    """``new`` where ``cond`` else ``old``, leaf by leaf over dicts and
    named tuples (``None`` stays ``None``), written into ``new``'s tensors
    (fresh results of this step, never aliases of ``old``)."""
    if new is None:
        return None
    if isinstance(new, dict):
        return {k: _select(cond, new[k], old[k]) for k in new}
    if isinstance(new, tuple):
        return type(new)(*(_select(cond, a, b) for a, b in zip(new, old)))
    return torch.where(cond, new, old, out=new)


def _slice_mb(key: str, x, i: int, m: int):
    if not isinstance(x, torch.Tensor) or x.ndim == 0:
        return x
    axis = 1 if key in _AXIS1_KEYS else 0
    b = x.shape[axis] // m
    return x.narrow(axis, i * b, b)


def make_train_step(model, peft, tcfg, *, grad_transform=None):
    """Returns ``(step(params, aux, state, batch) -> (state, metrics),
    optimizer)``: AdamW on ``tcfg``'s schedule. ``metrics`` holds tensors:
    ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``skipped`` (1 when a
    non-finite loss or gradient kept the old state). ``tcfg.remat``
    (``none``, ``full``, ``dots``) recomputes each layer in the backward
    (see :func:`repro_torch.models.transformer.forward_train`).
    ``grad_transform(grads) -> grads`` runs on the gradients after the
    method's ``post_grad`` and before clipping, as in the reference (e.g.
    int8 compression: :func:`repro_torch.distributed.collectives.ef_int8`).
    ``step(..., tracer=)`` records the step's forward, backward and
    optimizer regions (see the module's docstring)."""
    schedule = get_schedule(tcfg.schedule, tcfg.learning_rate, tcfg.steps, tcfg.warmup_ratio)
    optimizer = adamw(schedule, b1=tcfg.beta1, b2=tcfg.beta2, eps=tcfg.eps,
                      weight_decay=tcfg.weight_decay)

    def value_and_grad(params, trainable, aux, batch, tracer):
        with obs_trace.region(tracer, "train.forward"):
            live = map_leaves(lambda v: None if v is None else v.detach().requires_grad_(),
                              trainable)
            leaves = [v for _, v in flatten(live) if v is not None]
            eff, adapters = peft.model_inputs(params, live, aux)
            loss, metrics = model.loss(eff, adapters, batch, remat=tcfg.remat)
        with obs_trace.region(tracer, "train.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            it = iter(torch.zeros_like(v) if g is None else g for v, g in zip(leaves, grads))
            grads = map_leaves(lambda v: None if v is None else next(it), live)
            return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def grads_of(params, trainable, aux, batch, tracer):
        m = tcfg.microbatches
        if m <= 1:
            return value_and_grad(params, trainable, aux, batch, tracer)
        # gradient accumulation over microbatch slices, in float32
        dev = batch["tokens"].device
        zero = lambda: torch.zeros((), dtype=torch.float32, device=dev)  # noqa: E731
        acc_loss, acc_metrics = zero(), {"ce": zero(), "aux": zero()}
        acc_grads = map_leaves(
            lambda t: None if t is None else torch.zeros(t.shape, dtype=torch.float32,
                                                         device=t.device), trainable)
        for i in range(m):
            mb = {k: _slice_mb(k, x, i, m) for k, x in batch.items()}
            loss, metrics, grads = value_and_grad(params, trainable, aux, mb, tracer)
            acc_grads = map_leaves(lambda a, g: None if a is None else a + g.float() / m,
                                   acc_grads, grads)
            acc_metrics = {k: acc_metrics[k] + metrics[k] / m for k in acc_metrics}
            acc_loss = acc_loss + loss / m
        grads = map_leaves(lambda t, g: None if t is None else g.to(t.dtype),
                           trainable, acc_grads)
        return acc_loss, acc_metrics, grads

    def train_step(params, aux, state: TrainState, batch, tracer=None):
        loss, metrics, grads = grads_of(params, state.trainable, aux, batch, tracer)
        with obs_trace.region(tracer, "train.optimizer"):
            grads = peft.post_grad(grads, aux)
            if grad_transform is not None:
                grads = grad_transform(grads)
            if tcfg.grad_clip > 0:
                grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
            else:
                gnorm = global_norm(grads)
            good = torch.isfinite(loss) & torch.isfinite(gnorm)
            updates, new_opt = optimizer.update(grads, state.opt_state, state.trainable)
            del grads
            new_trainable = apply_updates(state.trainable, updates)
            del updates
            # NaN guard: keep the old state on a bad step (the step still advances)
            new_trainable = _select(good, new_trainable, state.trainable)
            new_opt = _select(good, new_opt, state.opt_state)
            out = dict(metrics)
            out.update(loss=loss, grad_norm=gnorm, skipped=(~good).to(torch.int32))
            return TrainState(new_trainable, new_opt, state.step + 1), out

    return train_step, optimizer


class Trainer:
    """The loop: data, the step, checkpoints and resume, the straggler
    monitor and the NaN guard. Runs wherever ``params`` live; batches
    (numpy) move there each step. ``rng`` (a ``torch.Generator``; by
    default one on the params' device seeded from ``tcfg.seed``) goes to
    ``peft.init`` (LoRA's ``A``, the ``random`` strategy). With
    ``tcfg.checkpoint_dir`` the trainable values and the optimizer state are
    saved every ``checkpoint_every`` steps and at the end of :meth:`run`,
    and :meth:`try_resume` picks up the latest save (either package's). The
    initial trees live only in ``state``: no dense copy outlives its step.
    ``grad_transform`` goes to :func:`make_train_step`; ``tracer`` (a
    :class:`repro_torch.obs.Tracer`) records every step's regions."""

    def __init__(self, model, peft, tcfg, params, *, rng=None, grad_transform=None,
                 tracer=None):
        self.model, self.peft, self.tcfg = model, peft, tcfg
        self.tracer = tracer
        self.params = params
        self.device = next(x for _, x in flatten(params) if x is not None).device
        if rng is None:
            rng = torch.Generator(device=self.device).manual_seed(tcfg.seed)
        trainable, self.aux = peft.init(params, rng)
        self._step_fn, self.optimizer = make_train_step(model, peft, tcfg,
                                                        grad_transform=grad_transform)
        self.state = TrainState(trainable, self.optimizer.init(trainable),
                                torch.zeros((), dtype=torch.int32, device=self.device))
        self.ckpt = CheckpointManager(tcfg.checkpoint_dir) if tcfg.checkpoint_dir else None
        self.monitor = StragglerMonitor()
        self.nan_guard = NanGuard(tcfg.max_skipped_steps)
        self.history: list[dict] = []

    def try_resume(self) -> int:
        """Restore the latest checkpoint onto the trainer's device, in the
        template's dtypes; returns its step (0 without one)."""
        if self.ckpt is None:
            return 0
        step, tree = self.ckpt.restore_latest()
        if step is None:
            return 0
        trainable = restore_into(self.state.trainable, tree["trainable"])
        opt = restore_into(self.state.opt_state, tree["opt_state"])
        self.state = TrainState(trainable, opt,
                                torch.full((), step, dtype=torch.int32, device=self.device))
        log.info("resumed from step %d", step)
        return step

    def save(self, step: int) -> None:
        """Checkpoint the trainable values and the optimizer state at
        ``step`` (the copy to the host now, the write in the background)."""
        self.ckpt.save(step, {"trainable": self.state.trainable,
                              "opt_state": self.state.opt_state},
                       metadata={"peft": self.peft.method})

    def step(self, batch: dict) -> dict:
        """One train step on a numpy batch; returns its metrics as floats
        (which waits for the device)."""
        tr = self.tracer if self.tracer is not None else obs_trace.profiled(self.device)
        with obs_trace.region(tr, "train.step"):
            with obs_trace.region(tr, "train.upload"):
                batch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
            self.state, metrics = self._step_fn(self.params, self.aux, self.state, batch,
                                                tracer=tr)
            with obs_trace.region(tr, "train.read"):
                return {k: float(v) for k, v in metrics.items()}

    def run(self, data_iter, steps: int | None = None) -> list[dict]:
        steps = steps if steps is not None else self.tcfg.steps
        for i in range(int(self.state.step), steps):
            batch = next(data_iter)
            self.monitor.start()
            metrics = self.step(batch)
            slow = self.monitor.stop(i)
            self.nan_guard.record(bool(metrics["skipped"]))
            metrics["step"] = i
            metrics["straggler"] = slow
            self.history.append(metrics)
            if self.tcfg.log_every and i % self.tcfg.log_every == 0:
                log.info("step %d loss %.4f gnorm %.3f%s", i, metrics["loss"],
                         metrics["grad_norm"], " [STRAGGLER]" if slow else "")
            if (self.ckpt is not None and self.tcfg.checkpoint_every
                    and (i + 1) % self.tcfg.checkpoint_every == 0):
                self.save(i + 1)
        if self.ckpt is not None:
            self.save(steps)
            self.ckpt.wait()
        return self.history

    def merged_params(self):
        """Alg. 1 phase 3: the base with every delta folded in."""
        return self.peft.merge(self.params, self.state.trainable, self.aux)
