"""The training driver: one NeuroAda trainer, driven from the seed through
its first steps (the ones the reference follows), then through the
measured window, on batches made before it.

Set-up builds the weights, the trainer (selection included) and every
batch, and runs the checked steps through ``Trainer.step``, the window's
own call: they warm every shape the window uses. The window then runs
whole steps until ``seconds`` have passed; each ends in the trainer's host
read of its metrics, so it has finished on the device.
"""

from __future__ import annotations

import time

from . import traffic, weights
from .program import trainer as make_trainer
from .run_record import RunRecord, free, peak_bytes, sync


def _norms(arch, tree, paths, scale: float = 1.0) -> dict:
    """{leaf: norm} of a program tree, one leaf a layer's matrix."""
    out = {}
    for p in paths:
        t = weights.get(tree, p).float()
        if p[0] == "blocks":
            for i in range(t.shape[0]):
                out[f"{'/'.join(p)}[{i}]"] = float(t[i].norm()) * scale
        else:
            out["/".join(p)] = float(t.norm()) * scale
    return out


def run(arch, mix: dict, seed: int, seconds: float, trace, t_start: float, device):
    checked = mix["checked_steps"]
    params = weights.make_params(arch, seed, device)
    tr = make_trainer(arch, mix, params, seed)
    n = checked + int(seconds * mix["max_steps_per_s"]) + 1
    batches = traffic.train_batches(mix, arch.vocab, seed, n)
    paths = weights.adapted(arch)
    b1 = mix["optimizer"]["b1"]
    got = {"losses": []}
    for t in range(checked):
        got["losses"].append(tr.step(batches[t])["loss"])
        if t == 0:  # the optimizer's first moment holds (1 - b1) x the clipped gradient
            got["grad"] = _norms(arch, tr.state.opt_state.mu, paths, 1.0 / (1.0 - b1))
    got["change"] = _norms(arch, tr.state.trainable, paths)
    got["indices"] = {p: weights.get(tr.aux, p).clone() for p in paths}
    sync(device)
    if trace is not None:
        trace.start()
    setup_s = time.perf_counter() - t_start
    step_s, skipped, i = [], 0, checked
    t_open = time.perf_counter()
    while True:
        if i >= len(batches):
            raise RuntimeError(f"the window outran its {len(batches)} batches: raise "
                               "max_steps_per_s in the mix")
        t0 = time.perf_counter()
        if trace is None:
            m = tr.step(batches[i])
        else:
            with trace.span("Trainer.step"):
                m = tr.step(batches[i])
        t1 = time.perf_counter()
        step_s.append(t1 - t0)
        skipped += int(m["skipped"])
        i += 1
        if t1 - t_open >= seconds:
            break
    window_s = t1 - t_open
    peak = peak_bytes(device)
    if trace is not None:
        trace.stop()
    del tr, m
    free(device)
    tokens = len(step_s) * mix["batch"] * mix["seq"]
    rec = RunRecord(kind="train", arch=arch, mix=mix, seed=seed, window=(t_open, t1),
                    window_s=window_s, setup_s=setup_s, peak_bytes=peak, trace=trace)
    rec.step_s = step_s
    rec.attempted, rec.failed = len(step_s), skipped
    rec.end_to_end = {"train_tok_s": tokens / window_s,
                      "train_peak_gib": peak / 2**30, "setup_s": setup_s}
    if trace is not None:
        rec.train = {"unique": weights.unique_rows(got["indices"], mix["peft"]["k"], arch)}
    rec.program = got
    rec.inputs = {"params": params, "batches": batches[:checked]}
    return rec
