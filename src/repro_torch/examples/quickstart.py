"""Quickstart: NeuroAda end to end on the port (twin of the reference's
``examples/quickstart.py``).

Alg. 1 of the paper: (1) offline top-k magnitude selection, (2) sparse
bypass training — only (k, d_out) deltas get gradients/optimizer state,
(3) one-shot merge, then serve the merged model with zero overhead.

The frozen base optionally trains *quantized* — pass ``--base-dtype int8``
(or nf4) and the base drops to packed int8 while the bypass values train
exactly as before (the CLI twin is ``python -m repro_torch.launch.train
--base-dtype int8``).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--base-dtype int8] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import PeftConfig, TrainConfig, get_config, reduced
from repro_torch.data import DataLoader, peek_batch
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.peft import BASE_DTYPES, get_peft, quantize_base, stats
from repro_torch.quant import tree_bytes
from repro_torch.serve import ServeEngine
from repro_torch.train import Trainer

STEPS = 200
PROMPTS = ([1, 17, 25], [1, 40, 41, 42])


def run(cfg, params, *, base_dtype: str = "fp32", steps: int = STEPS, device=None) -> dict:
    """Select, train ``steps`` steps, measure the answer accuracy, merge and
    serve (plain, then int8 self-drafted). ``params`` (dense, on
    ``device``) are ``cfg``'s; returns every number printed."""
    dev = resolve_device(device)
    model = get_model(cfg)
    out = {}
    if base_dtype != "fp32":
        dense_bytes = tree_bytes(params)
        params = quantize_base(params, base_dtype)
        out.update(dense_bytes=dense_bytes, packed_bytes=tree_bytes(params))
        print(f"frozen base -> {base_dtype}: {dense_bytes/2**20:.2f} MB "
              f"-> {out['packed_bytes']/2**20:.2f} MB")

    # --- Phase 1+2: select top-k per neuron, train zero-init bypasses ----
    peft = get_peft(PeftConfig(method="neuroada", k=2, strategy="magnitude"))
    tcfg = TrainConfig(learning_rate=5e-3, steps=steps, log_every=40)
    trainer = Trainer(model, peft, tcfg, params)
    st = stats(params, trainer.state.trainable)
    out.update(trainable=st["trainable"], total=st["total"], fraction=st["fraction"])
    print(f"trainable: {st['trainable']:,} / {st['total']:,} "
          f"({st['fraction']:.3%}) — featherlight ✓")

    data = DataLoader("reasoning", cfg.vocab_size, 32, 32, seed=0)
    try:
        hist = trainer.run(data, steps=steps)
    finally:
        data.close()
    out["losses"] = [h["loss"] for h in hist]
    print(f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")

    # --- accuracy on held-out task data --------------------------------
    test = peek_batch("reasoning", cfg.vocab_size, 128, 32, seed=777)
    eff, adapters = peft.model_inputs(params, trainer.state.trainable, trainer.aux)
    with torch.no_grad():
        logits, _ = model.forward_train(
            eff, adapters, {k: torch.as_tensor(v).to(dev) for k, v in test.items()})
    pp = int(test["answer_pos"][0]) - 1
    pred = logits[:, pp, : cfg.vocab_size].float().argmax(-1).cpu().numpy()
    out["accuracy"] = float(np.mean(pred == test["answer"]))
    print(f"answer accuracy: {out['accuracy']:.1%}")

    # --- Phase 3: merge and serve (zero inference overhead) ------------
    # metrics=True turns on the serving observability layer: counters,
    # gauges and latency histograms derived on the host, with no extra
    # device transfer (CLI twin: serve --metrics-out metrics.prom).
    # kv_dtype="int8" would drop the KV cache to int8 codes + per-page
    # scales (CLI twin: serve --kv-dtype int8); the default keeps the
    # quickstart exact.
    merged = trainer.merged_params()
    engine = ServeEngine(model, merged, slots=2, max_len=64, metrics=True, device=dev)
    for p in PROMPTS:
        engine.submit(p, max_new=8)
    out["outs"] = {}
    for req in engine.run_to_completion():
        out["outs"][req.rid] = list(req.out)
        print(f"request {req.rid}: {req.out}")
    snap = engine.metrics.snapshot()
    out.update(finished=int(snap["serve_requests_finished_total"]["series"][0]["value"]),
               transfers=int(engine.metrics.value("serve_transfers_total")),
               steps=engine.steps,
               ttft_p50_ms=engine.metrics.get("serve_ttft_seconds").quantile(0.5) * 1e3)
    print(f"served {out['finished']} requests in {out['transfers']} engine steps (one "
          f"device-to-host transfer each); ttft p50 {out['ttft_p50_ms']:.1f}ms")

    # --- speculative decoding: an int8 self-draft of the merged model
    # proposes spec_k tokens per round, the full model verifies them in one
    # batched pass — greedy output is token-identical to the plain engine
    # above in float32; in bf16 the verify's chunked attention rounds
    # otherwise than the decode step, so the two may part at a near-tie of
    # the logits (CLI twin: serve --draft int8 --spec-k 4)
    spec = ServeEngine(model, merged, slots=2, max_len=64, decode_chunk=8,
                       draft="int8", spec_k=4, device=dev)
    for p in PROMPTS:
        spec.submit(p, max_new=8)
    out["spec_outs"] = {}
    for req in spec.run_to_completion():
        out["spec_outs"][req.rid] = list(req.out)
        print(f"request {req.rid} (drafted): {req.out}")
    out.update(spec_accepted=spec.spec_accepted, spec_drafted=spec.spec_drafted,
               spec_emitted=spec.spec_emitted, spec_transfers=spec.transfers,
               spec_steps=spec.steps)
    print(f"spec decode: {spec.spec_accepted}/{spec.spec_drafted} drafts "
          f"accepted, {spec.spec_emitted} tokens emitted")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base-dtype", default="fp32", choices=BASE_DTYPES)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = reduced(get_config("qwen2-1.5b"))
    params = get_model(cfg).init(seed=0, device=dev)
    return run(cfg, params, base_dtype=args.base_dtype, device=dev)


if __name__ == "__main__":
    main()
