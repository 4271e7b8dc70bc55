"""The examples of the port, twins of the reference's ``examples/``:

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--base-dtype int8]
  PYTHONPATH=src python -m repro_torch.examples.finetune_e2e [--steps 300]
  PYTHONPATH=src python -m repro_torch.examples.peft_comparison [--steps 150]
  PYTHONPATH=src python -m repro_torch.examples.serve_batched

Each runs on the card and raises without one, unless ``--device cpu`` is
given (the plain PyTorch versions of the kernels). Each factors its body
into ``run(...) -> dict`` (every number it prints) and ``main(argv=None)``.
"""
