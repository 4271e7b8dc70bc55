"""PyTorch + CUDA port of the NeuroAda system in :mod:`repro`.

The JAX package ``repro`` stays the reference; this package mirrors its
module names (``configs``, ``core``, ``kernels``, ``models``, ``serve``,
``launch``) so each counterpart is easy to find. It imports ``torch`` and
numpy only — never ``jax`` and nothing of ``repro``: the torch-free
modules it needs (configs, the clock, the scheduler) are its own copies.

Importing the package does nothing heavy: kernels are compiled on first
use on a CUDA device (``repro_torch.kernels.build``).
"""
