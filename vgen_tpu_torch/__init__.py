"""vgen-tpu-torch: the vanity-address scan on an NVIDIA GPU (PyTorch + CUDA).

A port of ``vgen_tpu`` (JAX on a TPU), which stays beside it as the
reference.  The port keeps its own copies of the host-only pieces, in the
JAX package's layout: the crypto oracle (``crypto/``), patterns and their
intervals (``pattern/``), the native C++ scanner (``native/``), output,
providers, checkpoints, the host scan types (``scan/host.py``), the table
builders (``scan/tables.py``) and the CLI helpers.  What ran on the TPU is
re-written here: plain PyTorch versions in ``ops/`` and hand-written CUDA
kernels in ``csrc/``.

This package imports ``torch`` and never ``jax``, nor anything of
``vgen_tpu``.
"""

__version__ = "0.1.0"
