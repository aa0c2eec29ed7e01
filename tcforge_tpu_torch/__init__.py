"""tcforge_tpu_torch — the PyTorch/CUDA port of tcforge_tpu.

The JAX package ``tcforge_tpu`` is the reference; this package runs the
same chains on an NVIDIA Hopper card and is held against it bit for bit.
Its layout mirrors the JAX package (``core/``, ``ops/``,
``modules/filters/``, ``pipeline/``, ``io/``).  Plain tensor code is
PyTorch; every kernel that the JAX package wrote in Pallas is a CUDA C++
kernel under ``csrc/``, built with ``nvcc`` at first use
(``ops/_build.py``).

Rule: nothing in this package imports ``jax`` or ``tcforge_tpu``
(``tests/test_torch_core.py`` checks it), so it runs where JAX is absent.
"""

__version__ = "0.1.0"
