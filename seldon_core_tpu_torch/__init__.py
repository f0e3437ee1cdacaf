"""PyTorch + CUDA port of seldon-core-tpu, for one NVIDIA H100 (sm_90a).

The JAX package ``seldon_core_tpu`` is the reference this port is held
against.  This package imports ``torch``, numpy and the standard library
only: never ``jax`` and nothing of ``seldon_core_tpu``.  It keeps its own
copy of what it needs, under the same module and function names, so each
module's counterpart is easy to find.

Every Pallas kernel of the reference has a hand-written CUDA kernel here
(``csrc/``), built with ``nvcc`` at first use (``ops/_build.py``) and
bound through a plain C interface.  Beside each kernel sits its plain
PyTorch version; a wrapper takes the plain version only for a tensor on
the CPU and launches the kernel (or raises) for a tensor on the card.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``
(``--device cpu`` on the command line); see :mod:`.device`.
"""

__version__ = "0.1.0"
