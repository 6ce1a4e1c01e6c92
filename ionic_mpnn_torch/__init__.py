"""ionic_mpnn_torch — the PyTorch / CUDA port of the JAX package.

A second package beside the JAX one, grown slice by slice. It holds the
flagship viscosity model's forward pass (serving) and its train step on an
NVIDIA H100: the host data tier, the dual-encoder model, the optimizer, and
the three message-step kernels written by hand in CUDA C++ for Hopper
(``csrc/``), each behind an autograd Function whose backward runs on the
card too. It imports torch and numpy only; the JAX package is the
reference its tests hold it against.
"""

__version__ = "0.1.0"
