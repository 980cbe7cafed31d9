"""AMContrast3D in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The second package beside :mod:`amcontrast3d_tpu`, which stays the JAX
reference it is tested against.  The layout mirrors the JAX package
(``ops/``, ``models/``, ``engine/``, ``utils/``) module for module; tensors
are channels-last ``(B, N, C)`` as there.

Each op that the JAX package runs through a Pallas kernel has a wrapper
here that launches a CUDA kernel (``csrc/*.cu``, built by
:mod:`amcontrast3d_tpu_torch.ops._build` on first use) for a CUDA tensor
and runs its plain PyTorch twin for a CPU tensor.

This package never imports ``jax``, ``flax`` or ``amcontrast3d_tpu``.
"""

__version__ = "0.1.0"
