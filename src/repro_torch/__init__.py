"""repro_torch: the green-serving stack in PyTorch, with CUDA kernels for Hopper.

The counterpart of the JAX package, module for module and name for name.
It imports torch and numpy, never JAX and nothing of the JAX package.  Entry points
run on the GPU unless the caller passes ``device="cpu"``; on the CPU every
kernel is replaced by its plain PyTorch version.
"""

__version__ = "0.1.0"
