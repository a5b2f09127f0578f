"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain PyTorch versions.

Each ``<kernel>.py`` holds the wrapper of one kernel whose source lies in
``csrc/<kernel>.cu``: a tensor on the CPU goes to the plain version in
``ref.py``, a CUDA tensor to the kernel.  ``build.py`` compiles the sources
with ``nvcc`` at first use.
"""
