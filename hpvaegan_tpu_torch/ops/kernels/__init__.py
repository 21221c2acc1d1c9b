"""Hand-written CUDA kernels (``csrc/``) and their PyTorch wrappers.

Each wrapper module holds the kernel's plain PyTorch version and a launch
counter.  Kernels are built and loaded at first launch, never at import.
"""
