"""Hand-written Hopper kernels (``csrc/``) behind torch ops, with a plain
PyTorch version of each for CPU tensors; see ``dispatch``."""
