"""Hand-written CUDA kernels for Hopper, their wrappers and plain-PyTorch
versions. Nothing is built at import; see ``_build.py``."""
