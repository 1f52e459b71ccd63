"""Analysis tools: the three-term roofline with one H100's figures and the
report tables (dry run, roofline, serving kernels, tuned blocks, latency
breakdown), the PyTorch port's counterpart of the JAX package's
``analysis/``."""
