"""PyTorch and CUDA port of FastSurvival for NVIDIA Hopper.

Mirrors the layout of the JAX package ``repro``: ``core`` (Cox math,
surrogates, coordinate descent), ``kernels`` (hand-written CUDA kernels
with plain-PyTorch versions beside them), ``serving`` (Breslow artifact and
batched scoring), ``obs``, ``data`` and ``convert``. Importing the package
builds nothing and needs no GPU; the entry points run on ``"cuda"`` unless
given ``device="cpu"``.
"""
