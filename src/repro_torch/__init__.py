"""CATO's serving pipeline in PyTorch, with hand-written CUDA kernels for Hopper.

The port of the JAX package `repro`, module for module at the same relative
paths. It imports `torch` and `numpy`, never `jax` and nothing of `repro`.
Entry points take ``device=`` and default to ``"cuda"``; without a card
they raise unless the caller passes ``device="cpu"``, which runs each
kernel's plain PyTorch version.

Importing the package builds and loads nothing: the kernels under `csrc/`
are compiled with nvcc at their first launch (`repro_torch.kernels._build`).
"""
