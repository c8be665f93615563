"""PyTorch/CUDA port of the ForkKV multi-LoRA serving system.

Laid out module for module like the JAX package ``repro``, which stays the
reference the port is tested against.  This package imports neither JAX nor
``repro``.  Its entry points (``ForkServer``, ``Engine``, ``PagedExecutor``,
``init_params``) run on the CUDA device unless the caller passes
``device="cpu"``; on the CPU every kernel is replaced by its plain PyTorch
version.
"""
