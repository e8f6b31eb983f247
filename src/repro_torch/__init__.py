"""PyTorch/CUDA port of the composite-hash sketch library (``repro``).

The layout mirrors the JAX package module for module (``core/``,
``kernels/``, ``serving/``, ``streams/``) with the same function names, so
each port can be read beside its reference.  The hot paths run through
hand-written CUDA kernels for Hopper (``kernels/csrc/``); each kernel has a
plain PyTorch version in the same module, which runs when the tensors lie
on the CPU.

Device rule: every entry point that creates state takes ``device``.  With
``device=None`` it runs on ``cuda`` and raises when no card is present; the
CPU is used only when the caller passes ``device="cpu"``.
"""
from repro_torch.device import resolve_device  # noqa: F401
