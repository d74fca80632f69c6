"""ACORN hybrid search in PyTorch, with hand-written CUDA kernels for Hopper.

The layout mirrors the JAX package ``repro`` module for module, so each
module here has a counterpart of the same name there.  Kernel routing
follows the tensors' device: a CPU tensor runs a kernel's plain PyTorch
version (``ref.py``), a CUDA tensor launches the CUDA kernel (or raises).
Entry points that create tensors take ``device=`` and default to
``"cuda"``; they raise when CUDA is asked for and missing.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
