"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (``ref.py``) and a device-routing op (``ops.py``)."""
