"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version beside it (``<name>/ref.py``) and its sources under
``<name>/csrc/``; ``_build.py`` compiles them on first use."""
