"""PyTorch/CUDA port of the fleet engine.

A second package beside the JAX reference ``repro``: plain PyTorch for the
tensor code and hand-written CUDA C++ for Hopper where ``repro`` has a
Pallas kernel. It imports neither ``jax`` nor ``repro``. Entry points run
on CUDA unless given ``device="cpu"``.
"""
