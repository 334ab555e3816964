"""The §IV scheduler core: Python reference structures (copied from the
JAX package) and their tensor form (``tensor_state.py``)."""
