"""Gradients through the hand-written kernels.

The CUDA kernels compute a forward pass only: a wrapper fills a fresh
output through ``ctypes``, so the output has no ``grad_fn``. The ``ops.py``
route of each kernel that a training forward runs (attention and the two
scans) therefore calls its kernel inside a ``torch.autograd.Function``
whose backward recomputes a differentiable plain version on the saved
inputs and takes its vector-Jacobian product (``recompute_vjp``): the
recomputation the reference's ``jax.checkpoint`` already does, and the
gradient of the same function that ``jax.value_and_grad`` takes of the
reference's plain jnp path. No backward kernel is written.

``check_no_grad`` is the guard every such wrapper makes: a direct call
with an input that requires grad, under grad mode, would cut the gradient
silently, so it raises and names the route that differentiates.
"""

from __future__ import annotations

import torch


def check_no_grad(kernel: str, route: str, *xs) -> None:
    """Raise ``ValueError`` if grad mode is on and any of ``xs`` requires
    grad: the kernel's output would carry no gradient."""
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in xs):
        raise ValueError(
            f"{kernel}: an input requires grad, and the kernel's output "
            f"has no grad_fn; call {route}, which differentiates through "
            f"the kernel")


def recompute_vjp(plain, ctx, grad_out, *args, **kw) -> tuple:
    """The gradients of ``plain(*ctx.saved_tensors, *args, **kw)`` against
    ``grad_out``, one for each saved tensor: None where
    ``ctx.needs_input_grad`` is false, else the gradient in the input's
    dtype. The saved tensors are the autograd function's leading inputs,
    in order."""
    saved = ctx.saved_tensors
    need = ctx.needs_input_grad[:len(saved)]
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
        wrt = [x for x in xs if x.requires_grad]
        out = plain(*xs, *args, **kw)
        grads = iter(torch.autograd.grad(out, wrt, grad_out) if wrt else ())
    return tuple(next(grads) if n else None for n in need)
