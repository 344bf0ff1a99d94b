"""Path kernels, and their plain versions on given normals, as differentiable
functions of their scalar parameters.

The reference takes its Greeks with ``jax.grad`` through its XLA simulators
(options_model_tpu/pricers/greeks.py). The port has one engine: the kernels
on the card and their plain versions on the CPU, so a gradient passes
through them. ``differentiable(run, vjp, *params)`` is ``run(*values)`` in
the autograd graph: its backward hands the outputs' cotangents to ``vjp``,
a VJP kernel on the card (csrc/greeks.cu) or its plain version, which
returns dL/dparam for every parameter at once as a float64 tensor.
"""

from __future__ import annotations

import torch

# Threads per block of the VJP kernels (csrc/greeks.cu kBlock): a launch
# writes one row of partial sums per block.
VJP_BLOCK = 256


def cotangent(g: torch.Tensor, shape) -> torch.Tensor:
    """g as the VJP kernels read it: float32, contiguous, of ``shape``."""
    if tuple(g.shape) != tuple(shape):
        raise ValueError(f"cotangent of shape {tuple(g.shape)}, expected {tuple(shape)}")
    return g.to(torch.float32).contiguous()


def requires_grad(*params) -> bool:
    """True when any of ``params`` is a tensor that takes a gradient."""
    return any(isinstance(p, torch.Tensor) and p.requires_grad for p in params)


class _ScalarParams(torch.autograd.Function):
    """run(*values) of 0-d parameters; the backward calls vjp(grads,
    outputs, *values), grads holding one cotangent per output (None for an
    output the loss does not reach: no zero matrix is made for it)."""

    @staticmethod
    def forward(ctx, run, vjp, *params):
        ctx.set_materialize_grads(False)
        values = tuple(float(p) for p in params)
        out = run(*values)
        outs = out if isinstance(out, tuple) else (out,)
        ctx.save_for_backward(*outs)
        ctx.vjp, ctx.values = vjp, values
        ctx.like = [(p.dtype, p.device) if isinstance(p, torch.Tensor) else None
                    for p in params]
        return out

    @staticmethod
    def backward(ctx, *grads):
        none = [None] * len(ctx.values)
        if all(g is None for g in grads):
            return (None, None, *none)
        g = ctx.vjp(grads, ctx.saved_tensors, *ctx.values)
        out = [None if like is None or not need else g[i].to(dtype=like[0], device=like[1])
               for i, (like, need) in enumerate(zip(ctx.like, ctx.needs_input_grad[2:]))]
        return (None, None, *out)


def differentiable(run, vjp, *params):
    """run(*map(float, params)) with a backward through ``vjp``: a tensor,
    or a tuple of tensors when ``run`` returns one."""
    return _ScalarParams.apply(run, vjp, *params)
