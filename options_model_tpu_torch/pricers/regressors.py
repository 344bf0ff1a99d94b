"""Continuation-value regressors for Longstaff-Schwartz, as
options_model_tpu/pricers/regressors.py:

- masked weighted least squares on a small polynomial basis. The dynamic
  in-the-money subset of each exercise date is a 0/1 weight vector, so every
  date regresses on fixed shapes: one augmented Gram matmul and a tiny
  Cholesky solve, with no host round trip;
- the continuation MLP (input -> hidden x layers -> 1, ReLU, dropout) with
  its AdamW training loop: a fixed epoch budget, minibatches drawn with
  replacement, and the weights of the epoch with the lowest full-data loss.

The MLP is initialised as Flax's ``Dense`` is (LeCun-normal truncated
kernel, zero bias), and every random draw of a fit (the initial weights,
the minibatch indices, the dropout masks) comes from the ``torch.Generator``
the caller passes, never from the global generator. Everything runs in
float32 with TF32 off, as the rest of the port does.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from options_model_tpu_torch.core.config import LSMConfig

# Rows per chunk of the full-data loss and of the predict: a 2^18-path x
# 49-date set in one piece needs gigabytes of activations (the reference
# ran out of device memory on it, regressors.py:262-268).
CHUNK = 1 << 17
# Flax's lecun_normal: variance_scaling(1, "fan_in", "truncated_normal")
# divides the std by the std of a unit normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def _cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD A (..., d, d), one column per step
    (Cholesky-Crout), pivots floored at 1e-20 as in the reference. A column
    is a handful of tensor ops, so d = 13 costs ~60 launches on the card
    instead of the ~800 scalar ops of a fully unrolled factorization."""
    d = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(d):
        s = A[..., j:, j] - (L[..., j:, :j] @ L[..., j, :j, None])[..., 0]
        ljj = torch.sqrt(torch.clamp_min(s[..., 0], 1e-20))
        L[..., j, j] = ljj
        L[..., j + 1:, j] = s[..., 1:] / ljj[..., None]
    return L


def _cholesky_solve(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """x with L L^T x = rhs, by forward then back substitution."""
    d = L.shape[-1]
    y = torch.zeros_like(rhs)
    for i in range(d):
        s = rhs[..., i] - (L[..., i, :i] * y[..., :i]).sum(-1)
        y[..., i] = s / L[..., i, i]
    x = torch.zeros_like(rhs)
    for i in reversed(range(d)):
        s = y[..., i] - (L[..., i + 1:, i] * x[..., i + 1:]).sum(-1)
        x[..., i] = s / L[..., i, i]
    return x


def solve_spd_small(A: torch.Tensor, b: torch.Tensor, refine: int = 1) -> torch.Tensor:
    """Solve A x = b for small SPD A (..., d, d) by Cholesky, plus
    ``refine`` steps of iterative refinement (which tighten the f32 answer
    at negligible cost). d is the LSM basis width, so everything stays on
    the device in plain elementwise and tiny matmul ops."""
    L = _cholesky(A)
    x = _cholesky_solve(L, b)
    for _ in range(refine):
        r = b - (A @ x[..., None])[..., 0]
        x = x + _cholesky_solve(L, r)
    return x


def masked_wls_theta_centered(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                              ridge: float = 1e-7) -> torch.Tensor:
    """Coefficients of the masked WLS argmin_theta sum_i w_i (X_i theta - y_i)^2
    on a basis the caller has conditioned (intercept plus centered, scaled
    columns). One augmented Gram G = [X|y]^T W [X|y] (full float32: the
    callers keep TF32 off), a trace-scaled ridge, and the small solve."""
    d = X.shape[-1]
    Z = torch.cat([X, y[:, None]], dim=-1)
    G = (Z * w[:, None]).T @ Z                                # (d+1, d+1)
    A = G[:d, :d]
    b = G[:d, d]
    lam = ridge * (torch.trace(A) / d + 1.0)
    A = A + lam * torch.eye(d, dtype=A.dtype, device=A.device)
    return solve_spd_small(A, b)


def masked_wls_predict_centered(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                                ridge: float = 1e-7) -> torch.Tensor:
    """Fitted values X theta of masked_wls_theta_centered at every row."""
    return X @ masked_wls_theta_centered(X, y, w, ridge=ridge)


class ContinuationMLP(nn.Module):
    """The reference's SingleLSMNet: input_dim -> hidden x num_layers -> 1,
    each hidden layer Linear, ReLU, dropout. ``layers[i]`` is Flax's
    ``Dense_i`` (mlp_state_from_flax)."""

    def __init__(self, input_dim: int, hidden: int = 128, num_layers: int = 3,
                 dropout: float = 0.1, generator: Optional[torch.Generator] = None,
                 device=None):
        """Weights from reset_parameters(generator), by default a fresh
        generator on ``device``: construction never draws from the global
        generator."""
        super().__init__()
        device = torch.device("cpu" if device is None else device)
        widths = [input_dim] + [hidden] * num_layers + [1]
        self.layers = nn.ModuleList(nn.utils.skip_init(nn.Linear, a, b, device=device)
                                    for a, b in zip(widths, widths[1:]))
        self.dropout = dropout
        self.reset_parameters(torch.Generator(device=device) if generator is None
                              else generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Flax Dense init from ``generator``: kernel ~ N(0, 1/fan_in)
        truncated at 2 std (std rescaled by _TRUNC_STD), bias 0."""
        with torch.no_grad():
            for lin in self.layers:
                std = math.sqrt(1.0 / lin.in_features) / _TRUNC_STD
                nn.init.trunc_normal_(lin.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                lin.bias.zero_()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(n, input_dim) -> (n, 1). With a ``generator`` (training) each
        hidden activation keeps a unit with probability 1 - dropout, drawn
        from it, and scales the kept ones by 1 / (1 - dropout), as Flax's
        Dropout does; without one the net is deterministic."""
        keep = 1.0 - self.dropout
        for lin in self.layers[:-1]:
            x = torch.relu(lin(x))
            if generator is not None and self.dropout > 0.0:
                mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
                x = torch.where(mask, x / keep, 0.0)
        return self.layers[-1](x)


def mlp_state_from_flax(params) -> dict:
    """A ContinuationMLP state_dict from the JAX package's Flax params
    ({"params": {"Dense_i": {"kernel", "bias"}}} or the inner dict), given
    as numpy arrays: the (in, out) kernel becomes the (out, in) weight."""
    inner = params.get("params", params)
    state = {}
    for i in range(len(inner)):
        dense = inner[f"Dense_{i}"]
        state[f"layers.{i}.weight"] = torch.tensor(np.asarray(dense["kernel"], np.float32).T)
        state[f"layers.{i}.bias"] = torch.tensor(np.asarray(dense["bias"], np.float32))
    return state


def weighted_mse(pred: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum w (pred - y)^2 / max(sum w, 1): the training loss of a minibatch."""
    return (w * (pred - y) ** 2).sum() / torch.clamp_min(w.sum(), 1.0)


def make_optimizer(model: ContinuationMLP, cfg: LSMConfig) -> torch.optim.AdamW:
    """AdamW at cfg.nn_lr, betas (0.9, 0.999), eps 1e-8 and decoupled weight
    decay 1e-5 on every parameter: optax.adamw(nn_lr, weight_decay=1e-5).
    The fused implementation on a CUDA device (one launch per step)."""
    on_cuda = next(model.parameters()).device.type == "cuda"
    return torch.optim.AdamW(model.parameters(), lr=cfg.nn_lr, weight_decay=1e-5,
                             fused=on_cuda)


def full_weighted_loss(model: ContinuationMLP, X: torch.Tensor, y: torch.Tensor,
                       w: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """Deterministic (no dropout) weighted MSE over the full data set,
    sum w (pred - y)^2 / max(sum w, 1), in row chunks so activations stay at
    chunk x hidden. The last chunk is shorter; the reference pads it with
    zero-weight rows, which add nothing."""
    sq = torch.zeros((), dtype=X.dtype, device=X.device)
    with torch.no_grad():
        for i in range(0, X.shape[0], chunk):
            pred = model(X[i:i + chunk])[:, 0]
            sq = sq + (w[i:i + chunk] * (pred - y[i:i + chunk]) ** 2).sum()
        return sq / torch.clamp_min(w.sum(), 1.0)


def mlp_predict(model: ContinuationMLP, x: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """The deterministic net on x (n, d) -> (n,), in row chunks."""
    with torch.no_grad():
        return torch.cat([model(x[i:i + chunk])[:, 0] for i in range(0, x.shape[0], chunk)])


def fit_continuation_mlp(generator: torch.Generator, X: torch.Tensor, y: torch.Tensor,
                         w: torch.Tensor, cfg: LSMConfig):
    """Train the continuation MLP on weighted data; returns (the net at its
    best epoch, the (nn_epochs,) full-data losses).

    X (n, d) standardized features, y (n,) standardized targets, w (n,)
    weights (0 excludes a row). ``generator`` lies on X's device and draws
    the initial weights, then per step the minibatch indices (with
    replacement, over all n rows) and the dropout masks. make_optimizer's
    AdamW; min(max(n // batch, 1), 512) steps per epoch. After each epoch
    the full-data loss decides, on the device, whether these weights replace
    the best so far (the first finite loss always does)."""
    n = X.shape[0]
    batch = min(cfg.nn_batch, n)
    steps_per_epoch = min(max(n // batch, 1), 512)
    model = ContinuationMLP(X.shape[1], cfg.nn_hidden, cfg.nn_layers, cfg.nn_dropout,
                            generator=generator, device=X.device)
    opt = make_optimizer(model, cfg)
    best = [p.detach().clone() for p in model.parameters()]
    best_loss = torch.full((), math.inf, dtype=X.dtype, device=X.device)
    losses = []
    for _ in range(cfg.nn_epochs):
        for _ in range(steps_per_epoch):
            idx = torch.randint(0, n, (batch,), generator=generator, device=X.device)
            loss = weighted_mse(model(X[idx], generator)[:, 0], y[idx], w[idx])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        loss = full_weighted_loss(model, X, y, w)
        better = loss < best_loss
        best_loss = torch.where(better, loss, best_loss)
        with torch.no_grad():
            for b, p in zip(best, model.parameters()):
                b.copy_(torch.where(better, p, b))
        losses.append(loss)
    with torch.no_grad():
        for b, p in zip(best, model.parameters()):
            p.copy_(b)
    return model, torch.stack(losses)
