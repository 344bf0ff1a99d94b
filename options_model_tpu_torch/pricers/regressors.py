"""Masked weighted least squares for Longstaff-Schwartz, as
options_model_tpu/pricers/regressors.py (the polynomial regressor; the
continuation MLP is not ported yet).

The dynamic in-the-money subset of each exercise date is a 0/1 weight
vector, so every date regresses on fixed shapes: one augmented Gram matmul
and a tiny Cholesky solve, with no host round trip.
"""

from __future__ import annotations

import torch


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
