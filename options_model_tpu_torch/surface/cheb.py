"""Chebyshev slice compilation of a volatility surface for the local-vol
kernels, as options_model_tpu/surface/cheb.py.

Per step t the surface is a 1-D Chebyshev polynomial in the scaled
log-moneyness:

    sigma_t(m) ~= sum_k c[t, k] T_k((m - m_center) / m_half),  m = log(K / S)

which the kernels (csrc/localvol.cu, csrc/terminal.cu) evaluate by
Clenshaw from their carried log S. The fit is numpy ``chebfit`` on the
reference's nodes, cast to float32; ``sigma_fn`` is called on float32 torch
tensors. ``table_sigma_fn`` turns a table back into a ``sigma_fn(S, tau)``
for the bare local-vol route (models/localvol.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class LocalVolTable:
    """Per-step Chebyshev slices of sigma(m, tau_t) for one (T, n_steps):
    row t is used at step t."""

    coeffs: torch.Tensor  # (n_steps, degree+1) float32
    m_center: float
    m_half: float
    K: float              # strike defining m = log(K / S)

    @property
    def degree(self) -> int:
        return self.coeffs.shape[1] - 1

    @classmethod
    def from_reference(cls, fields: dict) -> "LocalVolTable":
        """The port's table from the reference table's fields (``vars`` of
        it), given as numpy arrays or floats."""
        return cls(coeffs=torch.from_numpy(np.array(fields["coeffs"], np.float32)),
                   m_center=float(fields["m_center"]), m_half=float(fields["m_half"]),
                   K=float(fields["K"]))


def compile_localvol_table(sigma_fn: Callable, K: float, T: float, n_steps: int,
                           S0: float, *, degree: int = 7, m_width_sigmas: float = 4.5,
                           ref_vol: float = 0.25, S0_range=None) -> LocalVolTable:
    """Fit per-step Chebyshev slices of ``sigma_fn(S, tau)``.

    The m-range covers +- m_width_sigmas * ref_vol * sqrt(T) of log-moneyness
    around log(K/S0); paths outside evaluate the clamped edge value.
    ``S0_range=(S0_min, S0_max)`` widens the range so one table serves a
    whole spot grid."""
    dt = T / n_steps
    spread = m_width_sigmas * ref_vol * np.sqrt(T)
    if S0_range is not None:
        m_lo = float(np.log(K / max(S0_range)))   # highest spot -> lowest m
        m_hi = float(np.log(K / min(S0_range)))
        m_center = 0.5 * (m_lo + m_hi)
        m_half = float(max(0.5 * (m_hi - m_lo) + spread, 0.05))
    else:
        m_center = float(np.log(K / S0))
        m_half = float(max(spread, 0.05))

    # Chebyshev nodes in u in [-1, 1]
    n_nodes = 4 * (degree + 1)
    u = np.cos(np.pi * (np.arange(n_nodes) + 0.5) / n_nodes)
    S = torch.as_tensor(K * np.exp(-(m_center + m_half * u)), dtype=torch.float32)

    coeffs = np.zeros((n_steps, degree + 1), np.float32)
    for t in range(n_steps):
        tau_t = torch.tensor(max(T - t * dt, 1e-6), dtype=torch.float32)
        sig = np.asarray(torch.as_tensor(sigma_fn(S, tau_t)).cpu(), np.float64)
        coeffs[t] = np.polynomial.chebyshev.chebfit(u, sig, degree).astype(np.float32)
    return LocalVolTable(coeffs=torch.from_numpy(coeffs), m_center=m_center,
                         m_half=m_half, K=float(K))


def eval_table(table: LocalVolTable, S: torch.Tensor, t: int) -> torch.Tensor:
    """sigma at step t for spots S, with the reference's formula
    u = clip((log(K / S) - m_center) / m_half, -1, 1) and Clenshaw."""
    K = torch.tensor(table.K, dtype=S.dtype, device=S.device)
    u = torch.clamp((torch.log(K / S) - table.m_center) / table.m_half, -1.0, 1.0)
    c = table.coeffs[t].to(S.device)
    b1 = torch.zeros_like(u)
    b2 = torch.zeros_like(u)
    for k in range(table.degree, 0, -1):
        b1, b2 = c[k] + 2.0 * u * b1 - b2, b1
    return torch.clamp_min(c[0] + u * b1 - b2, 1e-6)


def table_sigma_fn(table: LocalVolTable, T: float):
    """sigma(S, tau) over a compiled table, as the reference's
    table_sigma_fn: tau maps back to the step the table was compiled on,
    t = clip(round((T - tau) n_steps / T), 0, n_steps - 1) in float32
    (round half to even), then eval_table."""
    n_steps = table.coeffs.shape[0]

    def fn(S, tau):
        tau = torch.as_tensor(tau, dtype=torch.float32)
        t = torch.round((T - tau) * n_steps / T)
        return eval_table(table, S, int(torch.clamp(t, 0, n_steps - 1)))

    return fn
