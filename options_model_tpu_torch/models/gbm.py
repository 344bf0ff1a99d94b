"""Geometric Brownian motion, log-Euler (options_model_tpu/models/gbm.py):

    log S_t = log S_{t-1} + (r - sigma^2/2) dt + sigma sqrt(dt) z_t.

``gbm_euler_from_normals`` is the recursion on given normals — the plain
version the CUDA kernels (the paths kernel of csrc/gbm.cu, the terminal
kernel of csrc/terminal.cu) are held against. ``simulate_gbm``
draws from the kernels' Philox stream and dispatches on the device;
``gbm_terminal_exact`` is the one-draw exact law, kernel 1 at one step.

``simulate_gbm`` and ``gbm_terminal_exact`` are differentiable in (S0, r,
sigma, T) when one of them is a tensor that requires grad: the kernel runs
and its VJP kernel is the backward (ops/autodiff.differentiable). With
log S_t = log S0 + t drift + diffusion W_t, W_t the sum of the first t
normals, drift = (r - sigma^2/2) dt and diffusion = sigma sqrt(dt):

    dS_t = S_t (dS0 / S0 + t d(drift) + W_t d(diffusion)),

so a cotangent g contracts to three sums, A = sum g S, B = sum g S t and
C = sum g S W (``gbm_chain`` maps them to the four parameters).
``gbm_euler_vjp_from_normals`` forms them on given normals, the plain
version of the VJP kernels of csrc/greeks.cu.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from options_model_tpu_torch.core.config import MCConfig
from options_model_tpu_torch.models.blocks import paths_rounded
from options_model_tpu_torch.ops.autodiff import requires_grad


def gbm_constants(S0, r, sigma, T, n_steps: int) -> dict:
    """float32 constants rounded as the TPU kernel's _gbm_params
    (pallas_gbm.py:92): dt = f32(T) / n_steps, drift = (r - sigma^2/2) dt,
    diffusion = sigma sqrt(dt); drift_n = drift * n_steps for S_T."""
    f = np.float32
    dt = f(T) / f(n_steps)
    drift = f(r - 0.5 * sigma**2) * dt
    return dict(s0=f(S0), drift=drift, diffusion=f(sigma) * np.sqrt(dt),
                drift_n=drift * f(n_steps))


def gbm_chain(sums: torch.Tensor, S0, r, sigma, T, n_steps: int) -> torch.Tensor:
    """(dS0, dr, dsigma, dT) in float64 from sums = (A, B, C) (each a scalar
    or a row of per-path shares): dS0 = A / S0,
    d(drift) = B and d(diffusion) = C, carried through drift =
    (r - sigma^2/2) T / n and diffusion = sigma sqrt(T / n) at the float32
    values of the parameters, as the kernels take them."""
    S0, r, sigma, T = (float(np.float32(x)) for x in (S0, r, sigma, T))
    dt = T / n_steps
    A, B, C = sums.to(torch.float64).unbind(0)
    return torch.stack([A / S0, B * dt, -B * sigma * dt + C * np.sqrt(dt),
                        B * (r - 0.5 * sigma * sigma) / n_steps
                        + C * sigma / (2.0 * np.sqrt(T * n_steps))])


def gbm_euler_vjp_from_normals(z: torch.Tensor, g: torch.Tensor, S0, r, sigma, T,
                               return_paths: bool = True,
                               per_path: bool = False) -> torch.Tensor:
    """<g, dS/d(S0, r, sigma, T)> of gbm_euler_from_normals on normals z
    (n_steps, n_paths), g shaped as its output: float64 (4,), or with
    ``per_path`` each path's share (4, n_paths). S is the recursion's own
    float32 output; W, the products and the sums are float64."""
    n_steps = z.shape[0]
    S = gbm_euler_from_normals(z, S0, r, sigma, T, return_paths).double()
    gS = g.double() * S
    if return_paths:
        W = torch.cat([torch.zeros_like(gS[:1]), torch.cumsum(z.double(), 0)])
        t = torch.arange(n_steps + 1, dtype=torch.float64, device=z.device)
        sums = torch.stack([gS.sum(0), (gS * t[:, None]).sum(0), (gS * W).sum(0)])
    else:
        sums = torch.stack([gS, n_steps * gS, gS * z.double().sum(0)])
    return gbm_chain(sums if per_path else sums.sum(1), S0, r, sigma, T, n_steps)


def gbm_euler_from_normals(z: torch.Tensor, S0, r, sigma, T,
                           return_paths: bool = True) -> torch.Tensor:
    """Log-Euler GBM on normals z (n_steps, n_paths), with the TPU kernels'
    formulas: paths S = S0 * exp(rel log S) with row 0 = S0, (n_steps+1,
    n_paths); terminal S_T = S0 * exp(drift * n_steps + diffusion * sum z),
    (n_paths,), the sum taken step by step."""
    c = {k: float(v) for k, v in gbm_constants(S0, r, sigma, T, z.shape[0]).items()}
    acc = torch.zeros(z.shape[1], dtype=torch.float32, device=z.device)
    if not return_paths:
        for z_t in z:
            acc = acc + z_t
        return c["s0"] * torch.exp(c["drift_n"] + c["diffusion"] * acc)
    rows = [c["s0"] * torch.exp(acc)]
    for z_t in z:
        acc = acc + c["drift"] + c["diffusion"] * z_t
        rows.append(c["s0"] * torch.exp(acc))
    return torch.stack(rows)


def simulate_gbm(seed: int, S0, r, sigma, T, cfg: MCConfig,
                 return_paths: bool = True, first_tile: int = 0,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """GBM paths from the kernels' stream (on a CUDA device csrc/gbm.cu for
    paths, csrc/terminal.cu for terminal values; on the CPU their plain
    versions): (n_steps+1, n_pad) or S_T (n_pad,), n_pad rounding
    paths_rounded(cfg) up to the kernel tile. S0, r, sigma and T may be
    0-d tensors; when one requires grad the same kernel runs and the
    backward is its VJP kernel (ops/cuda_gbm.gbm_paths_ad, gbm_terminal_ad)."""
    from options_model_tpu_torch.ops import cuda_gbm

    args = (seed, S0, r, sigma, T, paths_rounded(cfg), cfg.n_steps, cfg.antithetic,
            first_tile, device)
    if requires_grad(S0, r, sigma, T):
        return (cuda_gbm.gbm_paths_ad if return_paths else cuda_gbm.gbm_terminal_ad)(*args)
    return (cuda_gbm.gbm_paths if return_paths else cuda_gbm.gbm_terminal)(*args)


def gbm_terminal_exact(seed: int, S0, r, sigma, T, n_paths: int, antithetic: bool = True,
                       first_tile: int = 0, device: Optional[torch.device] = None):
    """The one-draw exact terminal law S_T = S0 exp((r - sigma^2/2) T +
    sigma sqrt(T) Z) (options_model_tpu/models/gbm.py gbm_terminal_exact):
    the terminal kernel at one step, whose single log-Euler step is that
    law. (n_pad,), n_pad = n_paths rounded up to TERMINAL_TILE; the mirror
    of path j is j + TERMINAL_TILE/2 within its tile, where the reference
    pairs (i, i + n/2) over the whole vector, so pair means reduce at the
    kernel's tile. Differentiable as simulate_gbm."""
    from options_model_tpu_torch.ops import cuda_gbm

    fn = cuda_gbm.gbm_terminal_ad if requires_grad(S0, r, sigma, T) else cuda_gbm.gbm_terminal
    return fn(seed, S0, r, sigma, T, n_paths, 1, antithetic, first_tile, device)
