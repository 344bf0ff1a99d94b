"""Geometric Brownian motion, log-Euler (options_model_tpu/models/gbm.py):

    log S_t = log S_{t-1} + (r - sigma^2/2) dt + sigma sqrt(dt) z_t.

``gbm_euler_from_normals`` is the recursion on given normals — the plain
version the CUDA kernels (the paths kernel of csrc/gbm.cu, the terminal
kernel of csrc/terminal.cu) are held against. ``simulate_gbm``
draws from the kernels' Philox stream and dispatches on the device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from options_model_tpu_torch.core.config import MCConfig
from options_model_tpu_torch.models.blocks import paths_rounded


def gbm_constants(S0, r, sigma, T, n_steps: int) -> dict:
    """float32 constants rounded as the TPU kernel's _gbm_params
    (pallas_gbm.py:92): dt = f32(T) / n_steps, drift = (r - sigma^2/2) dt,
    diffusion = sigma sqrt(dt); drift_n = drift * n_steps for S_T."""
    f = np.float32
    dt = f(T) / f(n_steps)
    drift = f(r - 0.5 * sigma**2) * dt
    return dict(s0=f(S0), drift=drift, diffusion=f(sigma) * np.sqrt(dt),
                drift_n=drift * f(n_steps))


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
    paths_rounded(cfg) up to the kernel tile."""
    from options_model_tpu_torch.ops import cuda_gbm

    fn = cuda_gbm.gbm_paths if return_paths else cuda_gbm.gbm_terminal
    return fn(seed, S0, r, sigma, T, paths_rounded(cfg), cfg.n_steps,
              cfg.antithetic, first_tile, device)
