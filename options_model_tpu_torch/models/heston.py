"""Heston stochastic-volatility paths, full-truncation Euler
(options_model_tpu/models/heston.py):

    v+ = max(v, 0)
    v  <- max(v+ + kappa (theta - v+) dt + xi sqrt(v+ dt) W2, 0)
    log S <- log S + (r - v+/2) dt + sqrt(v+ dt) W1
    W1 = z1,  W2 = rho z1 + sqrt(1 - rho^2) z2.

``heston_euler_from_normals`` is that recursion on given normals — the plain
version the CUDA kernels (csrc/heston.cu) are held against, and the function
the tests feed with the reference simulator's own normals. ``simulate_heston``
draws from the kernels' Philox stream and dispatches on the device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from options_model_tpu_torch._unported import not_ported
from options_model_tpu_torch.core.config import HestonParams, MCConfig
from options_model_tpu_torch.models.blocks import paths_rounded


def heston_constants(S0, r, T, params: HestonParams, n_steps: int) -> dict:
    """The recursion's float32 constants, rounded as the TPU kernel's
    _params_array rounds them (pallas_heston.py:249): dt = f32(T) / n_steps,
    rho_bar = sqrt(1 - rho^2) in f32. Shared by the kernel and its plain
    version so both start from identical bits."""
    f = np.float32
    dt = f(T) / f(n_steps)
    rho = f(params.rho)
    return dict(log_s0=np.log(f(S0)), r=f(r), dt=dt, sqrt_dt=np.sqrt(dt),
                kappa=f(params.kappa), theta=f(params.theta), xi=f(params.xi),
                rho=rho, rho_bar=np.sqrt(f(1.0) - rho * rho), v0=f(params.v0))


def heston_euler_from_normals(z1: torch.Tensor, z2: torch.Tensor, S0, r, T,
                              params: HestonParams,
                              return_variance: bool = False,
                              return_paths: bool = True):
    """Full-truncation Euler on normals z1, z2 of shape (n_steps, n_paths).

    Carries log S relative to log S0 and writes S = exp(log S0 + rel), the
    TPU kernel's formula (row 0 included). Returns S (n_steps+1, n_paths)
    [and v likewise], or with ``return_paths=False`` S_T (n_paths,) [and v_T].
    """
    c = {k: float(v) for k, v in heston_constants(S0, r, T, params, z1.shape[0]).items()}
    n_paths = z1.shape[1]
    log_s = torch.zeros(n_paths, dtype=torch.float32, device=z1.device)
    v = torch.full((n_paths,), c["v0"], dtype=torch.float32, device=z1.device)
    s_rows, v_rows = [torch.exp(c["log_s0"] + log_s)], [v]
    for z1_t, z2_t in zip(z1, z2):
        w2 = c["rho"] * z1_t + c["rho_bar"] * z2_t
        v_plus = torch.clamp_min(v, 0.0)
        sq = torch.sqrt(v_plus) * c["sqrt_dt"]
        v = torch.clamp_min(v_plus + c["kappa"] * (c["theta"] - v_plus) * c["dt"]
                            + c["xi"] * sq * w2, 0.0)
        log_s = log_s + (c["r"] - 0.5 * v_plus) * c["dt"] + sq * z1_t
        if return_paths:
            s_rows.append(torch.exp(c["log_s0"] + log_s))
            v_rows.append(v)
    if not return_paths:
        S_T = torch.exp(c["log_s0"] + log_s)
        return (S_T, v) if return_variance else S_T
    S = torch.stack(s_rows)
    return (S, torch.stack(v_rows)) if return_variance else S


def simulate_heston(seed: int, S0, r, T, params: HestonParams, cfg: MCConfig,
                    return_paths: bool = True, return_variance: bool = False,
                    first_tile: int = 0, scheme: str = "euler",
                    device: Optional[torch.device] = None):
    """Heston paths from the kernels' stream (the port's single engine:
    csrc/heston.cu on a CUDA device, its plain version on the CPU).

    Returns S (n_steps+1, n_pad) [and v] with return_paths, else S_T (n_pad,);
    n_pad rounds paths_rounded(cfg) up to the kernel tile (PATH_TILE for
    paths, TERMINAL_TILE for terminal values)."""
    if scheme != "euler":
        raise not_ported(f"heston scheme {scheme!r}",
                         "models.heston._simulate_heston_qe")
    from options_model_tpu_torch.ops import cuda_heston

    if return_paths:
        return cuda_heston.heston_paths(seed, S0, r, T, params, paths_rounded(cfg),
                                        cfg.n_steps, cfg.antithetic,
                                        return_variance, first_tile, device)
    if return_variance:
        raise not_ported("terminal variance", "models.heston.simulate_heston")
    return cuda_heston.heston_terminal(seed, S0, r, T, params, paths_rounded(cfg),
                                       cfg.n_steps, cfg.antithetic, first_tile,
                                       device)
