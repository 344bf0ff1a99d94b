"""Bates (1996) stochastic volatility with jumps (options_model_tpu/models/
bates.py): the Heston paths times an independent compensated compound-jump
factor,

    S_bates = S_heston(drift r) * exp( sum_t [N_t mu_j + sigma_j sqrt(N_t) z_j
                                             - lam kbar dt] ),

N_t ~ Poisson(lam dt). The jumps are independent of both Brownian drivers
and of the variance, so v is the Heston v unchanged and the overlay composes
with either Heston scheme. The port multiplies the factor into the Heston
kernel's own output in place (csrc/jumps.cu kernels 16 and 17; on the CPU
their plain versions), on the Heston kernel's seed with the fourth counter
word 1 (ops/philox.py): no second seed is drawn, and at lam = 0 the factor
is exactly 1, so the Bates paths are the Heston paths bit for bit. The
overlay is never mirrored: every column is i.i.d., so antithetic pair means
stay valid stderr units.

``overlay_from_draws`` is the factor on given (N, z_j), the plain recursion
the kernels are held against.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from options_model_tpu_torch._unported import not_ported
from options_model_tpu_torch.core.config import BatesParams, MCConfig
from options_model_tpu_torch.models.blocks import paths_rounded
from options_model_tpu_torch.models.heston import (_heston_fields, simulate_heston,
                                                   simulate_heston_maturities)
from options_model_tpu_torch.models.merton import jump_sum
from options_model_tpu_torch.ops.autodiff import requires_grad


def overlay_constants(T, jumps, n_steps: int, terminal: bool = False) -> dict:
    """float32 constants of the overlay, rounded as the reference's
    jump_overlay: dt = f32(T) / n_steps, comp = lam kbar dt; a = -comp per
    step, or -(comp n_steps) for the terminal factor; lam_dt the Poisson
    mean of a step (of the whole maturity when terminal), float64."""
    f = np.float32
    dt = f(T) / f(n_steps)
    lam, mu_j, sig_j = f(jumps.lam), f(jumps.mu_j), f(jumps.sigma_j)
    comp = lam * (np.exp(mu_j + f(0.5) * sig_j * sig_j) - f(1.0)) * dt
    lam_t = float(jumps.lam) * float(T)
    return dict(a=-(comp * f(n_steps)) if terminal else -comp, mu_j=mu_j, sigma_j=sig_j,
                lam_dt=lam_t if terminal else lam_t / n_steps)


def overlay_from_draws(n: torch.Tensor, z_j: torch.Tensor, T, jumps, n_steps: int,
                       return_paths: bool = True) -> torch.Tensor:
    """The compensated jump factor on counts n and normals z_j: with
    return_paths, each (n_steps, n_paths) and the factor (n_steps+1,
    n_paths) with row 0 all ones, exp of the running sum of N mu_j +
    sigma_j sqrt(N) z_j - lam kbar dt; else each (n_paths,) and exp(N mu_j +
    sigma_j sqrt(N) z_j - lam kbar dt n_steps), the terminal factor."""
    c = {k: float(v) for k, v in overlay_constants(T, jumps, n_steps,
                                                    terminal=not return_paths).items()}
    if not return_paths:
        return torch.exp(jump_sum(n, z_j, c["mu_j"], c["sigma_j"]) + c["a"])
    y = torch.zeros(n.shape[1], dtype=z_j.dtype, device=z_j.device)
    rows = [torch.exp(y)]
    for t in range(n.shape[0]):
        y = y + (jump_sum(n[t], z_j[t], c["mu_j"], c["sigma_j"]) + c["a"])
        rows.append(torch.exp(y))
    return torch.stack(rows)


def jump_overlay_for(seed: int, S: torch.Tensor, T, jumps, n_steps: int,
                     return_paths: bool = True, first_tile: int = 0) -> torch.Tensor:
    """Multiply the overlay into a Heston kernel's output S in place, sized to
    its width (the kernel's tile-rounded n_pad, as the reference's
    jump_overlay_for insists): S (n_steps+1, n_pad) on PATH_TILE tiles, or
    S_T (n_pad,) on TERMINAL_TILE tiles, from ``first_tile`` on, the tiles
    the Heston kernel drew. ``jumps`` carries lam, mu_j and sigma_j.
    Returns S."""
    from options_model_tpu_torch.ops import cuda_jumps

    if return_paths:
        if S.dim() != 2 or S.shape[0] != n_steps + 1:
            raise ValueError(f"paths of {n_steps} steps are ({n_steps + 1}, n_pad), got "
                             f"{tuple(S.shape)}")
        return cuda_jumps.jump_overlay_paths(S, seed, T, jumps, first_tile)
    return cuda_jumps.jump_overlay_terminal(S, seed, T, jumps, n_steps, first_tile)


def jump_overlay(seed: int, T, lam, mu_j, sigma_j, cfg: MCConfig, return_paths: bool = True,
                 first_tile: int = 0, device: Optional[torch.device] = None) -> torch.Tensor:
    """The factor itself, (n_steps+1, n_pad) with row 0 all ones or (n_pad,):
    the overlay applied to ones at the width of the Heston kernel for
    ``cfg`` (paths_rounded(cfg) rounded up to its tile). E[factor] = 1 at
    every row."""
    from options_model_tpu_torch.models.blocks import round_up
    from options_model_tpu_torch.ops.cuda_heston import PATH_TILE, TERMINAL_TILE
    from options_model_tpu_torch.ops.engine import resolve_device

    n_pad = round_up(paths_rounded(cfg), PATH_TILE if return_paths else TERMINAL_TILE)
    shape = (cfg.n_steps + 1, n_pad) if return_paths else (n_pad,)
    ones = torch.ones(shape, dtype=torch.float32, device=resolve_device(device))
    jumps = SimpleNamespace(lam=lam, mu_j=mu_j, sigma_j=sigma_j)
    return jump_overlay_for(seed, ones, T, jumps, cfg.n_steps,
                            return_paths, first_tile)


def _check_no_grad(S0, r, T, params: BatesParams) -> None:
    if requires_grad(S0, r, T, params.lam, params.mu_j, params.sigma_j,
                     *_heston_fields(params.heston)):
        raise not_ported("gradients of the Bates paths (pathwise Greeks through the "
                         "jump overlay)", "models.bates.simulate_bates")


def simulate_bates(seed: int, S0, r, T, params: BatesParams, cfg: MCConfig,
                   return_paths: bool = True, return_variance: bool = False,
                   first_tile: int = 0, scheme: str = "euler",
                   device: Optional[torch.device] = None):
    """Bates paths: simulate_heston (Euler or QE-M) on ``seed``, then the
    overlay multiplied into its S in place. ``r`` is the drift without the
    jump compensator (the overlay carries -lam kbar dt). Returns as
    simulate_heston: S (n_steps+1, n_pad) [and v, the Heston v] or S_T
    (n_pad,)."""
    _check_no_grad(S0, r, T, params)
    out = simulate_heston(seed, S0, r, T, params.heston, cfg, return_paths=return_paths,
                          return_variance=return_variance, first_tile=first_tile,
                          scheme=scheme, device=device)
    S = out[0] if return_variance else out
    jump_overlay_for(seed, S, T, params, cfg.n_steps, return_paths, first_tile)
    return out


def simulate_bates_maturities(seed: int, S0, r, Ts, params: BatesParams, cfg: MCConfig,
                              return_variance: bool = False, first_tile: int = 0,
                              scheme: str = "euler",
                              device: Optional[torch.device] = None):
    """Bates path matrices of every maturity in ``Ts``: one batched Heston
    paths launch (simulate_heston_maturities) and one overlay launch over
    the same (n_mat, n_steps+1, n_pad) matrix, maturity m on the tiles the
    Heston kernel drew it on. Returns S [and v]."""
    _check_no_grad(S0, r, 0.0, params)
    out = simulate_heston_maturities(seed, S0, r, Ts, params.heston, cfg,
                                     return_variance=return_variance, first_tile=first_tile,
                                     scheme=scheme, device=device)
    from options_model_tpu_torch.ops import cuda_jumps

    cuda_jumps.jump_overlay_paths(out[0] if return_variance else out, seed, Ts, params,
                                  first_tile)
    return out
