"""Synthetic Heston, Bates and Variance Gamma surfaces with known true
parameters, the calibration test oracle, as
options_model_tpu/calibration/synthetic.py: exact COS prices inverted
through the IV solver, plus optional Gaussian noise.

The oracle runs on ``device`` (the card by default, the CPU only when asked
for) in the working precision ``dtype``: float32 carries the chain's ~1e-4
IV rounding, so a fit to it bottoms out at the data's floor (~1e-3 weighted
RMSE); float64 data is clean to < 1e-7. The noise comes from
``np.random.default_rng(seed)`` on the host, so the reference and the port
add the same draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from options_model_tpu_torch.calibration.charfn import (bates_cos_price, heston_cos_price,
                                                        vg_cos_price)
from options_model_tpu_torch.core.config import BatesParams, HestonParams, VGParams
from options_model_tpu_torch.ops.engine import checked_device
from options_model_tpu_torch.pricers.blackscholes import implied_vol


def create_synthetic_heston_surface(
    params: HestonParams,
    S0: float = 100.0,
    rate: float = 0.05,
    strikes: Optional[np.ndarray] = None,
    expiries_days=(30, 60, 90, 180),
    noise_std: float = 0.0,
    seed: int = 0,
    dtype=np.float32,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(strikes, expiries, ivs), float64 numpy flattened over the expiry x
    strike grid. ``params`` may also be BatesParams or VGParams: the
    matching COS pricer runs."""
    device = checked_device(device)
    if strikes is None:
        strikes = np.linspace(80.0, 120.0, 15)
    expiries = np.asarray(expiries_days, np.float64) / 365.0
    K, T = np.meshgrid(strikes, expiries)
    K, T = K.reshape(-1), T.reshape(-1)

    tdt = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32
    pricer = (bates_cos_price if isinstance(params, BatesParams)
              else vg_cos_price if isinstance(params, VGParams) else heston_cos_price)
    # VG's short-dated points need a long series (polynomial char-fn decay).
    n_terms = 4096 if isinstance(params, VGParams) else 256
    Kt = torch.as_tensor(K, dtype=tdt, device=device)
    Tt = torch.as_tensor(T, dtype=tdt, device=device)
    prices = pricer(S0, Kt, Tt, rate, params, cp=1.0, n_terms=n_terms, dtype=tdt)
    ivs = implied_vol(prices, S0, Kt, Tt, rate, cp=1.0).cpu().numpy().astype(np.float64)

    if noise_std > 0:
        rng = np.random.default_rng(seed)
        ivs = ivs + rng.normal(0.0, noise_std, ivs.shape)

    ivs = np.clip(ivs, 0.011, 1.99)
    return K, T, ivs


def create_synthetic_bates_surface(
    params: BatesParams,
    S0: float = 100.0,
    rate: float = 0.05,
    strikes: Optional[np.ndarray] = None,
    expiries_days=(7, 30, 90, 180, 365),
    noise_std: float = 0.0,
    seed: int = 0,
    dtype=np.float32,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bates oracle surface. The expiry ladder reaches down to one week: the
    jump triple is identified by short-dated smiles."""
    return create_synthetic_heston_surface(
        params, S0=S0, rate=rate, strikes=strikes, expiries_days=expiries_days,
        noise_std=noise_std, seed=seed, dtype=dtype, device=device)


def create_synthetic_vg_surface(
    params: VGParams,
    S0: float = 100.0,
    rate: float = 0.05,
    strikes: Optional[np.ndarray] = None,
    expiries_days=(7, 30, 90, 180, 365, 730),
    noise_std: float = 0.0,
    seed: int = 0,
    dtype=np.float32,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Variance Gamma oracle surface. The ladder spans a week to two years:
    VG's excess kurtosis decays like nu/T, so the smile's term structure
    identifies nu while the short-dated skew pins theta."""
    return create_synthetic_heston_surface(
        params, S0=S0, rate=rate, strikes=strikes, expiries_days=expiries_days,
        noise_std=noise_std, seed=seed, dtype=dtype, device=device)
