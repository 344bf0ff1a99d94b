"""Synthetic IV data oracles, as options_model_tpu/data/synthetic.py:

    iv = 0.2 + 0.1 |log m| + 0.05 (log m)^2 + 0.02 sqrt(T),  clipped to [0.05, 1]

in float64 numpy (the port keeps its own copy; it imports nothing of the
JAX package).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_iv_smile(K, T, S0: float = 100.0) -> np.ndarray:
    """Analytic IV smile at strike(s) K, expiry(ies) T."""
    K = np.asarray(K, np.float64)
    T = np.asarray(T, np.float64)
    logm = np.log(K / S0)
    iv = 0.2 + 0.1 * np.abs(logm) + 0.05 * logm**2 + 0.02 * np.sqrt(T)
    return np.clip(iv, 0.05, 1.0)


def synthetic_smile_surface(S0: float = 100.0, strikes=None, expiries_days=(30, 60, 90),
                            noise_std: float = 0.0, seed: int = 0
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Flattened (K, T, iv, S0) over a strike x expiry grid (40 strikes in
    [60, 140] x 3 expiries by default), with optional IV noise from
    ``default_rng(seed)``."""
    if strikes is None:
        strikes = np.linspace(60.0, 140.0, 40)
    T = np.asarray(expiries_days, np.float64) / 365.0
    Km, Tm = np.meshgrid(strikes, T)
    K, T = Km.reshape(-1), Tm.reshape(-1)
    iv = synthetic_iv_smile(K, T, S0)
    if noise_std > 0:
        rng = np.random.default_rng(seed)
        iv = np.clip(iv + rng.normal(0, noise_std, iv.shape), 0.05, 1.0)
    return K, T, iv, S0
