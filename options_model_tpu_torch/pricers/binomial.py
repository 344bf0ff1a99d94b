"""Cox-Ross-Rubinstein binomial tree — the accuracy oracle.

The NumPy float64 backward induction of options_model_tpu/pricers/binomial.py,
copied so that the oracle runs where JAX is not installed (importing it from
the JAX package runs that package's __init__, which imports JAX). The
reference's optional native C++ tree (options_model_tpu/native/crr.cpp) is
not carried: it has the same semantics and only runs faster.
"""

from __future__ import annotations

import numpy as np


def crr_price(S0: float, K: float, T: float, r: float, sigma: float,
              cp: float = 1.0, n_steps: int = 2048, american: bool = True,
              q: float = 0.0) -> float:
    """CRR binomial price. cp=+1 call / -1 put; american=False gives the
    European tree (useful to sanity-check convergence to Black-Scholes);
    ``q`` is the continuous dividend yield (growth r-q, discount r)."""
    dt = T / n_steps
    u = np.exp(sigma * np.sqrt(dt))
    d = 1.0 / u
    disc = np.exp(-r * dt)
    p = (np.exp((r - q) * dt) - d) / (u - d)
    if not (0.0 < p < 1.0):
        raise ValueError(f"CRR risk-neutral prob p={p} outside (0,1); reduce dt")

    j = np.arange(n_steps + 1, dtype=np.float64)
    S_T = S0 * u ** (2.0 * j - n_steps)
    value = np.maximum(cp * (S_T - K), 0.0)

    for step in range(n_steps - 1, -1, -1):
        value = disc * (p * value[1:] + (1.0 - p) * value[:-1])
        if american:
            S_t = S0 * u ** (2.0 * j[: step + 1] - step)
            value = np.maximum(value, cp * (S_t - K))

    return float(value[0])


def crr_american(S0, K, T, r, sigma, cp=1.0, n_steps: int = 2048,
                 q: float = 0.0) -> float:
    return crr_price(S0, K, T, r, sigma, cp, n_steps, american=True, q=q)
