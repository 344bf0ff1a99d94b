"""Cox-Ross-Rubinstein binomial tree — the accuracy oracle.

The NumPy float64 backward induction of options_model_tpu/pricers/binomial.py,
copied so that the oracle runs where JAX is not installed (importing it from
the JAX package runs that package's __init__, which imports JAX), and the
reference's native C++ tree (native/crr.cpp, a copy of
options_model_tpu/native/crr.cpp): the same semantics, faster on large
trees. ``use_native=True`` builds it at first use with
``g++ -O3 -shared -fPIC`` into build/native/ at the root of the checkout
(listed in .gitignore) and calls it through ctypes; a failed build raises,
there is no quiet fallback. The NumPy tree is its plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

NATIVE_SOURCE = Path(__file__).resolve().parent.parent / "native" / "crr.cpp"
NATIVE_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
NATIVE_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_native: Optional[ctypes.CDLL] = None


def native_library() -> ctypes.CDLL:
    """The native tree, built at first use (the file name carries a hash of
    the source and flags); raises when g++ fails or the library cannot load."""
    global _native
    if _native is None:
        h = hashlib.sha256(" ".join(NATIVE_FLAGS).encode() + NATIVE_SOURCE.read_bytes())
        out = NATIVE_BUILD_DIR / f"libcrr_{h.hexdigest()[:16]}.so"
        if not out.exists():
            NATIVE_BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(["g++", *NATIVE_FLAGS, "-o", str(tmp), str(NATIVE_SOURCE)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to build {NATIVE_SOURCE} "
                                   f"({proc.returncode}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        d, i = ctypes.c_double, ctypes.c_int
        lib.crr_price_q.argtypes = [d, d, d, d, d, d, i, i, i]
        lib.crr_price_q.restype = d
        _native = lib
    return _native


def crr_price(S0: float, K: float, T: float, r: float, sigma: float,
              cp: float = 1.0, n_steps: int = 2048, american: bool = True,
              q: float = 0.0, use_native: bool = False) -> float:
    """CRR binomial price. cp=+1 call / -1 put; american=False gives the
    European tree (useful to sanity-check convergence to Black-Scholes);
    ``q`` is the continuous dividend yield (growth r-q, discount r).
    ``use_native`` runs the C++ tree (native_library) instead of NumPy."""
    if use_native:
        out = native_library().crr_price_q(S0, K, T, r, q, sigma, 1 if cp > 0 else -1,
                                           int(n_steps), 1 if american else 0)
        if np.isnan(out):
            raise ValueError("CRR risk-neutral prob outside (0,1); reduce dt")
        return float(out)
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
                 q: float = 0.0, use_native: bool = False) -> float:
    return crr_price(S0, K, T, r, sigma, cp, n_steps, american=True, q=q,
                     use_native=use_native)
