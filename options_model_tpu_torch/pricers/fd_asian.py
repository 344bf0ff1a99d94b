"""Float64 Hull-White (1993) representative-average binomial oracle for
American fixed-strike Asian options: a NumPy copy of
options_model_tpu/pricers/fd_asian.py, the port's anchor for
pricers/american_asian.py (a lattice with an error structure of its own:
no regression, no sampling), run on the host.

A CRR tree with ``substeps`` binomial steps per monitoring date (averaging
and exercise stay on the monitoring grid, lsm_asian_backward's
convention). The running sum is collapsed onto M representative values per
node, linearly spaced between the node's exact min/max reachable sums (a
forward DP); the backward induction interpolates child values linearly at
the propagated sums, which biases the price slightly high (convergence from
above in M).
"""

from __future__ import annotations

import numpy as np


def _extreme_sums(S_nodes, monitored):
    """Forward DP for the min/max reachable monitored-price sums per node.

    S_nodes[k] is the (k+1,) vector of prices at step k (index j = number of
    up moves); monitored[k] says whether step k adds S to the running sum.
    Returns lists Gmin, Gmax with Gmin[k] of shape (k+1,).
    """
    n = len(S_nodes) - 1
    Gmin = [np.zeros(1)]
    Gmax = [np.zeros(1)]
    for k in range(1, n + 1):
        prev_lo, prev_hi = Gmin[k - 1], Gmax[k - 1]
        lo = np.empty(k + 1)
        hi = np.empty(k + 1)
        # predecessor via down move keeps j; via up move comes from j-1
        lo[:k] = prev_lo
        lo[k] = prev_lo[k - 1]
        lo[1:k] = np.minimum(lo[1:k], prev_lo[:k - 1])
        hi[:k] = prev_hi
        hi[k] = prev_hi[k - 1]
        hi[1:k] = np.maximum(hi[1:k], prev_hi[:k - 1])
        if monitored[k]:
            lo = lo + S_nodes[k]
            hi = hi + S_nodes[k]
        Gmin.append(lo)
        Gmax.append(hi)
    return Gmin, Gmax


def _interp_rows(grid, values, x):
    """Row-wise linear interpolation: grid/values (J, M), x (J, M) -> (J, M).
    Clips to the grid ends (the propagated sum is always reachable, so
    clipping only absorbs float round-off at the boundaries)."""
    J, M = grid.shape
    out = np.empty_like(x)
    for j in range(J):
        out[j] = np.interp(x[j], grid[j], values[j])
    return out


def asian_binomial_price(S0, K, T, r, sigma, n_monitor: int, cp=1.0,
                         div_yield=0.0, substeps: int = 6, n_avg: int = 192,
                         american: bool = True) -> float:
    """Fixed-strike Asian option on the running average of the monitoring
    dates t_i = i*T/n_monitor (i = 1..n_monitor). ``american=True`` allows
    exercise at every monitoring date (the Bermudan lsm_asian_backward
    prices); ``american=False`` is the European contract — compare it to
    price_asian_mc to isolate the lattice's dynamics error from the early
    exercise treatment (tests do exactly this difference-of-differences).
    """
    n = n_monitor * substeps
    dt = T / n
    u = float(np.exp(sigma * np.sqrt(dt)))
    d = 1.0 / u
    p = (np.exp((r - div_yield) * dt) - d) / (u - d)
    if not 0.0 < p < 1.0:
        raise ValueError(f"CRR branch probability out of range: p={p}")
    disc = float(np.exp(-r * dt))

    S_nodes = [S0 * u ** (2 * np.arange(k + 1, dtype=np.float64) - k)
               for k in range(n + 1)]
    monitored = [k > 0 and k % substeps == 0 for k in range(n + 1)]
    m_count = np.cumsum([1 if m else 0 for m in monitored])  # dates so far
    Gmin, Gmax = _extreme_sums(S_nodes, monitored)

    def rep_grid(k):
        lo, hi = Gmin[k], Gmax[k]
        w = np.linspace(0.0, 1.0, n_avg)
        return lo[:, None] + (hi - lo)[:, None] * w[None, :]

    grid = rep_grid(n)
    A = grid / n_monitor
    V = np.maximum(cp * (A - K), 0.0)

    for k in range(n - 1, -1, -1):
        g = rep_grid(k)  # (k+1, M) sums at step k
        child = rep_grid(k + 1)
        add = (S_nodes[k + 1] if monitored[k + 1]
               else np.zeros(k + 2, dtype=np.float64))
        # up child: node j -> (k+1, j+1); down child: node j -> (k+1, j)
        g_up = g + add[1:][:, None]
        g_dn = g + add[:-1][:, None]
        V_up = _interp_rows(child[1:], V[1:], g_up)
        V_dn = _interp_rows(child[:-1], V[:-1], g_dn)
        cont = disc * (p * V_up + (1.0 - p) * V_dn)
        if american and monitored[k]:
            A_k = g / m_count[k]
            cont = np.maximum(cont, cp * (A_k - K))
        V = cont

    return float(V[0, 0])
