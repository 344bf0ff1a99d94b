"""American option surfaces, strike x maturity grids on shared paths, as
options_model_tpu/pricers/surface_american.py (single device).

1. Paths do not depend on the strike, so all strikes of a maturity share one
   path matrix.
2. The per-strike LSM basis is a linear reparametrization of one
   strike-independent basis B = [1, u, u^2, u^3] in the globally centered
   u (plus [w, w^2, u w] in the centered variance under Heston), so the
   fitted values depend only on span(B) and each strike's in-the-money
   mask. Each date's all-strike regression is therefore two matmuls,
   masks and mask-weighted cash (n_K, P) against the products of B, and a
   batched (n_K, d, d) Cholesky solve.
3. Under Heston and Bates, maturities are simulated in groups of
   g = max(1, 2^20 * 51 // (n_pad * (n_steps + 1))), one launch of the
   batched paths kernel per group (models/heston.simulate_heston_maturities;
   Bates adds one launch of the jump overlay over the same group,
   models/bates.simulate_bates_maturities), and the backward runs on each
   maturity's slice. A group holds at most the
   path-steps of 2^20 paths x 50 steps (428 MB with v) unless one maturity
   needs more: a 64-maturity surface at 16,384 paths x 50 steps is one
   launch; from 2^20 paths x 50 steps per maturity on, g = 1 and peak memory
   is one path matrix. (The reference runs maturities
   one after another: batching them lost its tuned Pallas tile on the TPU.)
   GBM and Merton maturities run one after another, one paths launch each.

Maturity i draws tiles [i * n_tiles, (i + 1) * n_tiles) of one seed's
stream, so row i of a surface does not depend on how many maturities follow
it, nor on how they are grouped (the reference folds the maturity index into
its key instead).

The curve sweep (price_american_curves_shared, price_american_curve_shared)
is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from options_model_tpu_torch._unported import not_ported
from options_model_tpu_torch.core.config import BatesParams, HestonParams, MCConfig, MertonParams
from options_model_tpu_torch.models.bates import simulate_bates_maturities
from options_model_tpu_torch.models.blocks import paths_rounded
from options_model_tpu_torch.models.heston import simulate_heston_maturities
from options_model_tpu_torch.ops.cuda_heston import PATH_TILE, TERMINAL_TILE
from options_model_tpu_torch.ops.engine import resolve_device, resolve_engine
from options_model_tpu_torch.ops.philox import seed_from_generator
from options_model_tpu_torch.pricers.american import (_discount, _pair_block,
                                                      simulate_seeded, simulated_config)
from options_model_tpu_torch.pricers.european import make_terminal_sampler
from options_model_tpu_torch.pricers.regressors import solve_spd_small


# Path matrix entries ((n_steps+1) x paths) per batched paths launch: 2^20
# paths x 50 steps, the shape at which the paths kernels fill the card
# (2^19 antithetic pairs), 214 MB of S and as much of v.
BATCH_ENTRIES = 51 << 20


def maturity_group(n_pad: int, n_steps: int) -> int:
    """Maturities per batched paths launch at n_pad paths x n_steps steps
    per maturity."""
    return max(1, BATCH_ENTRIES // (n_pad * (n_steps + 1)))


def _gram_index(d: int):
    """The upper-triangle index pairs of a (d, d) Gram and the (d, d) map
    from an entry to its pair, which rebuilds the symmetric matrix."""
    pairs = [(i, j) for i in range(d) for j in range(i, d)]
    pair_of = {}
    for idx, (i, j) in enumerate(pairs):
        pair_of[(i, j)] = pair_of[(j, i)] = idx
    return pairs, [[pair_of[(i, j)] for j in range(d)] for i in range(d)]


def _centered(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean()
    std = torch.sqrt(torch.clamp_min(((x - mean) ** 2).mean(), 1e-12))
    return (x - mean) / std


def lsm_surface_backward(S_paths: torch.Tensor, strikes, rate, T, cp: float = -1.0,
                         ridge: float = 1e-6, return_cash: bool = False,
                         v_paths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LSM backward induction for all strikes at once on shared paths.

    S_paths: (n_steps+1, P); strikes: (n_K,). Returns prices (n_K,), or with
    ``return_cash`` the per-path discounted cashflows (n_K, P). ``v_paths``
    (Heston) extends the basis with [w, w^2, u w] (d = 7 instead of 4).

    The Grams run in full float32 (``torch.matmul``): TF32 keeps ~3 digits
    and the n_K Cholesky solves drift, so this raises if TF32 is on."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("lsm_surface_backward needs full float32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    n_steps = S_paths.shape[0] - 1
    dtype, device = S_paths.dtype, S_paths.device
    disc = _discount(rate, np.float32(T) / np.float32(n_steps))
    K = torch.as_tensor(strikes, dtype=dtype, device=device).reshape(-1, 1)  # (n_K, 1)

    d = 4 if v_paths is None else 7
    pairs, gram = _gram_index(d)
    gram = torch.tensor(gram, device=device)
    eye = torch.eye(d, dtype=dtype, device=device)

    cash = torch.clamp_min(cp * (S_paths[-1][None, :] - K), 0.0)        # (n_K, P)
    for t in range(n_steps - 1, 0, -1):
        S_t = S_paths[t]
        cash = cash * disc
        u = _centered(S_t)
        cols = [torch.ones_like(u), u, u * u, u * u * u]
        if v_paths is not None:
            w = _centered(v_paths[t])
            cols += [w, w * w, u * w]
        B = torch.stack(cols)                                            # (d, P)

        immediate = torch.clamp_min(cp * (S_t[None, :] - K), 0.0)       # (n_K, P)
        W = (immediate > 0).to(dtype)
        # every strike's sufficient statistics in two matmuls:
        #   A_k[i, j] = sum_p W_k(p) B_i(p) B_j(p),  b_k[i] = sum_p W_k(p) cash_k(p) B_i(p)
        prods = torch.stack([B[i] * B[j] for i, j in pairs])            # (n_pairs, P)
        A = (W @ prods.T)[:, gram]                                       # (n_K, d, d)
        b = (W * cash) @ B.T                                             # (n_K, d)
        trace = A.diagonal(dim1=-2, dim2=-1).sum(-1)
        A = A + (ridge * (trace / d + 1.0))[:, None, None] * eye
        continuation = solve_spd_small(A, b) @ B                         # (n_K, P)
        exercise = (immediate > continuation) & (immediate > 0)
        cash = torch.where(exercise, immediate, cash)
    cash = cash * disc
    return cash if return_cash else cash.mean(dim=1)


def _pair_stderr(cash: torch.Tensor, pair_block: Optional[int]) -> torch.Tensor:
    """Per-row stderr of (n_K, P) cashflows over antithetic pair means, the
    batched core/stats.masked_mean_stderr without a mask."""
    x = cash
    if pair_block is not None:
        x = x.reshape(x.shape[0], -1, 2, pair_block // 2).mean(dim=2).reshape(x.shape[0], -1)
    var = ((x - x.mean(dim=1, keepdim=True)) ** 2).mean(dim=1)
    return torch.sqrt(var / x.shape[1])


def price_american_surface(generator: torch.Generator, S0, strikes, maturities, rate,
                           mc: MCConfig, *, cp: float = -1.0, model: str = "heston",
                           sigma=None, heston: Optional[HestonParams] = None,
                           merton: Optional[MertonParams] = None,
                           bates: Optional[BatesParams] = None,
                           engine: str = "auto", heston_scheme: str = "euler",
                           div_yield=0.0, variance_basis: bool = True, mesh=None,
                           return_stderr: bool = False, device=None):
    """American option surface (n_maturities, n_strikes), GBM, Heston (Euler
    or QE-M), Merton or Bates, one path matrix per maturity shared by every
    strike; Heston and Bates maturities simulated maturity_group(n_pad,
    n_steps) at a time.

    ``return_stderr`` also returns the per-cell stderr over antithetic pair
    means, (prices, stderrs). ``mesh``: a ``torch.distributed`` DeviceMesh;
    more than one device (maturity sharding) is not ported."""
    if mesh is not None and mesh.size() > 1:
        raise not_ported("a multi-device mesh (maturity-sharded surface)",
                         "pricers.surface_american._surface_impl")
    if model not in ("gbm", "heston", "merton", "bates"):
        raise not_ported(f"model={model!r}",
                         "pricers.surface_american.price_american_surface")
    device = resolve_device(device)
    resolve_engine(engine, device)
    seed = seed_from_generator(generator)
    mc = simulated_config(mc, model)
    n_tiles = mc.n_paths // PATH_TILE
    strikes = torch.as_tensor(np.asarray(strikes, np.float32), device=device)
    if model == "bates":
        if bates is None:
            raise ValueError("bates params required for model='bates'")
        heston = bates.heston
    want_v = model in ("heston", "bates") and heston is not None and variance_basis
    stat_pb = _pair_block(mc, model) if mc.antithetic else None

    prices, stderrs = [], []

    def price_maturity(S_paths, v_paths, T):
        cash = lsm_surface_backward(S_paths, strikes, rate, T, cp, return_cash=True,
                                    v_paths=v_paths)
        prices.append(cash.mean(dim=1))
        if return_stderr:
            stderrs.append(_pair_stderr(cash, stat_pb))

    Ts = np.asarray(maturities, np.float32).reshape(-1).tolist()
    if model in ("heston", "bates"):
        if heston is None:
            raise ValueError("heston params required for model='heston'")
        g = maturity_group(n_tiles * PATH_TILE, mc.n_steps)
        for i0 in range(0, len(Ts), g):
            group = Ts[i0:i0 + g]
            kw = dict(return_variance=want_v, first_tile=i0 * n_tiles, scheme=heston_scheme,
                      device=device)
            out = (simulate_bates_maturities(seed, S0, rate - div_yield, group, bates, mc, **kw)
                   if model == "bates" else
                   simulate_heston_maturities(seed, S0, rate - div_yield, group, heston, mc,
                                              **kw))
            S_all, v_all = out if want_v else (out, None)
            for m, T in enumerate(group):
                price_maturity(S_all[m], None if v_all is None else v_all[m], T)
    else:
        for i, T in enumerate(Ts):
            S_paths = simulate_seeded(seed, i * n_tiles, S0, T, mc, model, sigma=sigma,
                                      merton=merton, drift=rate - div_yield, device=device)
            price_maturity(S_paths, None, T)
    if return_stderr:
        return torch.stack(prices), torch.stack(stderrs)
    return torch.stack(prices)


def price_european_surface_mc(generator: torch.Generator, S0, strikes, maturities, rate,
                              mc: MCConfig, *, cp: float = 1.0, model: str = "heston",
                              sigma=None, heston: Optional[HestonParams] = None,
                              engine: str = "auto", div_yield=0.0,
                              device=None) -> torch.Tensor:
    """European surface (n_maturities, n_strikes) on shared terminal samples:
    one terminal-kernel run per maturity (tiles [i * n_tiles, ...) of one
    seed's stream), payoffs over every strike."""
    device = resolve_device(device)
    seed = seed_from_generator(generator)
    n_tiles = -(-paths_rounded(mc) // TERMINAL_TILE)
    chunk = dataclasses.replace(mc, n_paths=n_tiles * TERMINAL_TILE)
    K = torch.as_tensor(np.asarray(strikes, np.float32), device=device).reshape(-1, 1)
    rows = []
    for i, T in enumerate(np.asarray(maturities, np.float32).reshape(-1).tolist()):
        sampler = make_terminal_sampler(model, S0, rate, T, sigma=sigma, heston=heston,
                                        engine=engine, div_yield=div_yield,
                                        device=device)
        S_T = sampler(seed, i * n_tiles, chunk)
        pay = torch.clamp_min(cp * (S_T[None, :] - K), 0.0).mean(dim=1)
        rows.append(pay * _discount(rate, T))
    return torch.stack(rows)
