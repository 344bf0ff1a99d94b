"""European Monte-Carlo pricing with streaming Welford statistics, as
options_model_tpu/pricers/european.py (GBM, Heston Euler and QE-M, Merton,
Bates, Variance Gamma, SABR, rough Bergomi and local-vol terminal
samplers: over a
compiled table, or a bare ``sigma_fn``), and the one-draw exact GBM price.

The terminal kernels (csrc/, or their plain versions on the CPU) never
materialize a path matrix. Chunks are keyed by global tile: chunk c runs
tiles [c * chunk_tiles, ...) of one seed's stream, so the price is the same
for every chunk size, where the reference's TPU sampler folds the chunk into
the key instead.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from options_model_tpu_torch._unported import not_ported
from options_model_tpu_torch.core.config import (BatesParams, HestonParams, MCConfig,
                                                 MertonParams, OptionSpec, RBergomiParams,
                                                 SABRParams, VGParams)
from options_model_tpu_torch.core.payoff import vanilla_payoff
from options_model_tpu_torch.core.stats import (pair_mean_reduce, welford_empty,
                                                welford_from_batch, welford_merge)
from options_model_tpu_torch.models.blocks import paths_rounded
from options_model_tpu_torch.models.gbm import gbm_terminal_exact
from options_model_tpu_torch.models.localvol import simulate_local_vol
from options_model_tpu_torch.models.rbergomi import simulate_rbergomi
from options_model_tpu_torch.models.sabr import simulate_sabr
from options_model_tpu_torch.models.vg import vg_terminal_exact
from options_model_tpu_torch.ops.cuda_gbm import gbm_terminal
from options_model_tpu_torch.ops.cuda_heston import (PATH_TILE, TERMINAL_TILE, heston_terminal,
                                                     heston_terminal_qe)
from options_model_tpu_torch.ops.cuda_jumps import jump_overlay_terminal, merton_terminal
from options_model_tpu_torch.ops.cuda_localvol import localvol_terminal
from options_model_tpu_torch.ops.engine import checked_device, resolve_device, resolve_engine
from options_model_tpu_torch.ops.philox import seed_from_generator
from options_model_tpu_torch.surface.cheb import LocalVolTable

# sampler(seed, first_tile, chunk_cfg) -> S_T (chunk_cfg.n_paths,), where
# chunk_cfg.n_paths is a whole number of the sampler's ``pair_block`` tiles;
# the sampler also carries the ``device`` its samples land on.
TerminalSampler = Callable[[int, int, MCConfig], torch.Tensor]


def make_terminal_sampler(model: str, S0, r, T, *, sigma=None,
                          heston: Optional[HestonParams] = None,
                          merton: Optional[MertonParams] = None,
                          bates: Optional[BatesParams] = None,
                          vg: Optional[VGParams] = None, sabr: Optional[SABRParams] = None,
                          rbergomi: Optional[RBergomiParams] = None, sigma_fn=None, engine: str = "auto", heston_scheme: str = "euler",
                          localvol_table: Optional[LocalVolTable] = None,
                          div_yield=0.0, device=None) -> TerminalSampler:
    """Terminal-price sampler for GBM (log-Euler), Heston (full-truncation
    Euler, or QE-M with ``heston_scheme="qe"``), Merton, Bates (the Heston
    terminal kernel of ``heston_scheme``, then the terminal jump overlay
    multiplied into its output in place), VG (kernel 22's one exact step,
    whatever ``n_steps``), SABR (kernel 24: the forward from F0 = S0 e^{(r -
    q) T}, which is S_T at expiry), rough Bergomi (the fused kernel in its
    terminal mode, on PATH_TILE tiles) or local vol, on the terminal
    kernels: over a compiled Chebyshev ``localvol_table`` (which takes
    precedence), else under a bare ``sigma_fn(S, tau)``
    (models/localvol.simulate_local_vol's bare route, the same tiles and
    normals). ``div_yield``:
    the sampler's drift is r - q; the pricer still discounts at r. The
    sampler's ``pair_block`` is TERMINAL_TILE, the kernels' antithetic
    mirror granularity and the unit of ``first_tile``. A call draws tiles
    [first_tile, ...) of its seed's stream; Bates's overlay takes the same
    seed and tiles (counter word 3 = 1), so chunks never share a jump draw
    and the price does not depend on the chunk size."""
    device = resolve_device(device)
    resolve_engine(engine, device)
    drift = r - div_yield
    if model == "gbm":
        if sigma is None:
            raise ValueError("sigma is required for model='gbm'")

        def fn(seed, first_tile, c):
            return gbm_terminal(seed, S0, drift, sigma, T, c.n_paths, c.n_steps,
                                c.antithetic, first_tile, device)
    elif model in ("heston", "bates"):
        if model == "bates":
            if bates is None:
                raise ValueError("bates params required for model='bates'")
            heston = bates.heston
        if heston is None:
            raise ValueError("heston params required for model='heston'")
        if heston_scheme not in ("euler", "qe"):
            raise ValueError(f"heston_scheme must be 'euler' or 'qe', got "
                             f"{heston_scheme!r}")
        kernel = heston_terminal_qe if heston_scheme == "qe" else heston_terminal

        def fn(seed, first_tile, c):
            S_T = kernel(seed, S0, drift, T, heston, c.n_paths, c.n_steps,
                         c.antithetic, first_tile, device)
            if model == "bates":
                jump_overlay_terminal(S_T, seed, T, bates, c.n_steps, first_tile)
            return S_T
    elif model == "merton":
        if merton is None:
            raise ValueError("merton params required for model='merton'")

        def fn(seed, first_tile, c):
            return merton_terminal(seed, S0, drift, T, merton, c.n_paths, c.n_steps,
                                   c.antithetic, first_tile, device)
    elif model == "vg":
        if vg is None:
            raise ValueError("vg params required for model='vg'")

        def fn(seed, first_tile, c):
            return vg_terminal_exact(seed, S0, drift, T, vg, c, first_tile, device)
    elif model == "sabr":
        if sabr is None:
            raise ValueError("sabr params required for model='sabr'")
        f = np.float32
        F0 = float(f(S0) * np.exp(f(drift) * f(T)))

        def fn(seed, first_tile, c):
            return simulate_sabr(seed, F0, T, sabr, c, first_tile=first_tile, device=device)
    elif model == "rbergomi":
        if rbergomi is None:
            raise ValueError("rbergomi params required for model='rbergomi'")

        def fn(seed, first_tile, c):
            return simulate_rbergomi(seed, S0, T, rbergomi, c, drift, first_tile=first_tile,
                                     device=device)
    elif model == "localvol" and localvol_table is not None:
        def fn(seed, first_tile, c):
            return localvol_terminal(seed, S0, drift, T, localvol_table, c.n_paths,
                                     c.n_steps, c.antithetic, first_tile, device)
    elif model == "localvol":
        if sigma_fn is None:
            raise ValueError("sigma_fn required for model='localvol'")

        def fn(seed, first_tile, c):
            return simulate_local_vol(seed, S0, drift, T, c, sigma_fn=sigma_fn,
                                      return_paths=False, first_tile=first_tile, device=device)
    else:
        raise not_ported(f"model={model!r}", "pricers.european.make_terminal_sampler")
    fn.pair_block = PATH_TILE if model == "rbergomi" else TERMINAL_TILE
    fn.device = device
    return fn


def price_european_mc(generator: torch.Generator, sampler: TerminalSampler,
                      spec: OptionSpec, T, cfg: MCConfig,
                      max_paths_per_chunk: int = 1 << 21):
    """Price a European option by streaming chunks of terminal samples.

    Returns (price, stderr, n_paths) as tensors. The path count rounds up to
    whole sampler tiles; chunking only bounds memory. The stderr is over
    antithetic pair means, the i.i.d. unit (core/stats.pair_mean_reduce)."""
    seed = seed_from_generator(generator)
    tile = sampler.pair_block
    n_tiles = -(-paths_rounded(cfg) // tile)
    chunk_tiles = max(1, min(n_tiles, max_paths_per_chunk // tile))
    discount = float(np.exp(-np.float32(spec.rate) * np.float32(T)))

    state = welford_empty(cfg.dtype, sampler.device)
    for first in range(0, n_tiles, chunk_tiles):
        c = dataclasses.replace(cfg, n_paths=min(chunk_tiles, n_tiles - first) * tile)
        payoffs = vanilla_payoff(sampler(seed, first, c), spec.strike, spec.cp) * discount
        if cfg.antithetic:
            payoffs = pair_mean_reduce(payoffs, tile)
        state = welford_merge(state, welford_from_batch(payoffs))
    # count reports simulated paths (pairs count double under the reduction)
    n = state.count * (2.0 if cfg.antithetic else 1.0)
    return state.mean, state.stderr, n


def price_european_gbm_exact(generator: torch.Generator, S0, spec: OptionSpec, T,
                             n_paths: int = 1 << 20, antithetic: bool = True,
                             device=None):
    """One-draw exact-terminal GBM European price (models/gbm.
    gbm_terminal_exact, the terminal kernel at one step): (price, stderr,
    n_paths) as tensors. The path count rounds up to whole TERMINAL_TILE
    tiles, and antithetic pairs reduce at that tile, the kernel's mirror
    granularity (the reference pairs (i, i + n/2))."""
    device = checked_device(device)
    S_T = gbm_terminal_exact(seed_from_generator(generator), S0,
                             spec.rate - spec.div_yield, spec.sigma, T, n_paths,
                             antithetic, device=device)
    discount = float(np.exp(-np.float32(spec.rate) * np.float32(T)))
    payoffs = vanilla_payoff(S_T, spec.strike, spec.cp) * discount
    if antithetic:
        payoffs = pair_mean_reduce(payoffs, TERMINAL_TILE)
    st = welford_from_batch(payoffs)
    return st.mean, st.stderr, st.count * (2.0 if antithetic else 1.0)
