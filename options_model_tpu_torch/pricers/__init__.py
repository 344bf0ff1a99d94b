"""Pricers, with the names the reference exports
(options_model_tpu/pricers/__init__.py) that are ported:

- blackscholes: closed form, Greeks (closed form and autograd), implied vol
- binomial:     CRR binomial oracle (native C++ build)
- european:     Monte-Carlo Europeans on the terminal kernels
- american:     Longstaff-Schwartz (poly and NN regressors) with the CV legs
- dual:         the martingale-dual upper bound and the primal-dual bracket
- fd_heston:    the Heston ADI oracle; fd_sabr: the SABR ADI oracle
- surface_american: strike x maturity surfaces on shared paths
- basket:       multi-asset European baskets, rainbows and spreads (kernel 28,
                the geometric-basket CV)
- american_basket: multi-asset Bermudan LSM on kernel 27's paths
- exotics:      Asian (Kemna-Vorst CV) and lookback options
- barrier:      barrier options (Brownian-bridge correction, Reiner-Rubinstein)
- american_asian: American Asian LSM on the (S, running average) state
- fd_asian:     the Hull-White representative-average binomial oracle (float64)
- varswap:      variance and volatility swaps (closed forms per family, MC)

Each name is imported from its module at first access, so importing the
package imports no pricer."""

import importlib

_EXPORTS = {
    "bs_price": "blackscholes", "bs_greeks": "blackscholes",
    "bs_greeks_closed_form": "blackscholes", "bs_vega": "blackscholes",
    "bs_delta": "blackscholes",
    "crr_american": "binomial", "crr_price": "binomial",
    "price_european_mc": "european",
    "price_american_lsm": "american", "price_american_with_control_variate": "american",
    "price_american": "american",
    "price_american_bracket": "dual",
    "heston_fd_price": "fd_heston", "sabr_fd_price": "fd_sabr",
    "price_american_surface": "surface_american",
    "price_european_surface_mc": "surface_american",
    "price_barrier_mc": "barrier",
    "price_basket_mc": "basket", "geometric_basket_bs_price": "basket",
    "price_american_basket": "american_basket",
    "price_american_asian": "american_asian",
    "price_asian_mc": "exotics", "price_lookback_mc": "exotics",
    "geometric_asian_bs_price": "exotics",
    "asian_binomial_price": "fd_asian",
    "forward_varswap_strike": "varswap", "varswap_mc": "varswap", "varswap_pv": "varswap",
    "varswap_strike": "varswap", "varswap_strike_replication": "varswap",
}
__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
