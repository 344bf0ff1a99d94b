"""Pricers: Black-Scholes, European MC, American LSM, the dual bracket, the
surfaces and the host oracles, with the names the reference exports
(options_model_tpu/pricers/__init__.py) that are ported. Each name is
imported from its module at first access, so importing the package
imports no pricer."""

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
}
__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
