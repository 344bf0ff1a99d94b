"""Path simulators: GBM, Heston (full-truncation Euler, QE-M), local vol,
Merton, Bates, Variance Gamma, SABR and rough Bergomi, with the names the reference
exports (options_model_tpu/models/__init__.py) that are ported. Each name
is imported from its module at first access, so importing the package
imports no simulator (the simulators and the kernel wrappers of ops/
import each other's modules)."""

import importlib

_EXPORTS = {
    "simulate_gbm": "gbm", "gbm_terminal_exact": "gbm",
    "simulate_heston": "heston",
    "simulate_merton": "merton", "merton_price": "merton",
    "simulate_vg": "vg", "vg_terminal_exact": "vg",
    "simulate_bates": "bates",
    "simulate_local_vol": "localvol",
    "simulate_sabr": "sabr", "sabr_european_mc": "sabr", "sabr_bs_price": "sabr",
    "hagan_lognormal_iv": "sabr", "calibrate_sabr": "sabr",
    "simulate_rbergomi": "rbergomi", "rbergomi_european_mc": "rbergomi",
    "rbergomi_exact_chol": "rbergomi",
    "num_blocks": "blocks", "paths_rounded": "blocks",
}
__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
