"""Data: the synthetic IV oracles and the market adapters (yfinance gated at
import, the recorded chain read offline), as options_model_tpu/data."""

from options_model_tpu_torch.data.market import (
    MarketDataError,
    fetch_live_iv,
    fetch_live_quote,
    fetch_option_chain,
    read_chain_fixture,
    yfinance_available,
)
from options_model_tpu_torch.data.synthetic import synthetic_iv_smile, synthetic_smile_surface

__all__ = [
    "synthetic_iv_smile",
    "synthetic_smile_surface",
    "MarketDataError",
    "fetch_live_quote",
    "fetch_live_iv",
    "fetch_option_chain",
    "read_chain_fixture",
    "yfinance_available",
]
