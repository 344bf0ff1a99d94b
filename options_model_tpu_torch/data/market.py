"""Market data, as options_model_tpu/data/market.py: the yfinance adapters,
gated at import (yfinance is optional; without it every fetch raises
MarketDataError), and the offline reader of the recorded chain
(tests/data/chain_fixture.json).

- fetch_live_quote: spot and annualized historical vol from 1y log returns;
- fetch_live_iv: the IV at the nearest listed strike, NaN when missing or
  outside (0.01, 2.0);
- fetch_option_chain: the flattened (K, T, iv, S0) over up to 8 expiries
  with the liquidity filters; a failed expiry is skipped, a fully failed
  fetch raises MarketDataError;
- read_chain_fixture: the same parse of the recording, with numpy.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Tuple

import numpy as np

try:  # pragma: no cover - import gate
    import yfinance as yf
    _YF = True
except ImportError:  # pragma: no cover
    yf = None
    _YF = False

CHAIN_FIXTURE = Path(__file__).resolve().parents[2] / "tests" / "data" / "chain_fixture.json"


class MarketDataError(RuntimeError):
    pass


def yfinance_available() -> bool:
    return _YF


def _require_yf():
    if not _YF:
        raise MarketDataError(
            "yfinance is not installed; use the synthetic oracles in "
            "options_model_tpu_torch.data.synthetic for offline work")


def fetch_live_quote(ticker: str, vol_window: str = "1y") -> Tuple[float, float]:
    """(spot, annualized historical vol): sigma = std(log returns) sqrt(252)."""
    _require_yf()
    data = yf.Ticker(ticker)
    hist = data.history(period="1d")
    if hist.empty:
        raise MarketDataError(f"No data found for ticker {ticker}")
    S0 = float(hist["Close"].iloc[-1])
    closes = data.history(period=vol_window)["Close"].dropna()
    if len(closes) < 2:
        raise MarketDataError(f"Not enough history to estimate volatility for {ticker}")
    logrets = np.log(closes.values[1:] / closes.values[:-1])
    return S0, float(np.std(logrets, ddof=1) * np.sqrt(252.0))


def fetch_live_iv(ticker: str, expiry: str, strike: float, option_type: str = "call") -> float:
    """IV at the nearest listed strike for the given expiry; NaN when missing
    or outside the (0.01, 2.0) sanity range."""
    _require_yf()
    tk = yf.Ticker(ticker)
    try:
        if expiry not in tk.options:
            return float("nan")
        chain = tk.option_chain(expiry)
        df = chain.calls if option_type == "call" else chain.puts
        idx = int(np.abs(df["strike"].values - strike).argmin())
        iv = float(df.iloc[idx]["impliedVolatility"])
        if np.isnan(iv) or iv < 0.01 or iv > 2.0:
            return float("nan")
        return iv
    except Exception:  # the reference's degrade-to-NaN on any feed failure
        return float("nan")


def fetch_option_chain(ticker: str, max_expiries: int = 8, min_volume: float = 0.0
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Flattened (K, T, iv, S0) across up to ``max_expiries`` expiries,
    filtered to iv in (0.01, 2.0) and volume > min_volume; duplicates
    dropped, sorted by (T, K)."""
    _require_yf()
    import pandas as pd

    tk = yf.Ticker(ticker)
    hist = tk.history(period="1d")
    if hist.empty:
        raise MarketDataError(f"No price data found for {ticker}")
    S0 = float(hist["Close"].iloc[-1])
    expiries = tk.options
    if not expiries:
        raise MarketDataError(f"No option data found for {ticker}")

    rows: List[Tuple[float, float, float]] = []
    for exp_date in expiries[:max_expiries]:
        try:
            chain = tk.option_chain(exp_date)
            T = max((pd.to_datetime(exp_date) - pd.Timestamp.now()).days / 365.0, 1.0 / 365.0)
            for df in (chain.calls, chain.puts):
                if df.empty:
                    continue
                ok = ((df["impliedVolatility"] > 0.01) & (df["impliedVolatility"] < 2.0)
                      & (df["volume"] > min_volume))
                for _, row in df[ok].iterrows():
                    rows.append((float(row["strike"]), T, float(row["impliedVolatility"])))
        except Exception:  # degrade and continue per expiry, as the reference
            continue
    if not rows:
        raise MarketDataError(f"No valid option data found for {ticker}")
    arr = np.array(sorted(set(rows), key=lambda r: (r[1], r[0])), np.float64)
    return arr[:, 0], arr[:, 1], arr[:, 2], S0


def read_chain_fixture():
    """(K, T, iv, S0, meta) from the recorded option chain, parsed with numpy
    as fetch_option_chain parses the feed it records, at its defaults: the
    first 8 expiries, iv in (0.01, 2) and volume > 0 (NaN fails both),
    T = max(days / 365, 1 / 365), duplicates dropped, sorted by (T, K, iv);
    S0 the last close."""
    fx = json.loads(CHAIN_FIXTURE.read_text())
    rows = set()
    for days in sorted(fx["expiries"], key=int)[:8]:
        T = max(int(days) / 365.0, 1.0 / 365.0)
        for side in ("calls", "puts"):
            a = np.asarray(fx["expiries"][days][side], np.float64).reshape(-1, 3)
            ok = (a[:, 1] > 0.01) & (a[:, 1] < 2.0) & (a[:, 2] > 0.0)
            rows.update((float(k), T, float(v)) for k, v, _ in a[ok])
    arr = np.array(sorted(rows, key=lambda r: (r[1], r[0], r[2])), np.float64)
    return arr[:, 0], arr[:, 1], arr[:, 2], float(fx["closes"][-1]), fx["meta"]
