"""Black-Scholes closed form, as options_model_tpu/pricers/blackscholes.py
(``ndtr`` and ``bs_price``; the Greeks are not ported yet)."""

from __future__ import annotations

import torch


def _as_tensor(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def ndtr(x: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF as 0.5 * erfc(-x / sqrt(2)): the tail-stable form
    (0.5 * (1 + erf) cancels in the left tail and prices deep-OTM options
    negative)."""
    return 0.5 * torch.special.erfc(-x * 0.7071067811865476)


def bs_price(S, K, T, r, sigma, cp=1.0, q=0.0, dtype=torch.float32) -> torch.Tensor:
    """European Black-Scholes(-Merton) price; cp=+1 call, -1 put; ``q`` the
    continuous dividend yield. Broadcasts; a tensor argument sets the device
    and dtype, otherwise ``dtype`` on the CPU."""
    ref = next((a for a in (S, K, T, sigma) if isinstance(a, torch.Tensor)), None)
    ref = torch.empty((), dtype=dtype) if ref is None else ref
    S, K, T, sigma = (_as_tensor(a, ref) for a in (S, K, T, sigma))
    sqrt_T = torch.sqrt(T)
    d1 = (torch.log(S / K) + (r - q + 0.5 * sigma**2) * T) / (sigma * sqrt_T)
    d2 = d1 - sigma * sqrt_T
    # cp-symmetric form: call = S e^{-qT} N(d1) - K e^{-rT} N(d2)
    return cp * (S * torch.exp(-q * T) * ndtr(cp * d1)
                 - K * torch.exp(-r * T) * ndtr(cp * d2))
