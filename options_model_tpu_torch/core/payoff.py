"""Branch-free payoffs (cp +1 call / -1 put), as options_model_tpu/core/payoff.py."""

from __future__ import annotations

import torch


def vanilla_payoff(S: torch.Tensor, K, cp) -> torch.Tensor:
    """max(cp * (S - K), 0)."""
    return torch.clamp_min(cp * (S - K), 0.0)
