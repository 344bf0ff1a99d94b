"""Branch-free payoffs (cp +1 call / -1 put) and the barrier masks, as
options_model_tpu/core/payoff.py."""

from __future__ import annotations

import torch


def vanilla_payoff(S: torch.Tensor, K, cp) -> torch.Tensor:
    """max(cp * (S - K), 0)."""
    return torch.clamp_min(cp * (S - K), 0.0)


def barrier_knockout_mask(S_paths: torch.Tensor, barrier, is_up: bool) -> torch.Tensor:
    """1.0 for paths (columns of S_paths, (n_steps+1, n_paths)) that never
    touched the barrier, discretely monitored on the rows; 0.0 otherwise."""
    crossed = (S_paths >= barrier) if is_up else (S_paths <= barrier)
    return torch.where(crossed.any(dim=0), 0.0, 1.0).to(S_paths.dtype)


def barrier_knockin_mask(S_paths: torch.Tensor, barrier, is_up: bool) -> torch.Tensor:
    """1.0 for paths that did touch the barrier (the knock-in activates)."""
    return 1.0 - barrier_knockout_mask(S_paths, barrier, is_up)
