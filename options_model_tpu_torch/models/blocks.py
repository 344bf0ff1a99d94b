"""Path-block bookkeeping, as options_model_tpu/models/blocks.py."""

from __future__ import annotations

from options_model_tpu_torch.core.config import MCConfig


def paths_rounded(cfg: MCConfig) -> int:
    """n_paths rounded up to a whole number of path blocks."""
    b = cfg.path_block
    return ((cfg.n_paths + b - 1) // b) * b


def num_blocks(cfg: MCConfig) -> int:
    return paths_rounded(cfg) // cfg.path_block


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
