"""Monte-Carlo statistics, as options_model_tpu/core/stats.py: the Welford/Chan
merge that streams European chunks, antithetic pair means, masked
mean/stderr, the variance-minimizing control-variate coefficient and the
cashflow report.

Every function returns tensors and never reads a value back to the host, so
a caller on the card does not wait for it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class WelfordState:
    count: torch.Tensor  # float, so merges stay exact in the same dtype
    mean: torch.Tensor
    m2: torch.Tensor

    @property
    def variance(self) -> torch.Tensor:
        return torch.where(self.count > 1,
                           self.m2 / torch.clamp_min(self.count - 1, 1.0),
                           torch.zeros_like(self.m2))

    @property
    def stderr(self) -> torch.Tensor:
        return torch.sqrt(self.variance / torch.clamp_min(self.count, 1.0))


def welford_empty(dtype=torch.float32, device=None) -> WelfordState:
    z = torch.zeros((), dtype=dtype, device=device)
    return WelfordState(count=z, mean=z, m2=z)


def welford_from_batch(x: torch.Tensor) -> WelfordState:
    """State summarizing one batch."""
    x = x.reshape(-1)
    mean = x.mean()
    return WelfordState(count=torch.tensor(float(x.numel()), dtype=x.dtype,
                                           device=x.device),
                        mean=mean, m2=((x - mean) ** 2).sum())


def welford_merge(a: WelfordState, b: WelfordState) -> WelfordState:
    """Chan's parallel combine; exact and associative."""
    n = a.count + b.count
    safe_n = torch.clamp_min(n, 1.0)
    delta = b.mean - a.mean
    mean = a.mean + delta * (b.count / safe_n)
    m2 = a.m2 + b.m2 + delta**2 * (a.count * b.count / safe_n)
    return WelfordState(count=n, mean=mean, m2=m2)


def pair_mean_reduce(x: torch.Tensor, pair_block: int) -> torch.Tensor:
    """Average antithetic mirror pairs.

    x: (n,) in consecutive chunks of ``pair_block`` whose second half mirrors
    the first (the kernels' tile layout). Returns the (n/2,) pair means, which
    are i.i.d. where the n correlated samples are not."""
    n = x.shape[0]
    return x.reshape(n // pair_block, 2, pair_block // 2).mean(dim=1).reshape(-1)


def masked_mean_stderr(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                       pair_block: Optional[int] = None):
    """(mean, stderr, n_effective) of masked samples, pair-reduced when
    ``pair_block`` is given (masks must be constant across each pair)."""
    if mask is None:
        mask = torch.ones_like(x)
    if pair_block is not None:
        x = pair_mean_reduce(x, pair_block)
        mask = pair_mean_reduce(mask, pair_block)
    n = torch.clamp_min(mask.sum(), 1.0)
    mean = (x * mask).sum() / n
    var = ((x - mean) ** 2 * mask).sum() / n
    return mean, torch.sqrt(var / n), n


def optimal_cv_beta(cash: torch.Tensor, adj: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    pair_block: Optional[int] = None) -> torch.Tensor:
    """beta* = -Cov(cash, adj) / Var(adj) over antithetic pair means — the
    granularity the reported stderr uses (reference docstring)."""
    if mask is None:
        mask = torch.ones_like(cash)
    if pair_block is not None:
        cash = pair_mean_reduce(cash, pair_block)
        adj = pair_mean_reduce(adj, pair_block)
        mask = pair_mean_reduce(mask, pair_block)
    n = torch.clamp_min(mask.sum(), 1.0)
    mc = (cash * mask).sum() / n
    ma = (adj * mask).sum() / n
    cov = ((cash - mc) * (adj - ma) * mask).sum() / n
    var = ((adj - ma) ** 2 * mask).sum() / n
    return -cov / torch.clamp_min(var, 1e-12)


def cashflow_statistics(cash: torch.Tensor, mask: Optional[torch.Tensor] = None) -> dict:
    """Distribution of the per-path discounted cashflows, the reference's
    verbose pricing report: mean, std (n - 1 denominator), min, max,
    P(worthless) and n over the masked paths (``mask`` 0/1, e.g. the
    out-of-sample evaluation mask). 0-dim tensors."""
    if mask is None:
        mask = torch.ones_like(cash)
    n = torch.clamp_min(mask.sum(), 1.0)
    mean = (cash * mask).sum() / n
    var = ((cash - mean) ** 2 * mask).sum() / torch.clamp_min(n - 1.0, 1.0)
    big = torch.finfo(cash.dtype).max
    return {"mean": mean, "std": torch.sqrt(var),
            "min": torch.where(mask > 0, cash, big).min(),
            "max": torch.where(mask > 0, cash, -big).max(),
            "p_worthless": ((cash == 0.0) * mask).sum() / n, "n": n}
