"""Frozen-dataclass configs with the field names and defaults of
options_model_tpu/core/config.py (OptionSpec, HestonParams, MCConfig,
LSMConfig). ``dataclasses.replace`` takes the place of the flax ``.replace``.

``from_reference(fields)`` builds a port config from the reference object's
fields (``dataclasses.asdict`` or ``vars`` of it), given as plain Python or
numpy values, so configs cross between the packages without this package
importing JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

CALL: float = 1.0
PUT: float = -1.0


def _plain(name: str, value):
    """A reference field value as the port stores it: numpy scalars become
    Python numbers, a dtype becomes the torch dtype of the same name."""
    if name == "dtype":
        return getattr(torch, np.dtype(value).name)
    if isinstance(value, np.generic):
        return value.item()
    return value


class _FromReference:
    @classmethod
    def from_reference(cls, fields: dict):
        return cls(**{k: _plain(k, v) for k, v in fields.items()})


@dataclasses.dataclass(frozen=True)
class OptionSpec(_FromReference):
    """A vanilla option contract + market environment (cp +1 call, -1 put)."""

    strike: float
    rate: float
    cp: float = CALL
    sigma: Optional[float] = None  # constant (BS) vol; None when Heston drives
    div_yield: float = 0.0          # continuous dividend yield q


@dataclasses.dataclass(frozen=True)
class HestonParams(_FromReference):
    """dv = kappa (theta - v) dt + xi sqrt(v) dW2,  corr(dW1, dW2) = rho."""

    kappa: float  # mean-reversion speed
    theta: float  # long-run variance
    xi: float     # vol of vol
    rho: float    # spot/vol correlation
    v0: float     # initial variance


@dataclasses.dataclass(frozen=True)
class MCConfig(_FromReference):
    """Monte-Carlo workload shape; n_paths rounds up to whole path blocks."""

    n_paths: int = 100_000
    n_steps: int = 50
    antithetic: bool = True
    path_block: int = 4096
    dtype: torch.dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class LSMConfig(_FromReference):
    """Longstaff-Schwartz configuration; field meanings as in the reference
    (options_model_tpu/core/config.py LSMConfig). Both regressors are
    ported: 'poly' (masked WLS per date) and 'nn' (the shared continuation
    MLP, pricers/regressors.py)."""

    regressor: str = "poly"
    poly_degree: int = 3
    nn_hidden: int = 128
    nn_layers: int = 3
    nn_epochs: int = 25
    nn_lr: float = 1e-3
    nn_batch: int = 4096
    nn_dropout: float = 0.1
    nn_policy_iters: int = 3
    use_control_variate: bool = True
    cv_beta: str = "opt"
    european_approximation: bool = False
    variance_basis: bool = True
    variance_basis_degree: int = 2
    out_of_sample: bool = False
    richardson: bool = False
