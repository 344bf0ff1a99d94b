"""Frozen-dataclass configs with the field names and defaults of
options_model_tpu/core/config.py (OptionSpec, HestonParams, MCConfig,
LSMConfig), their eager ``validate()`` checks (the same conditions, exception
types and messages), and ``cp_from_str`` / ``cp_to_str``.
``dataclasses.replace`` takes the place of the flax ``.replace``.

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


def cp_from_str(option_type: str) -> float:
    ot = option_type.strip().lower()
    if ot in ("call", "c"):
        return CALL
    if ot in ("put", "p"):
        return PUT
    raise ValueError(f"option_type must be 'call' or 'put', got {option_type!r}")


def cp_to_str(cp: float) -> str:
    return "call" if cp > 0 else "put"


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

    def validate(self) -> "OptionSpec":
        if self.strike <= 0:
            raise ValueError(f"strike must be positive, got {self.strike}")
        if self.rate < 0:
            raise ValueError(f"rate must be non-negative, got {self.rate}")
        if self.cp not in (CALL, PUT):
            raise ValueError(f"cp must be +1 (call) or -1 (put), got {self.cp}")
        if self.sigma is not None and self.sigma <= 0:
            raise ValueError(f"sigma must be positive, got {self.sigma}")
        if self.div_yield < 0:
            raise ValueError(f"div_yield must be non-negative, "
                             f"got {self.div_yield}")
        return self


@dataclasses.dataclass(frozen=True)
class HestonParams(_FromReference):
    """dv = kappa (theta - v) dt + xi sqrt(v) dW2,  corr(dW1, dW2) = rho."""

    kappa: float  # mean-reversion speed
    theta: float  # long-run variance
    xi: float     # vol of vol
    rho: float    # spot/vol correlation
    v0: float     # initial variance

    def validate(self) -> "HestonParams":
        if not (0 < self.kappa < 20):
            raise ValueError(f"kappa={self.kappa} must be in (0, 20)")
        if not (0 < self.theta < 2):
            raise ValueError(f"theta={self.theta} must be in (0, 2)")
        if not (0 < self.xi < 3):
            raise ValueError(f"xi={self.xi} must be in (0, 3)")
        if not (-1 < self.rho < 1):
            raise ValueError(f"rho={self.rho} must be in (-1, 1)")
        if not (0 < self.v0 < 2):
            raise ValueError(f"v0={self.v0} must be in (0, 2)")
        return self


@dataclasses.dataclass(frozen=True)
class MCConfig(_FromReference):
    """Monte-Carlo workload shape; n_paths rounds up to whole path blocks."""

    n_paths: int = 100_000
    n_steps: int = 50
    antithetic: bool = True
    path_block: int = 4096
    dtype: torch.dtype = torch.float32

    def validate(self) -> "MCConfig":
        if self.n_paths <= 0 or self.n_steps <= 0:
            raise ValueError("n_paths and n_steps must be positive")
        if self.path_block % 256 != 0:
            raise ValueError("path_block must be a multiple of 256 (TPU lane tiling)")
        return self


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

    def validate(self) -> "LSMConfig":
        if self.regressor not in ("poly", "nn"):
            raise ValueError(f"regressor must be 'poly' or 'nn', got {self.regressor}")
        if not (1 <= self.poly_degree <= 8):
            raise ValueError(f"poly_degree must be in [1, 8], got {self.poly_degree}")
        if self.nn_policy_iters < 1:
            raise ValueError(
                f"nn_policy_iters must be >= 1, got {self.nn_policy_iters}")
        if self.cv_beta not in ("one", "opt"):
            raise ValueError(
                f"cv_beta must be 'one' or 'opt', got {self.cv_beta!r}")
        if self.variance_basis_degree not in (2, 3):
            raise ValueError(f"variance_basis_degree must be 2 or 3, got "
                             f"{self.variance_basis_degree}")
        return self
