"""Frozen-dataclass configs with the field names and defaults of
options_model_tpu/core/config.py (OptionSpec, HestonParams, MertonParams,
BatesParams, VGParams, SABRParams, MCConfig, LSMConfig, CalibrationConfig,
SurfaceTrainConfig), their eager ``validate()`` checks (the same
conditions, exception types and messages), the parameter vectors of the
calibrator (``to_array`` / ``from_array``, as float64 numpy), and
``cp_from_str`` / ``cp_to_str``.
``dataclasses.replace`` takes the place of the flax ``.replace``.

``from_reference(fields)`` builds a port config from the reference object's
fields (``dataclasses.asdict`` or ``vars`` of it), given as plain Python or
numpy values, so configs cross between the packages without this package
importing JAX. BatesParams takes its nested ``heston`` as a dict or as the
reference's object.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

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

    def feller_condition(self) -> bool:
        """2*kappa*theta >= xi^2 keeps the variance process strictly positive."""
        return bool(2.0 * self.kappa * self.theta >= self.xi**2)

    def to_array(self) -> np.ndarray:
        return np.array([self.kappa, self.theta, self.xi, self.rho, self.v0], np.float64)

    @classmethod
    def from_array(cls, x) -> "HestonParams":
        return cls(kappa=float(x[0]), theta=float(x[1]), xi=float(x[2]),
                   rho=float(x[3]), v0=float(x[4]))

    def __str__(self) -> str:
        feller = "ok" if self.feller_condition() else "VIOLATED"
        return (f"HestonParams(kappa={self.kappa:.4f}, theta={self.theta:.4f}, "
                f"xi={self.xi:.4f}, rho={self.rho:.4f}, v0={self.v0:.4f}) "
                f"Feller: {feller}")


@dataclasses.dataclass(frozen=True)
class MertonParams(_FromReference):
    """Merton (1976) jump diffusion:

        dS/S = (r - q - lam kbar) dt + sigma dW + (J - 1) dN,
        N ~ Poisson(lam), log J ~ N(mu_j, sigma_j^2),

    kbar = E[J - 1] = exp(mu_j + sigma_j^2/2) - 1, the drift compensator."""

    sigma: float    # diffusive volatility
    lam: float      # jump intensity (expected jumps / year)
    mu_j: float     # mean log-jump size
    sigma_j: float  # log-jump-size volatility

    def validate(self) -> "MertonParams":
        if self.sigma <= 0:
            raise ValueError(f"sigma={self.sigma} must be positive")
        if self.lam < 0:
            raise ValueError(f"lam={self.lam} must be non-negative")
        if self.sigma_j < 0:
            raise ValueError(f"sigma_j={self.sigma_j} must be non-negative")
        return self

    def kbar(self) -> float:
        return math.exp(self.mu_j + 0.5 * self.sigma_j**2) - 1.0


@dataclasses.dataclass(frozen=True)
class BatesParams:
    """Bates (1996): Heston variance dynamics plus a compound-Poisson
    lognormal jump in the spot, independent of both Brownian drivers."""

    heston: HestonParams
    lam: float      # jump intensity (expected jumps / year)
    mu_j: float     # mean log-jump size
    sigma_j: float  # log-jump-size volatility

    @classmethod
    def from_reference(cls, fields: dict) -> "BatesParams":
        fields = dict(fields)
        hp = fields.pop("heston")
        hp = HestonParams.from_reference(hp if isinstance(hp, dict) else vars(hp))
        return cls(heston=hp, **{k: _plain(k, v) for k, v in fields.items()})

    def validate(self) -> "BatesParams":
        self.heston.validate()
        if self.lam < 0:
            raise ValueError(f"lam={self.lam} must be non-negative")
        if self.sigma_j < 0:
            raise ValueError(f"sigma_j={self.sigma_j} must be non-negative")
        return self

    def kbar(self) -> float:
        return math.exp(self.mu_j + 0.5 * self.sigma_j**2) - 1.0

    def feller_condition(self) -> bool:
        return self.heston.feller_condition()

    def to_array(self) -> np.ndarray:
        """(kappa, theta, xi, rho, v0, lam, mu_j, sigma_j): the calibrator's x."""
        return np.concatenate([self.heston.to_array(),
                               np.array([self.lam, self.mu_j, self.sigma_j], np.float64)])

    @classmethod
    def from_array(cls, x) -> "BatesParams":
        return cls(heston=HestonParams.from_array(x[:5]), lam=float(x[5]),
                   mu_j=float(x[6]), sigma_j=float(x[7]))

    def __str__(self) -> str:
        return (f"BatesParams({self.heston}, lam={self.lam:.4f}, "
                f"mu_j={self.mu_j:.4f}, sigma_j={self.sigma_j:.4f})")


@dataclasses.dataclass(frozen=True)
class VGParams(_FromReference):
    """Variance Gamma (Madan-Carr-Chang 1998): X_t = theta G_t + sigma W_{G_t},
    G a gamma clock of unit mean rate and variance rate nu."""

    sigma: float  # volatility of the subordinated Brownian motion
    theta: float  # its drift (skew)
    nu: float     # variance rate of the gamma clock (kurtosis)

    def validate(self) -> "VGParams":
        if self.sigma <= 0:
            raise ValueError(f"sigma={self.sigma} must be positive")
        if self.nu <= 0:
            raise ValueError(f"nu={self.nu} must be positive")
        if 1.0 - self.theta * self.nu - 0.5 * self.sigma**2 * self.nu <= 0:
            raise ValueError(
                "martingale compensator undefined: need "
                f"theta*nu + sigma^2*nu/2 < 1, got theta={self.theta}, "
                f"sigma={self.sigma}, nu={self.nu}")
        return self

    def omega(self) -> float:
        """Martingale drift correction ln(1 - theta nu - sigma^2 nu/2)/nu."""
        return math.log(1.0 - self.theta * self.nu
                        - 0.5 * self.sigma**2 * self.nu) / self.nu

    def to_array(self) -> np.ndarray:
        return np.array([self.sigma, self.theta, self.nu], np.float64)

    @classmethod
    def from_array(cls, x) -> "VGParams":
        return cls(sigma=float(x[0]), theta=float(x[1]), nu=float(x[2]))

    def __str__(self) -> str:
        return (f"VGParams(sigma={self.sigma:.4f}, theta={self.theta:.4f}, "
                f"nu={self.nu:.4f})")


@dataclasses.dataclass(frozen=True)
class SABRParams(_FromReference):
    """SABR stochastic volatility (Hagan et al. 2002, "Managing Smile Risk"):

        dF = alpha_t F^beta dW1,   d alpha = nu alpha dW2,
        corr(dW1, dW2) = rho,  alpha_0 = alpha.

    ``models/sabr.py`` carries the closed-form lognormal implied vol, the
    exact-lognormal-alpha simulator and the smile calibrator."""

    alpha: float  # initial instantaneous vol level
    beta: float   # CEV backbone exponent in [0, 1]
    rho: float    # forward/vol correlation
    nu: float     # vol of vol

    def validate(self) -> "SABRParams":
        if self.alpha <= 0:
            raise ValueError(f"alpha={self.alpha} must be positive")
        if not 0.0 <= self.beta <= 1.0:
            raise ValueError(f"beta={self.beta} must be in [0, 1]")
        if not -1.0 < self.rho < 1.0:
            raise ValueError(f"rho={self.rho} must be in (-1, 1)")
        if self.nu < 0:
            raise ValueError(f"nu={self.nu} must be non-negative")
        return self

    def to_array(self) -> np.ndarray:
        return np.array([self.alpha, self.beta, self.rho, self.nu], np.float64)

    @classmethod
    def from_array(cls, x) -> "SABRParams":
        return cls(alpha=float(x[0]), beta=float(x[1]), rho=float(x[2]), nu=float(x[3]))

    def __str__(self) -> str:
        return (f"SABRParams(alpha={self.alpha:.4f}, beta={self.beta:.2f}, "
                f"rho={self.rho:.4f}, nu={self.nu:.4f})")


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


@dataclasses.dataclass(frozen=True)
class CalibrationConfig(_FromReference):
    """Calibration knobs, as the reference's CalibrationConfig: the objective
    prices by COS, so ``max_iterations`` of a few hundred is cheap."""

    use_vega_weighting: bool = True
    min_vega_weight: float = 0.01
    max_iterations: int = 2000
    tolerance: float = 1e-8
    cos_n: int = 256           # COS series terms
    cos_L: float = 12.0        # truncation width in std devs
    seed: int = 42
    verbose: bool = False
    regime_detection: bool = True
    optimization_methods: Tuple[str, ...] = (
        "L-BFGS-B", "differential_evolution", "dual_annealing")

    def validate(self) -> "CalibrationConfig":
        if self.cos_n < 16:
            raise ValueError("cos_n must be >= 16")
        return self


@dataclasses.dataclass(frozen=True)
class SurfaceTrainConfig(_FromReference):
    """IV-surface network training knobs, as the reference's
    SurfaceTrainConfig (options_model_tpu/core/config.py:465-493)."""

    epochs: int = 50
    batch_size: int = 128
    lr: float = 1e-3
    weight_decay: float = 1e-4
    lambda_butterfly: float = 1e-3
    lambda_calendar: float = 1e-4
    hidden_dim: int = 64
    num_hidden_layers: int = 4
    dropout: float = 0.1
    epsilon: float = 1e-4       # IV floor applied at the network output
    val_split: float = 0.15
    patience: int = 8
    use_cosine_schedule: bool = True
    use_augmentation: bool = True
    seed: int = 42
    mc_dropout: bool = True
    mc_samples: int = 20
    use_vega_weighting: bool = True
    grad_clip: float = 1.0

    def validate(self) -> "SurfaceTrainConfig":
        if not (0 < self.val_split < 1):
            raise ValueError("val_split must be in (0, 1)")
        if self.epochs <= 0 or self.batch_size <= 0:
            raise ValueError("epochs and batch_size must be positive")
        return self
