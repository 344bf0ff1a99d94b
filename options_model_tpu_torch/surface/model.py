"""The trained IV surface, as options_model_tpu/surface/model.py: fit,
predict, MC-dropout uncertainty, checkpoints, and the ``sigma_fn`` adapter
that the local-vol simulators take (the bare route of models/localvol.py,
or compiled into a Chebyshev table by surface/cheb.py for kernels 7 and 8).
The network lives on the device it was fitted or restored on (the card by
default).
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from options_model_tpu_torch.core.config import SurfaceTrainConfig
from options_model_tpu_torch.surface.train import (SurfaceTrainResult, network_from_result,
                                                   restore_checkpoint, save_checkpoint,
                                                   train_iv_surface)


class IVSurfaceModel:
    """Trained IV surface with prediction, uncertainty and simulator adapters."""

    def __init__(self, result: SurfaceTrainResult, device=None):
        self._result = result
        self._net = network_from_result(result, device)

    # -- constructors ---------------------------------------------------------

    @classmethod
    def fit(cls, K, T, sigma_iv, S0: float, cfg: Optional[SurfaceTrainConfig] = None,
            rate: float = 0.05, diagnostics_dir: Optional[str] = None,
            device=None) -> "IVSurfaceModel":
        return cls(train_iv_surface(K, T, sigma_iv, S0, cfg, rate,
                                    diagnostics_dir=diagnostics_dir, device=device))

    @classmethod
    def fit_ticker(cls, ticker: str, cfg: Optional[SurfaceTrainConfig] = None,
                   rate: float = 0.05, device=None) -> "IVSurfaceModel":
        """Fetch the live option chain (data/market.py, gated on yfinance) and fit."""
        from options_model_tpu_torch.data.market import fetch_option_chain

        K, T, iv, S0 = fetch_option_chain(ticker)
        return cls.fit(K, T, iv, S0, cfg, rate, device=device)

    @classmethod
    def restore(cls, path: str, device=None) -> "IVSurfaceModel":
        return cls(restore_checkpoint(path, device))

    def save(self, path: str) -> None:
        save_checkpoint(path, self._result)

    # -- properties -----------------------------------------------------------

    @property
    def S0(self) -> float:
        return self._result.scaler.S0

    @property
    def scaler(self):
        return self._result.scaler

    @property
    def best_val_loss(self) -> float:
        return self._result.best_val_loss

    @property
    def device(self) -> torch.device:
        return self._net.head.weight.device

    # -- prediction -----------------------------------------------------------

    def _features(self, K, tau, S) -> Tuple[torch.Tensor, tuple]:
        K = torch.as_tensor(np.asarray(K, np.float32), device=self.device)
        tau = torch.as_tensor(np.asarray(tau, np.float32), device=self.device)
        X = self.scaler.features(K, S, tau)
        return X.reshape(-1, 2), X.shape[:-1]

    def predict(self, K, tau, S: Optional[float] = None) -> np.ndarray:
        """IV at strike(s) K and expiry tau (years), spot defaulting to the
        fitted S0; broadcasts elementwise."""
        X, shape = self._features(K, tau, self.S0 if S is None else S)
        with torch.no_grad():
            out = self._net(X)[:, 0]
        return out.cpu().numpy().reshape(shape)

    def predict_surface(self, K_grid, tau_grid) -> np.ndarray:
        """IV over a meshgrid of strikes x expiries."""
        Km, Tm = np.meshgrid(np.asarray(K_grid), np.asarray(tau_grid))
        return self.predict(Km, Tm)

    def predict_with_uncertainty(self, K, tau, n_samples: Optional[int] = None,
                                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """MC-dropout mean and std over ``n_samples`` passes with dropout
        live (batched: every pass's masks from one generator on the model's
        device seeded with ``seed``). With ``mc_dropout`` off in the config: the deterministic
        prediction and zero spread."""
        cfg = self._result.config
        if not cfg.mc_dropout:
            mean = self.predict(K, tau)
            return mean, np.zeros_like(mean)
        n = n_samples or cfg.mc_samples
        X, shape = self._features(K, tau, self.S0)
        net = self._net
        net.train()
        net.set_dropout_generator(torch.Generator(device=self.device).manual_seed(seed))
        try:
            with torch.no_grad():
                samples = net(X.repeat(n, 1))[:, 0].reshape(n, -1)
        finally:
            net.set_dropout_generator(None)
            net.eval()
        mean = samples.mean(0).cpu().numpy().reshape(shape)
        std = samples.std(0, unbiased=False).cpu().numpy().reshape(shape)
        return mean, std

    # -- simulator adapters ---------------------------------------------------

    def sigma_fn(self, K: float, compute_dtype: Optional[torch.dtype] = None) -> Callable:
        """sigma(S, tau) over a fixed strike for the local-vol simulators:
        the network at m = log(K / S), floored at 1e-6, evaluated on the
        model's device and returned float32 on the device of S.
        ``compute_dtype=torch.bfloat16`` runs the network in bf16."""
        net = self._net if compute_dtype is None else copy.deepcopy(self._net).to(compute_dtype)
        scaler, device = self.scaler, self.device

        def fn(S, tau):
            S = torch.as_tensor(S)
            X = scaler.features(K, S.to(device), torch.as_tensor(tau).to(device))
            if compute_dtype is not None:
                X = X.to(compute_dtype)
            with torch.no_grad():
                out = net(X.reshape(-1, 2))[:, 0].float()
            return torch.clamp_min(out, 1e-6).reshape(S.shape).to(S.device)

        return fn

    def get_sigma_iv(self, K: float, S0: float, tau: float) -> float:
        """Scalar IV lookup."""
        if K <= 0 or S0 <= 0 or tau <= 0:
            raise ValueError("K, S0, and tau must be positive")
        return float(self.predict(np.float32(K), np.float32(tau), S=S0))
