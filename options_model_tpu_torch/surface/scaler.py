"""Feature scaling of the IV surface, as options_model_tpu/surface/scaler.py:
(log-moneyness, tau) centered and scaled, with the reference's minimum
scales (1e-3 for m, 1e-4 for tau). The statistics are float64 numpy; the
features are tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SurfaceScaler:
    m_mean: float = 0.0
    m_scale: float = 1.0
    tau_mean: float = 0.0
    tau_scale: float = 1.0
    S0: float = 0.0

    @classmethod
    def fit(cls, m, tau, S0: float) -> "SurfaceScaler":
        """Center and scale log-moneyness and time to expiry (float64)."""
        m = np.asarray(m, np.float64)
        tau = np.asarray(tau, np.float64)
        return cls(m_mean=float(m.mean()), m_scale=float(max(m.std(), 1e-3)),
                   tau_mean=float(tau.mean()), tau_scale=float(max(tau.std(), 1e-4)),
                   S0=float(S0))

    def transform(self, m, tau):
        return (m - self.m_mean) / self.m_scale, (tau - self.tau_mean) / self.tau_scale

    def features(self, K, S, tau) -> torch.Tensor:
        """(..., 2) float32 network input from strike, spot and expiry, on
        the device of the tensor among them (the CPU if none is one):
        m = log(max(K, 1e-8) / max(S, 1e-8)), then ``transform``."""
        ref = next((a for a in (S, K, tau) if isinstance(a, torch.Tensor)), None)
        dev = ref.device if ref is not None else None
        K, S, tau = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (K, S, tau))
        m = torch.log(torch.clamp_min(K, 1e-8) / torch.clamp_min(S, 1e-8))
        m_norm, tau_norm = torch.broadcast_tensors(*self.transform(m, tau))
        return torch.stack([m_norm, tau_norm], dim=-1)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SurfaceScaler":
        return cls(**{k: float(v) for k, v in d.items()})
