"""Volatility surfaces, as options_model_tpu/surface: the IV-surface network
(scaler, network, loss, trainer with checkpoints, IVSurfaceModel and its
``sigma_fn`` adapter), the SVI surface with its Dupire local vol, and the
Chebyshev local-vol table that kernels 7 and 8 read (cheb.py)."""

from options_model_tpu_torch.surface.loss import arbitrage_penalty_fd, vega_weights
from options_model_tpu_torch.surface.model import IVSurfaceModel
from options_model_tpu_torch.surface.network import IVNetwork
from options_model_tpu_torch.surface.scaler import SurfaceScaler
from options_model_tpu_torch.surface.svi import (
    SVILocalVolEngine,
    SVISlice,
    SVISurface,
    fit_svi_from_chain,
    fit_svi_slice,
    fit_svi_surface,
    svi_butterfly_g,
    svi_total_variance,
)
from options_model_tpu_torch.surface.train import SurfaceTrainResult, train_iv_surface

__all__ = [
    "SVILocalVolEngine",
    "SVISlice",
    "SVISurface",
    "fit_svi_from_chain",
    "fit_svi_slice",
    "fit_svi_surface",
    "svi_butterfly_g",
    "svi_total_variance",
    "SurfaceScaler",
    "IVNetwork",
    "arbitrage_penalty_fd",
    "vega_weights",
    "SurfaceTrainResult",
    "train_iv_surface",
    "IVSurfaceModel",
]
