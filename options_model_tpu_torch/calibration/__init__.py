"""Calibration, as options_model_tpu/calibration: the COS pricers
(charfn), the Heston / Bates / VG calibrator (calibrator) and the synthetic
oracle surfaces (synthetic). rBergomi calibration is not ported yet."""

from options_model_tpu_torch._unported import not_ported
from options_model_tpu_torch.calibration.charfn import (bates_cos_price, heston_charfn,
                                                        heston_cos_price, vg_cos_price)
from options_model_tpu_torch.calibration.calibrator import (HestonCalibrator, MarketSurface,
                                                            calibrate_bates_to_data,
                                                            calibrate_heston_to_data,
                                                            calibrate_heston_to_ticker,
                                                            calibrate_vg_to_data,
                                                            detect_regime)
from options_model_tpu_torch.calibration.synthetic import (create_synthetic_bates_surface,
                                                           create_synthetic_heston_surface,
                                                           create_synthetic_vg_surface)


def calibrate_rbergomi_to_data(*args, **kwargs):
    raise not_ported("calibrate_rbergomi_to_data (models/rbergomi.py)",
                     "calibration.rbergomi.calibrate_rbergomi_to_data")


def create_synthetic_rbergomi_surface(*args, **kwargs):
    raise not_ported("create_synthetic_rbergomi_surface (models/rbergomi.py)",
                     "calibration.rbergomi.create_synthetic_rbergomi_surface")


__all__ = [
    "bates_cos_price",
    "heston_charfn",
    "heston_cos_price",
    "HestonCalibrator",
    "MarketSurface",
    "calibrate_bates_to_data",
    "calibrate_heston_to_data",
    "calibrate_heston_to_ticker",
    "calibrate_rbergomi_to_data",
    "calibrate_vg_to_data",
    "create_synthetic_rbergomi_surface",
    "detect_regime",
    "create_synthetic_bates_surface",
    "create_synthetic_heston_surface",
    "create_synthetic_vg_surface",
    "vg_cos_price",
]
