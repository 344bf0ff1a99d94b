"""Calibration, as options_model_tpu/calibration: the COS pricers
(charfn), the Heston / Bates / VG calibrator (calibrator), the synthetic
oracle surfaces (synthetic) and the rough Bergomi calibrator on the
hybrid scheme's Monte Carlo (rbergomi)."""

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
from options_model_tpu_torch.calibration.rbergomi import (calibrate_rbergomi_to_data,
                                                          create_synthetic_rbergomi_surface)


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
