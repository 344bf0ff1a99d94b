"""Heston / Bates / VG / rough Bergomi calibration CLI, as
options_model_tpu/apps/calibrate.py.

    python -m options_model_tpu_torch.apps.calibrate --test
    python -m options_model_tpu_torch.apps.calibrate --test --price-surface surface.csv

    python -m options_model_tpu_torch.apps.calibrate --model bates --test --price-surface b.csv
    python -m options_model_tpu_torch.apps.calibrate --model rbergomi --test

``--test`` calibrates against the synthetic oracle surface with known true
parameters and reports the recovery error; ``--price-surface`` then prices
the ``--surface-size`` American put surface under the fitted Heston or Bates
parameters (one batched Heston paths launch; Bates adds one jump-overlay
launch over it; then the LSM backwards) and writes it as CSV
(``K,T,price``). ``--model rbergomi`` fits (H, eta, xi0) at a fixed
``--rho`` on the hybrid scheme's Monte Carlo (calibration/rbergomi.py).
Everything runs on the card; ``run(args, device="cpu")`` runs on the CPU.
Not ported yet: a live ``--ticker`` chain and ``--diagnostics-dir``.
"""

from __future__ import annotations

import argparse
import csv
import logging
import sys

import numpy as np
import torch

from options_model_tpu_torch._unported import not_ported
from options_model_tpu_torch.core.config import (BatesParams, CalibrationConfig, HestonParams,
                                                 MCConfig, RBergomiParams, VGParams)
from options_model_tpu_torch.ops.engine import checked_device

log = logging.getLogger(__name__)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Heston model calibration (COS + "
                                            "gradient cascade)")
    p.add_argument("--ticker", type=str, default="AAPL",
                   help="Stock ticker to fetch the option chain for (not ported)")
    p.add_argument("--model", type=str, default="heston",
                   choices=["heston", "bates", "vg", "rbergomi"],
                   help="bates adds the lognormal jump triple (lam, mu_j, sigma_j); "
                        "vg fits the Variance Gamma (sigma, theta, nu); rbergomi fits "
                        "(H, eta, xi0) at a fixed --rho by the hybrid scheme's MC")
    p.add_argument("--rho", type=float, default=-0.7,
                   help="rbergomi only: spot-vol correlation, held fixed")
    p.add_argument("--polish-evals", type=int, default=160,
                   help="rbergomi only: Nelder-Mead evaluation budget")
    p.add_argument("--test", action="store_true",
                   help="Calibrate against the synthetic oracle (no network)")
    p.add_argument("--rate", type=float, default=0.05)
    p.add_argument("--div-yield", type=float, default=0.0,
                   help="Continuous dividend yield q of the underlying")
    p.add_argument("--noise", type=float, default=0.0,
                   help="IV noise stddev added to the synthetic surface")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--max-iterations", type=int, default=2000)
    p.add_argument("--methods", type=str, nargs="+",
                   default=["L-BFGS-B", "differential_evolution", "dual_annealing"])
    p.add_argument("--no-vega-weighting", action="store_true")
    p.add_argument("--diagnostics-dir", type=str, default=None,
                   help="Write the 2x2 calibration diagnostics PNG here (not ported)")
    p.add_argument("--price-surface", type=str, default=None, metavar="CSV",
                   help="After calibrating, price the American surface under the "
                        "fitted parameters and write it here")
    p.add_argument("--surface-size", type=int, nargs=2, default=(64, 64),
                   metavar=("NT", "NK"))
    p.add_argument("--verbose", action="store_true")
    return p.parse_args(argv)


def _check_ported(args) -> None:
    """Raise for what the app does not carry yet (a live chain, diagnostics
    plots), and exit as the reference does for a VG or rBergomi surface."""
    if not args.test:
        raise not_ported("a live --ticker chain (data/market.py)",
                         "data.market.fetch_option_chain")
    if args.diagnostics_dir is not None:
        raise not_ported("--diagnostics-dir (utils/plotting.py)",
                         "utils.plotting.plot_calibration_results")
    if args.price_surface and args.model in ("vg", "rbergomi"):
        raise SystemExit("--price-surface supports heston/bates (the shared-path surface "
                         "backward rides the (S, v) variance state)")


def _price_surface(args, params, S0: float, device) -> None:
    """The calibrated American put surface under HestonParams or BatesParams
    ``params``, K in [0.7, 1.3] S0 by T in [0.1, 1], 16384 x 50 paths per
    maturity, written as K,T,price."""
    from options_model_tpu_torch.pricers.surface_american import price_american_surface

    nt, nk = args.surface_size
    Ks = np.linspace(0.7 * S0, 1.3 * S0, nk).astype(np.float32)
    Ts = np.linspace(0.1, 1.0, nt).astype(np.float32)
    model_kw = (dict(model="bates", bates=params) if args.model == "bates"
                else dict(model="heston", heston=params))
    P = price_american_surface(torch.Generator().manual_seed(args.seed), S0, Ks, Ts,
                               args.rate, MCConfig(n_paths=16384, n_steps=50), cp=-1.0,
                               div_yield=args.div_yield, device=device, **model_kw)
    Km, Tm = np.meshgrid(Ks, Ts)
    with open(args.price_surface, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["K", "T", "price"])
        w.writerows(zip(Km.ravel(), Tm.ravel(), P.cpu().numpy().ravel()))
    log.info(f"Calibrated American {nt}x{nk} surface written to {args.price_surface}")


def _run_rbergomi(args, device) -> dict:
    """The rBergomi branch (the reference's _run_rbergomi): the synthetic
    surface at truth (0.1, 1.5, --rho, 0.04), then
    calibrate_rbergomi_to_data at --seed and --polish-evals, with the
    recovery errors."""
    from options_model_tpu_torch.calibration.rbergomi import (calibrate_rbergomi_to_data,
                                                              create_synthetic_rbergomi_surface)

    true = RBergomiParams(H=0.1, eta=1.5, rho=args.rho, xi0=0.04)
    K, T, iv = create_synthetic_rbergomi_surface(true, S0=100.0, rate=args.rate,
                                                 noise_std=args.noise, seed=args.seed,
                                                 device=device)
    log.info(f"Synthetic rBergomi calibration test: true {true}")
    params, summary = calibrate_rbergomi_to_data(K, T, iv, 100.0, args.rate, rho=args.rho,
                                                 seed=args.seed,
                                                 max_polish_evals=args.polish_evals,
                                                 device=device)
    summary["params"] = params
    summary["true_params"] = true
    summary["param_errors"] = {"H": abs(params.H - true.H), "eta": abs(params.eta - true.eta),
                               "xi0": abs(params.xi0 - true.xi0)}
    return summary


def run(args, device=None) -> dict:
    """Calibrate as ``args`` asks, on ``device`` (the card by default):
    the summary dict, with the params, the truth and the recovery errors."""
    from options_model_tpu_torch.calibration.calibrator import (calibrate_bates_to_data,
                                                                calibrate_heston_to_data,
                                                                calibrate_vg_to_data)
    from options_model_tpu_torch.calibration.synthetic import (create_synthetic_bates_surface,
                                                               create_synthetic_heston_surface,
                                                               create_synthetic_vg_surface)

    _check_ported(args)
    device = checked_device(device)
    if args.model == "rbergomi":
        return _run_rbergomi(args, device)
    cfg = CalibrationConfig(use_vega_weighting=not args.no_vega_weighting,
                            max_iterations=args.max_iterations,
                            optimization_methods=tuple(args.methods),
                            seed=args.seed, verbose=args.verbose).validate()
    hp = HestonParams(kappa=2.5, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    S0 = 100.0
    if args.model == "vg":
        true = VGParams(sigma=0.18, theta=-0.14, nu=0.35)
        synth, calibrate_fn = create_synthetic_vg_surface, calibrate_vg_to_data
    elif args.model == "bates":
        true = BatesParams(heston=hp, lam=0.4, mu_j=-0.12, sigma_j=0.18)
        synth, calibrate_fn = create_synthetic_bates_surface, calibrate_bates_to_data
    else:
        true = hp
        synth, calibrate_fn = create_synthetic_heston_surface, calibrate_heston_to_data
    K, T, iv = synth(true, S0=S0, rate=args.rate, noise_std=args.noise, seed=args.seed,
                     device=device)
    log.info(f"Synthetic calibration test: true {true}")
    params, summary = calibrate_fn(K, T, iv, S0=S0, rate=args.rate, config=cfg,
                                   div_yield=args.div_yield, device=device)
    summary["true_params"] = true
    got, want = params.to_array(), true.to_array()
    names = (["sigma", "theta", "nu"] if args.model == "vg"
             else ["kappa", "theta", "xi", "rho", "v0", "lam", "mu_j", "sigma_j"][:len(got)])
    summary["param_errors"] = {n: float(abs(g - w)) for n, g, w in zip(names, got, want)}
    summary["params"] = params

    if args.price_surface:
        _price_surface(args, params, S0, device)
        summary["surface_csv"] = args.price_surface
    return summary


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    args = parse_args(argv)
    try:
        summary = run(args)
    except Exception as e:
        log.error(f"Calibration failed: {e}")
        return 1
    print(f"Calibrated: {summary['params']}")
    print(f"Weighted IV RMSE: {summary['error']:.6f}")
    if "param_errors" in summary:
        errs = ", ".join(f"{k}={v:.4f}" for k, v in summary["param_errors"].items())
        print(f"Recovery |error| vs truth: {errs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
