"""Where one evaluation of the calibration objective spends its time on the card.

The objective (``calibrator._objective_core``, float64: COS prices, the IV
solve's 64 bisections and 8 Newton steps, the vega-weighted RMSE) with its
gradient, as the calibrator's L-BFGS-B sees it, at x0 on the float64
synthetic surfaces chip_smoke.py calibrates: Heston (bench.py's exact round
trip, 15 strikes x 4 expiries, 256 terms), Bates (17 x 5, 256 terms) and VG
(15 x 6, 2048 terms). Per model it prints the host-clock milliseconds of a
value-and-gradient evaluation and of a value alone (median of 20 after
warm-up, each ending in the one copy to the host), and from a
torch.profiler trace of one value-and-gradient evaluation: device kernels
launched, host-to-device and device-to-host copies, and the device-busy
share (the sum of kernel durations over the evaluation's host time).

    python -m options_model_tpu_torch.scripts.profile_calibration

Runs on a CUDA device only and raises without one. With ``--count-cascade``
it instead runs the default three-method cascade (CalibrationConfig()) on
bench.py's noisy Heston surface (noise 0.005, seed 7) on the CPU and prints
each method's evaluations: the counts that, times the card's milliseconds
per evaluation, project the default cascade's seconds on the card
(chip_smoke.py's DEFAULT_CASCADE_NFEV). The count does not depend on the
device beyond the last bits of the objective. With ``--chain`` it takes the
recorded chain's ("L-BFGS-B",) fit apart on the card (chip_smoke.py's C6):
the fit, each start's L-BFGS-B terminal, the polish from each terminal
(value, evaluations, seconds, whether its first solve converged), and the
largest difference between the card's and the host's residuals there.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from options_model_tpu_torch.calibration.calibrator import (HestonCalibrator, MarketSurface,
                                                            _residuals_core)
from options_model_tpu_torch.calibration.synthetic import (create_synthetic_bates_surface,
                                                           create_synthetic_heston_surface,
                                                           create_synthetic_vg_surface)
from options_model_tpu_torch.core.config import (BatesParams, CalibrationConfig, HestonParams,
                                                 VGParams)
from options_model_tpu_torch.data.market import read_chain_fixture
from options_model_tpu_torch.utils.profiling import card_line

N_TIMED = 20
HESTON = HestonParams(kappa=3.0, theta=0.05, xi=0.4, rho=-0.6, v0=0.045)
BATES = BatesParams(heston=HestonParams(kappa=2.5, theta=0.05, xi=0.45, rho=-0.6, v0=0.045),
                    lam=0.4, mu_j=-0.12, sigma_j=0.18)
VG = VGParams(sigma=0.18, theta=-0.14, nu=0.35)


def surfaces(device) -> dict:
    """model -> (MarketSurface, true params) at chip_smoke.py's C1, C4, C5."""
    f64 = dict(dtype=np.float64, device=device)
    K, T, iv = create_synthetic_heston_surface(HESTON, **f64)
    Kb, Tb, ivb = create_synthetic_bates_surface(BATES, S0=100.0, rate=0.04,
                                                 strikes=np.linspace(70, 130, 17), **f64)
    Kv, Tv, ivv = create_synthetic_vg_surface(VG, S0=100.0, rate=0.05, **f64)
    return {"heston": (MarketSurface(K, T, iv, 100.0, 0.05), HESTON),
            "bates": (MarketSurface(Kb, Tb, ivb, 100.0, 0.04), BATES),
            "vg": (MarketSurface(Kv, Tv, ivv, 100.0, 0.05), VG)}


def profile_objective(surface: MarketSurface, model: str, device="cuda") -> dict:
    """ms per value-and-gradient and per value evaluation at x0 (host clock,
    median of N_TIMED), and one value-and-gradient evaluation's device
    kernels, copies and device-busy share (torch.profiler)."""
    cal = HestonCalibrator(model=model, device=device)
    f, f_and_g, bounds = cal._make_objective(surface)
    x0 = np.clip(cal._x0(surface), [b[0] for b in bounds], [b[1] for b in bounds])

    def ms(fn):
        fn()
        times = []
        for _ in range(N_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    vg_ms, v_ms = ms(lambda: f_and_g(x0)), ms(lambda: f(x0))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        f_and_g(x0)
        host_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    cuda = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in cuda if "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower()]
    copies = {k: sum(1 for e in cuda if k in e.name) for k in ("HtoD", "DtoH")}
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    return dict(model=model, points=len(surface), n_terms=cal._n_terms(), n_timed=N_TIMED,
                ms_value_and_grad=vg_ms, ms_value=v_ms, kernels=len(kernels),
                copies_htod=copies["HtoD"], copies_dtoh=copies["DtoH"],
                device_busy_share=busy_us / host_us)


def run(log=print) -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("profiling the calibration objective needs a CUDA device")
    log(f"card: {card_line()}")
    out = []
    for model, (surface, _) in surfaces("cuda").items():
        r = profile_objective(surface, model)
        out.append(r)
        log(f"{model}: {r['points']} points x {r['n_terms']} terms: value and gradient "
            f"{r['ms_value_and_grad']:.3f} ms, value {r['ms_value']:.3f} ms (host clock, "
            f"median of {r['n_timed']}); "
            f"{r['kernels']} device kernels, {r['copies_htod']} host-to-device and "
            f"{r['copies_dtoh']} device-to-host copies per value-and-gradient evaluation, "
            f"device busy {r['device_busy_share'] * 100:.1f}%")
    return out


def count_cascade(log=print) -> dict:
    """Evaluations of each method of the default cascade on the noisy
    Heston surface, on the CPU: {method: {"error", "nfev", "seconds"}}."""
    K, T, iv = create_synthetic_heston_surface(HESTON, noise_std=0.005, seed=7,
                                               dtype=np.float64, device="cpu")
    cal = HestonCalibrator(device="cpu")
    cal.calibrate(MarketSurface(K, T, iv, 100.0, 0.05))
    for method, r in cal.method_results.items():
        log(f"{method}: {r['nfev']} evaluations, error {r['error']!r}")
    log(f"default cascade: {cal.n_evaluations} evaluations with the probe at x0")
    return cal.method_results


def chain_diagnosis(device="cuda", log=print) -> list:
    """The recorded chain's ("L-BFGS-B",) fit on ``device``, then from each
    start's L-BFGS-B terminal the reference's polish: per terminal its start
    value, the polished value, evaluations, seconds and whether the first
    solve converged, and max |residual on the device - on the host| there."""
    K, T, iv, S0, meta = read_chain_fixture()
    surface = MarketSurface(K, T, iv, S0, meta["rate"])
    cal = HestonCalibrator(CalibrationConfig(optimization_methods=("L-BFGS-B",)), device=device)
    t0 = time.perf_counter()
    params = cal.calibrate(surface)
    log(f"fit on {device}: {params}, IV RMSE {cal.best_error!r}, {cal.n_evaluations} "
        f"evaluations, {time.perf_counter() - t0:.1f} s")
    f, _, bounds = cal._make_objective(surface)
    kw = dict(n_terms=cal._n_terms(), model="heston")
    out = []
    for fun, x in sorted(cal.start_results, key=lambda e: e[0]):
        r_dev, r_host = (_residuals_core(torch.as_tensor(x, device=d), K, T, iv, S0,
                                         meta["rate"], **kw).cpu().numpy()
                         for d in (device, "cpu"))
        n0, t0 = cal.n_evaluations, time.perf_counter()
        x_ls, f_ls, converged = cal._least_squares_polish(surface, x, bounds, f)
        r = dict(start=fun, x=x.tolist(), polished=f_ls, x_polished=x_ls.tolist(),
                 evaluations=cal.n_evaluations - n0, seconds=time.perf_counter() - t0,
                 converged=converged, residual_device_host=float(np.abs(r_dev - r_host).max()))
        out.append(r)
        log(f"start kappa {x[0]:.4f}: L-BFGS-B {fun!r} -> polish {f_ls!r} at "
            f"{np.round(x_ls, 4).tolist()}, {r['evaluations']} evaluations, "
            f"{r['seconds']:.1f} s, first solve {'converged' if converged else 'at max_nfev'}; "
            f"max |residual {device} - host| {r['residual_device_host']:.3e}")
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--count-cascade", action="store_true",
                      help="count the default cascade's evaluations on the CPU instead")
    mode.add_argument("--chain", action="store_true",
                      help="take the recorded chain's fit apart on the card instead")
    args = p.parse_args(argv)
    if args.count_cascade:
        count_cascade()
    elif args.chain:
        chain_diagnosis()
    else:
        run()


if __name__ == "__main__":
    main()
