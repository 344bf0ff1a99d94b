"""The JAX package's numbers that chip_smoke.py's IV-surface path (its [V]
lines) holds the PyTorch port to, measured on the CPU.

    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/ivnn_jax_bars.py

Prints one JSON object:
- "test": options_model_tpu.apps.train_surface's --test fit (the synthetic
  smile, 50 epochs, hidden 64 x 4 blocks, dropout 0.1) at seeds 0-39: the
  IV RMSE against the synthetic oracle and best_val_loss, and over the
  seeds their geometric means and the standard deviations of their logs;
- "chain": SurfaceTrainConfig() at the same seeds on the recorded chain
  (tests/data/chain_fixture.json, parsed by fetch_option_chain from the
  feed stub of tests/test_livechain_e2e.py, the rows in (T, K, iv) order as
  the port's read_chain_fixture gives them, at the recording's rate 0.045):
  the IV RMSE against its quotes and best_val_loss, and the same summaries;
- "svi": tests/test_svi.py's Heston-smile SVI surface (4 expiries x 14
  strikes) and its Dupire local vol at T = 0.75 through the XLA local-vol
  simulator, calls at K = 90, 100, 110, pooled over four seeds of 2^20
  paths, at 100 and 48 steps: price, stderr (over paths) and the gap to the
  Heston COS price.

Runs the JAX package only; the port's chip_smoke.py records the printed
values as constants.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np

from options_model_tpu.apps import train_surface
from options_model_tpu.calibration.charfn import heston_cos_price
from options_model_tpu.core.config import HestonParams, MCConfig, SurfaceTrainConfig
from options_model_tpu.data.synthetic import synthetic_smile_surface
from options_model_tpu.models.localvol import simulate_local_vol
from options_model_tpu.pricers.blackscholes import implied_vol
from options_model_tpu.surface.model import IVSurfaceModel
from options_model_tpu.surface.svi import fit_svi_surface
from tests.test_livechain_e2e import _fixture_ticker, _load_fixture


SEEDS = tuple(range(40))


def _geomean(x) -> float:
    return float(np.exp(np.mean(np.log(x))))


def fits() -> dict:
    """Both fits at each seed of SEEDS, and the geometric means of their IV
    RMSE and best_val_loss over all the seeds."""
    import types

    from options_model_tpu.data import market

    K, T, iv, _ = synthetic_smile_surface()
    fx = _load_fixture()
    tk = _fixture_ticker(fx)
    market.yf, market._YF = types.SimpleNamespace(Ticker=lambda s: tk), True
    Kc, Tc, ivc, S0 = market.fetch_option_chain("RECORDED")
    order = np.lexsort((ivc, Kc, Tc))
    Kc, Tc, ivc = Kc[order], Tc[order], ivc[order]
    out = {"test": {}, "chain": {}}
    for seed in SEEDS:
        model = train_surface.run(train_surface.parse_args(["--test", "--seed", str(seed)]))["model"]
        out["test"][seed] = {"rmse": float(np.sqrt(np.mean((model.predict(K, T) - iv) ** 2))),
                             "best_val_loss": model.best_val_loss}
        chain = IVSurfaceModel.fit(Kc, Tc, ivc, S0, SurfaceTrainConfig(seed=seed),
                                   rate=fx["meta"]["rate"])
        out["chain"][seed] = {"rmse": float(np.sqrt(np.mean((chain.predict(Kc, Tc) - ivc) ** 2))),
                              "best_val_loss": chain.best_val_loss}
    for fit in ("test", "chain"):
        for key in ("rmse", "best_val_loss"):
            vals = [out[fit][s][key] for s in SEEDS]
            out[fit][f"geomean {key}"] = _geomean(vals)
            out[fit][f"log sd {key}"] = float(np.std(np.log(vals)))
    return out


def svi(seeds=4, n_paths=1 << 20) -> dict:
    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.4, rho=-0.6, v0=0.04)
    S0, R, T = 100.0, 0.05, 0.75
    Ks = np.linspace(75.0, 130.0, 14)
    exps = [0.25, 0.5, 0.75, 1.0]
    rows = []
    for Te in exps:
        px = heston_cos_price(S0, jnp.asarray(Ks), Te, R, hp, cp=1.0)
        rows.append(np.asarray(implied_vol(px, S0, jnp.asarray(Ks), Te, R, cp=1.0)))
    surf, _ = fit_svi_surface(S0, R, exps, [Ks] * 4, rows)
    fn = surf.local_vol_fn(T_option=T)
    out = {}
    for n_steps in (100, 48):
        cfg = MCConfig(n_paths=n_paths, n_steps=n_steps, path_block=4096)
        S_T = np.concatenate([np.asarray(simulate_local_vol(jax.random.key(s), S0, R, T, fn, cfg,
                                                            return_paths=False))
                              for s in range(seeds)])
        for K in (90.0, 100.0, 110.0):
            pay = np.exp(-R * T) * np.maximum(S_T - K, 0.0)
            cos = float(heston_cos_price(S0, K, T, R, hp, cp=1.0))
            out[f"{n_steps} steps, K {K:g}"] = {
                "price": float(pay.mean()), "stderr": float(pay.std() / np.sqrt(pay.size)),
                "cos": cos, "gap": float(pay.mean() / cos - 1.0)}
    return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps({**fits(), "svi": svi()}, indent=1))
