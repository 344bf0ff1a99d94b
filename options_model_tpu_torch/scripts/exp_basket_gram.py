"""The Bermudan basket put of chip_smoke.py's B3/B4 law by assets, its
regressions in float32 beside float64: at which width the float32 Gram of
the basket basis (pricers/american_basket.build_basket_basis, 1 + 2n +
n(n-1)/2 + 1 columns) stops exercising, which sets
american_basket.FLOAT32_GRAM_ASSETS.

At each n: equal weights, S0 = 100, sigma_i = 0.15 + step i (step 0.01 up
to 16 assets, else 0.003), pairwise rho 0.4, q 2%, r 5%, T 1, K 105, 12
dates; kernel 27's paths (models/multiasset.simulate_gbm_basket) made once,
then lsm_basket_backward with ``gram_dtype`` float32 and float64 on them,
each price beside the European on the same paths (no exercise) and the
seconds it took. Run from the root of a checkout:

    python -m options_model_tpu_torch.scripts.exp_basket_gram [--paths N]
        [--device cuda|cpu] [--assets 12 16 ...]

On a CUDA device by default; ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from options_model_tpu_torch.core.config import MCConfig
from options_model_tpu_torch.models.multiasset import simulate_gbm_basket
from options_model_tpu_torch.pricers.american import simulated_config
from options_model_tpu_torch.pricers.american_basket import lsm_basket_backward
from options_model_tpu_torch.utils.profiling import card_line


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(n_assets, n_paths: int, device: torch.device) -> list:
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for n in n_assets:
        step = 0.01 if n <= 16 else 0.003
        sig = [0.15 + step * i for i in range(n)]
        corr = np.full((n, n), 0.4) + 0.6 * np.eye(n)
        w = [1.0 / n] * n
        mc = MCConfig(n_paths=n_paths, n_steps=12)
        S = simulate_gbm_basket(3, [100.0] * n, 0.05, sig, corr, 1.0, simulated_config(mc, "gbm"),
                                div_yields=[0.02] * n, return_paths=True, device=device)
        basket = torch.tensordot(torch.tensor(w, dtype=torch.float64, device=device),
                                 S[-1].double(), dims=1)
        european = float(torch.clamp_min(105.0 - basket, 0.0).mean()) * math.exp(-0.05)
        row = dict(assets=n, columns=n * (n + 3) // 2 + 2, paths=int(S.shape[-1]),
                   european=european)
        for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
            _sync(device)
            t0 = time.perf_counter()
            price = float(lsm_basket_backward(S, 105.0, 0.05, 1.0, -1.0, kind="basket",
                                              weights=w, gram_dtype=dtype)[0])
            _sync(device)
            row[name] = price
            row[f"{name}_premium"] = price - european
            row[f"{name}_seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
        del S
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paths", type=int, default=1 << 17)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--assets", type=int, nargs="+", default=[12, 16, 20, 24, 32, 40, 50])
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for the plain versions")
    run(args.assets, args.paths, device)
    if device.type == "cuda":
        print(f"card: {card_line()}")


if __name__ == "__main__":
    main()
