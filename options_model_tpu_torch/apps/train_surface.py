"""IV-surface network training CLI, as options_model_tpu/apps/train_surface.py.

    python -m options_model_tpu_torch.apps.train_surface --test --save ckpt/iv_surface
    python -m options_model_tpu_torch.apps.train_surface --ticker AAPL --epochs 50

``--test`` trains on the synthetic smile oracle (data/synthetic.py), with
no network access. A ``--ticker`` run fetches the chain through
data/market.fetch_option_chain, which raises MarketDataError without
yfinance. ``--save`` writes the torch checkpoint (surface/train.py) that
``IVSurfaceModel.restore`` reloads. The fit runs on the card;
``run(args, device="cpu")`` runs it on the CPU. ``--diagnostics-dir`` is
not ported (utils/plotting.py).
"""

from __future__ import annotations

import argparse
import logging
import sys

from options_model_tpu_torch.core.config import SurfaceTrainConfig

log = logging.getLogger(__name__)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train the implied-volatility surface network")
    p.add_argument("--ticker", type=str, default="AAPL")
    p.add_argument("--test", action="store_true",
                   help="Train on the synthetic smile oracle (no network)")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--hidden-dim", type=int, default=64)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--lambda-butterfly", type=float, default=1e-3,
                   help="Butterfly (convexity-in-K) arbitrage penalty weight")
    p.add_argument("--lambda-calendar", type=float, default=1e-4)
    p.add_argument("--vega-weight", action="store_true",
                   help="Vega-weighted loss (off by default, as in the reference CLI)")
    p.add_argument("--no-augmentation", action="store_true")
    p.add_argument("--patience", type=int, default=8)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--rate", type=float, default=0.05)
    p.add_argument("--save", type=str, default=None,
                   help="Checkpoint directory to write")
    p.add_argument("--diagnostics-dir", type=str, default=None,
                   help="Write the 2x2 training diagnostics PNG here (not ported)")
    return p.parse_args(argv)


def run(args, device=None) -> dict:
    from options_model_tpu_torch.surface.model import IVSurfaceModel

    cfg = SurfaceTrainConfig(
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        hidden_dim=args.hidden_dim, num_hidden_layers=args.layers,
        lambda_butterfly=args.lambda_butterfly, lambda_calendar=args.lambda_calendar,
        use_vega_weighting=args.vega_weight,
        use_augmentation=not (args.no_augmentation or args.test),
        patience=args.patience, seed=args.seed).validate()
    if args.test:
        from options_model_tpu_torch.data.synthetic import synthetic_smile_surface
        K, T, iv, S0 = synthetic_smile_surface()
        log.info(f"Synthetic training: {len(K)} smile-oracle observations")
    else:
        from options_model_tpu_torch.data.market import fetch_option_chain
        K, T, iv, S0 = fetch_option_chain(args.ticker)
        log.info(f"Training on {len(K)} {args.ticker} options, S0={S0:.2f}")
    model = IVSurfaceModel.fit(K, T, iv, S0, cfg, rate=args.rate,
                               diagnostics_dir=args.diagnostics_dir, device=device)
    if args.save:
        model.save(args.save)
        log.info(f"Checkpoint written to {args.save}")
    return {"model": model, "val_loss": model.best_val_loss, "n_points": len(K), "S0": S0}


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = parse_args(argv)
    try:
        out = run(args)
    except Exception as e:  # the CLI's boundary: report and exit 1, as the reference
        log.error(f"Training failed: {e}")
        return 1
    print(f"Training completed. Best validation loss: {out['val_loss']:.6f}")
    print(f"Trained on {out['n_points']} data points, S0=${out['S0']:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
