"""IV-surface training, as options_model_tpu/surface/train.py:
- the 85/15 split of the original observations with default_rng(seed), then
  three noisy copies of each training observation (augmentation), in numpy,
  so the data the network sees is the reference's bit for bit;
- the scaler fitted on the training fold; vega weights that travel with
  their samples; the training set padded to whole batches with zero-weight
  rows;
- per step: the weighted MSE with dropout live plus the finite-difference
  penalty on the deterministic network, optax's clip_by_global_norm, then
  AdamW (b1 0.9, b2 0.999, eps 1e-8, ``weight_decay`` on every parameter) at
  optax.cosine_decay_schedule(lr, epochs x batches) read at the step count
  before the update;
- best-state early stopping at ``patience`` with a 1e-6 margin;
- checkpoints through torch.save, with the restore path.

Randomness: a CPU torch.Generator seeded with the seed draws the init, so
the starting network does not depend on the device; a generator on the
fit's device (_fit_generator) draws each epoch's permutation and every
dropout mask, so no step waits on a copy from the host.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional

import numpy as np
import torch

from options_model_tpu_torch._unported import not_ported
from options_model_tpu_torch.core.config import SurfaceTrainConfig
from options_model_tpu_torch.ops.engine import checked_device
from options_model_tpu_torch.ops.philox import philox4x32
from options_model_tpu_torch.surface.loss import arbitrage_penalty_fd, vega_weights
from options_model_tpu_torch.surface.network import IVNetwork, init_params, make_network
from options_model_tpu_torch.surface.scaler import SurfaceScaler

CHECKPOINT_FILE = "checkpoint.pt"


@dataclasses.dataclass
class SurfaceTrainResult:
    state_dict: dict
    scaler: SurfaceScaler
    config: SurfaceTrainConfig
    best_val_loss: float
    train_losses: List[float]
    val_losses: List[float]
    epochs_run: int


@dataclasses.dataclass
class SurfaceData:
    """The fit's tensors on its device: the padded training set (rows
    [n_train, n_batches x batch) have weight 0) and the validation fold."""

    X_train: torch.Tensor
    y_train: torch.Tensor
    w_train: torch.Tensor
    X_val: torch.Tensor
    y_val: torch.Tensor
    w_val: torch.Tensor
    scaler: SurfaceScaler
    batch: int
    n_batches: int
    mean_iv: float


def prepare_data(K, T, sigma_iv, S0: float, cfg: SurfaceTrainConfig, rate: float, seed: int,
                 device: torch.device) -> SurfaceData:
    """The split, augmentation, scaler, features, weights and padding of the
    reference's train_iv_surface, in its numpy order."""
    K = np.asarray(K, np.float32)
    T = np.asarray(T, np.float32)
    y = np.asarray(sigma_iv, np.float32)

    # Split the original observations first: augmenting before the split
    # would put near-duplicates of training points into the validation fold.
    perm = np.random.default_rng(seed).permutation(len(y))
    n_val = max(1, int(len(y) * cfg.val_split))
    val_idx, tr_idx = perm[:n_val], perm[n_val:]
    Ktr, Ttr, ytr = K[tr_idx], T[tr_idx], y[tr_idx]
    Kva, Tva, yva = K[val_idx], T[val_idx], y[val_idx]
    if cfg.use_augmentation:
        # Three copies of each training observation, noise on the IV only.
        noise = np.random.default_rng(seed).normal(0.0, 0.005, (3, len(ytr))).astype(np.float32)
        Ktr, Ttr = np.tile(Ktr, 4), np.tile(Ttr, 4)
        ytr = np.concatenate([ytr] + [np.maximum(ytr + n, 0.01) for n in noise])
    scaler = SurfaceScaler.fit(np.log(Ktr / S0), Ttr, S0)

    def features(Kf, Tf):
        m_norm, tau_norm = scaler.transform(np.log(Kf / S0), Tf)
        return np.stack([m_norm, tau_norm], -1).astype(np.float32)

    def weights(Kf, Tf, yf):
        if cfg.use_vega_weighting:
            return vega_weights(torch.from_numpy(Kf).to(device), torch.from_numpy(Tf).to(device),
                                torch.from_numpy(yf).to(device), S0, rate)
        return torch.ones(len(yf), dtype=torch.float32, device=device)

    batch = min(cfg.batch_size, len(ytr))
    n_batches = -(-len(ytr) // batch)
    pad = n_batches * batch - len(ytr)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    zeros = torch.zeros(pad, dtype=torch.float32, device=device)
    return SurfaceData(
        X_train=on(np.concatenate([features(Ktr, Ttr), np.zeros((pad, 2), np.float32)])),
        y_train=on(np.concatenate([ytr, np.zeros((pad,), np.float32)])),
        w_train=torch.cat([weights(Ktr, Ttr, ytr), zeros]),
        X_val=on(features(Kva, Tva)), y_val=on(yva), w_val=weights(Kva, Tva, yva),
        scaler=scaler, batch=batch, n_batches=n_batches, mean_iv=float(y.mean()))


def _weighted_mse(pred: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (w * (pred - y) ** 2).sum() / torch.clamp_min(w.sum(), 1e-8)


def _clip_by_global_norm_(params, max_norm: float) -> None:
    """optax.clip_by_global_norm: g -> (g / ||g||) max_norm when ||g|| is not
    below max_norm, else g (torch's clip_grad_norm_ divides by ||g|| + 1e-6
    and always scales). No host read."""
    grads = [p.grad for p in params]
    norm = torch.stack([(g * g).sum() for g in grads]).sum().sqrt()
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def _fit_generator(seed: int, device: torch.device) -> torch.Generator:
    """The fit's generator on ``device``: its 64-bit seed is one Philox block
    keyed by ``seed`` at counter (0, 1, 0, 0) (the port's fold_in), apart
    from the init's stream."""
    w0, w1, _, _ = philox4x32(torch.tensor(0), 1, torch.tensor(0), 0, seed & 0xFFFFFFFF,
                              (seed >> 32) & 0xFFFFFFFF)
    return torch.Generator(device=device).manual_seed(int(w0) | (int(w1) << 32))


def _learning_rate(cfg: SurfaceTrainConfig, step: int, total: int) -> float:
    """optax.cosine_decay_schedule(lr, total) at ``step`` (or the constant
    lr): lr 0.5 (1 + cos(pi min(step, total) / total))."""
    if not cfg.use_cosine_schedule:
        return cfg.lr
    return cfg.lr * 0.5 * (1.0 + math.cos(math.pi * min(step, total) / total))


def _fit(net: IVNetwork, data: SurfaceData, cfg: SurfaceTrainConfig,
         generator: torch.Generator, device: torch.device) -> dict:
    """The epochs of the fit from ``net``'s state: each epoch a permutation
    of the padded training set from ``generator`` (on ``device``) cut into
    batches, one step a batch (dropout masks from ``generator`` too), then
    the validation loss and the early-stopping rule. Returns the best
    state, its loss, the per-epoch losses and the epochs run."""
    net = net.to(device)
    net.set_dropout_generator(generator)
    params = list(net.parameters())
    opt = torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay, fused=device.type == "cuda")
    total = cfg.epochs * data.n_batches
    n_pad = data.n_batches * data.batch
    step = 0
    # as the reference: the state before the first epoch, if none improves
    best_val, patience = float("inf"), 0
    best_state = {k: v.detach().clone() for k, v in net.state_dict().items()}
    train_losses: List[float] = []
    val_losses: List[float] = []

    def deterministic(x):
        net.eval()
        try:
            return net(x)
        finally:
            net.train()

    for _ in range(cfg.epochs):
        order = torch.randperm(n_pad, generator=generator, device=generator.device)
        order = order.to(device).reshape(data.n_batches, data.batch)
        net.train()
        losses = []
        for idx in order:
            xb, yb, wb = data.X_train[idx], data.y_train[idx], data.w_train[idx]
            loss = _weighted_mse(net(xb)[:, 0], yb, wb) + arbitrage_penalty_fd(
                deterministic, xb, data.scaler, cfg.lambda_butterfly, cfg.lambda_calendar)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            _clip_by_global_norm_(params, cfg.grad_clip)
            for group in opt.param_groups:
                group["lr"] = _learning_rate(cfg, step, total)
            opt.step()
            step += 1
            losses.append(loss.detach())
        net.eval()
        with torch.no_grad():
            vl = float(_weighted_mse(net(data.X_val)[:, 0], data.y_val, data.w_val))
        train_losses.append(float(torch.stack(losses).mean()))
        val_losses.append(vl)
        if vl < best_val - 1e-6:
            best_val, patience = vl, 0
            best_state = {k: v.detach().clone() for k, v in net.state_dict().items()}
        else:
            patience += 1
            if patience >= cfg.patience:
                break
    net.set_dropout_generator(None)
    net.eval()
    return dict(state_dict=best_state, best_val_loss=best_val, train_losses=train_losses,
                val_losses=val_losses, epochs_run=len(val_losses))


def train_iv_surface(K, T, sigma_iv, S0: float, cfg: Optional[SurfaceTrainConfig] = None,
                     rate: float = 0.05, seed: Optional[int] = None,
                     diagnostics_dir: Optional[str] = None, device=None) -> SurfaceTrainResult:
    """Train the IV network on observations (K_i, T_i, iv_i) around spot S0,
    on ``device`` (the card by default)."""
    cfg = (cfg or SurfaceTrainConfig()).validate()
    seed = cfg.seed if seed is None else seed
    if diagnostics_dir is not None:
        raise not_ported("diagnostics_dir (utils/plotting.py)",
                         "utils.plotting.plot_training_diagnostics")
    device = checked_device(device)
    data = prepare_data(K, T, sigma_iv, S0, cfg, rate, seed, device)
    net = init_params(cfg, torch.Generator().manual_seed(seed), data.mean_iv)
    out = _fit(net, data, cfg, _fit_generator(seed, device), device)
    return SurfaceTrainResult(scaler=data.scaler, config=cfg, **out)


# --- Checkpoints (save and restore) -------------------------------------------

def save_checkpoint(path: str, result: SurfaceTrainResult) -> None:
    """Write {state_dict, scaler, config, best_val_loss} to
    ``path``/checkpoint.pt (the directory is made), tensors on the CPU."""
    os.makedirs(path, exist_ok=True)
    torch.save({"state_dict": {k: v.detach().cpu() for k, v in result.state_dict.items()},
                "scaler": result.scaler.to_dict(),
                "config": dataclasses.asdict(result.config),
                "best_val_loss": float(result.best_val_loss)},
               os.path.join(path, CHECKPOINT_FILE))


def restore_checkpoint(path: str, device=None) -> SurfaceTrainResult:
    """The result save_checkpoint wrote, its state on ``device`` (the card
    by default); loaded with weights_only=True."""
    device = checked_device(device)
    raw = torch.load(os.path.join(path, CHECKPOINT_FILE), map_location=device,
                     weights_only=True)
    return SurfaceTrainResult(state_dict=raw["state_dict"],
                              scaler=SurfaceScaler.from_dict(raw["scaler"]),
                              config=SurfaceTrainConfig(**raw["config"]),
                              best_val_loss=float(raw["best_val_loss"]),
                              train_losses=[], val_losses=[], epochs_run=0)


def network_from_result(result: SurfaceTrainResult, device=None) -> IVNetwork:
    """The result's network in eval mode on ``device`` (the device of its
    state when None)."""
    if device is None:
        device = next(iter(result.state_dict.values())).device
    net = make_network(result.config).to(device)
    net.load_state_dict(result.state_dict)
    return net.eval()
