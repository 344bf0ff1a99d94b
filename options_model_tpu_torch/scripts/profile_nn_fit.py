"""Where the NN-LSM's fit spends its time on the card.

One epoch of ``fit_continuation_mlp`` (512 AdamW steps on minibatches of
4096, then the full-data loss) at the shape of the NN legs of chip_smoke.py:
49 exercise dates x 2^18 paths = 12,845,056 rows of 7 features, the
LSMConfig(regressor="nn") defaults (128 x 3, dropout 0.1). The data are
random (the time does not depend on the values). Prints the host-clock
seconds of the epoch and of the full-data loss alone, and from a
torch.profiler trace of the epoch: device kernels launched, device-busy
time (the sum of kernel durations) and the kernels that take most of it.

    python -m options_model_tpu_torch.scripts.profile_nn_fit

Runs on a CUDA device only and raises without one.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from options_model_tpu_torch.core.config import LSMConfig
from options_model_tpu_torch.pricers.regressors import (ContinuationMLP,
                                                        fit_continuation_mlp,
                                                        full_weighted_loss)
from options_model_tpu_torch.utils.profiling import card_line

N_ROWS = 49 * (1 << 18)
N_FEATURES = 7


def _seconds(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def run(n_rows: int = N_ROWS, log=print) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profiling the fit needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"card: {card_line()}; {n_rows} rows x {N_FEATURES} features")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn(n_rows, N_FEATURES, generator=g, device=dev)
    y = torch.randn(n_rows, generator=g, device=dev)
    w = (torch.rand(n_rows, generator=g, device=dev) < 0.5).float()
    cfg = dataclasses.replace(LSMConfig(regressor="nn"), nn_epochs=1)
    fit_continuation_mlp(g, X, y, w, cfg)                 # warm-up
    epoch_s = _seconds(lambda: fit_continuation_mlp(g, X, y, w, cfg))
    net = ContinuationMLP(N_FEATURES, cfg.nn_hidden, cfg.nn_layers, cfg.nn_dropout,
                          device=dev)
    loss_s = _seconds(lambda: full_weighted_loss(net, X, y, w))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fit_continuation_mlp(g, X, y, w, cfg)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    steps = 512
    out = dict(epoch_s=epoch_s, full_loss_s=loss_s, n_kernels=len(kernels),
               device_busy_s=busy_us / 1e6, top=top)
    log(f"one epoch ({steps} steps + full-data loss): {epoch_s:.3f} s host clock; "
        f"full-data loss alone {loss_s:.3f} s; per step "
        f"{(epoch_s - loss_s) / steps * 1e3:.3f} ms")
    log(f"profiled epoch: {len(kernels)} device kernels ({len(kernels) / steps:.1f} per "
        f"step), device busy {busy_us / 1e6:.3f} s")
    for name, us in top:
        log(f"  {us / 1e3:9.3f} ms  {name[:100]}")
    return out


def main() -> None:
    run()


if __name__ == "__main__":
    main()
