"""Correlated multi-asset GBM kernels (csrc/basket.cu) and their plain
PyTorch versions: kernel 27 (``basket_paths``, the path matrix) and kernel
28 (``basket_terminal``, S_T only), the port's own for
options_model_tpu/models/multiasset.py:48 simulate_gbm_basket and :107
gbm_basket_terminal_exact, which the reference computes in XLA. Kernel 28
has two designs: ``basket_terminal`` launches the redesign
(basket_terminal_kernel: terminal_slots(n) adjacent slots a thread, the
round keys once per launch, a 2-D grid with no division),
``basket_terminal_first`` the first design (basket_kernel's terminal mode), its yardstick, which no
pricer calls; both give the same bits.

The wrappers take the plain version (``basket_*_reference``: the basket
stream's normals, ops/philox.basket_path_draws, through
models/multiasset.basket_chain) for a CPU device and launch the kernel for
a CUDA device; there is no fallback between the two. ``c`` is
models/multiasset.basket_constants's dict. Assets 1-8 run compile-time
instances with the constants by value and the state in registers; 9 to
MAX_ASSETS the generic instance with both in shared memory; more raise.
"""

from __future__ import annotations

import numpy as np
import torch

from options_model_tpu_torch.models.multiasset import basket_chain
from options_model_tpu_torch.ops import _build
from options_model_tpu_torch.ops.cuda_heston import PATH_TILE, _tiles
from options_model_tpu_torch.ops.engine import resolve_device
from options_model_tpu_torch.ops.philox import basket_calls, basket_path_draws

# Kernel launches since the last reset, one integer per kernel.
launches = {"basket_paths": 0, "basket_terminal": 0, "basket_terminal_first": 0}
# The most assets the generic instance holds (csrc/basket.cu kMaxAssets);
# up to REGISTER_ASSETS the state lives in registers.
MAX_ASSETS = 128
REGISTER_ASSETS = 8
_MODES = {"terminal": 0, "paths": 1, "debug": 2, "terminal_first": 3}


def terminal_slots(n_assets: int) -> int:
    """Adjacent slots a thread of kernel 28's redesign at n_assets (1-8;
    csrc/basket.cu kTermSlots), where the tile's half (its width without
    antithetics) is a multiple of it; one slot a thread elsewhere."""
    return 4 if n_assets <= 3 else 2


def _n_assets(c: dict) -> int:
    n = int(c["s0"].shape[0])
    if not 1 <= n <= MAX_ASSETS:
        raise ValueError(f"the basket kernels take 1 to {MAX_ASSETS} assets, got {n}")
    return n


def _geometry(seed: int, c: dict, n_paths: int, n_steps: int, first_tile: int, tile: int):
    n = _n_assets(c)
    if n_steps * basket_calls(n) >= 1 << 31:
        raise ValueError(f"{n_steps} steps x {basket_calls(n)} draws a step leave int32")
    return n, _tiles(n_paths, tile, seed, first_tile, n_steps)


def basket_reference(seed: int, c: dict, n_paths: int, n_steps: int, antithetic: bool = True,
                     first_tile: int = 0, tile: int = PATH_TILE, device=None,
                     mode: str = "paths"):
    """Plain version of a launch in ``mode`` ("paths", "terminal" or
    "debug", basket_chain's), n_pad = n_paths rounded up to ``tile``."""
    n, n_tiles = _geometry(seed, c, n_paths, n_steps, first_tile, tile)
    z = basket_path_draws(seed, first_tile, n_tiles, tile, n_steps, n, antithetic, device)
    return basket_chain(z, c, mode)


def basket_paths_reference(seed: int, c: dict, n_paths: int, n_steps: int,
                           antithetic: bool = True, first_tile: int = 0, tile: int = PATH_TILE,
                           device=None) -> torch.Tensor:
    """Plain version of kernel 27: S (n_steps+1, n, n_pad)."""
    return basket_reference(seed, c, n_paths, n_steps, antithetic, first_tile, tile, device,
                            "paths")


def basket_terminal_reference(seed: int, c: dict, n_paths: int, n_steps: int,
                              antithetic: bool = True, first_tile: int = 0,
                              tile: int = PATH_TILE, device=None) -> torch.Tensor:
    """Plain version of kernel 28: S_T (n, n_pad)."""
    return basket_reference(seed, c, n_paths, n_steps, antithetic, first_tile, tile, device,
                            "terminal")


def _packed(c: dict) -> np.ndarray:
    """s0, drift, vol and L's rows packed (row a's a + 1 entries), float32."""
    rows, cols = np.tril_indices(c["s0"].shape[0])
    return np.concatenate([c["s0"], c["drift"], c["vol"], c["L"][rows, cols]]).astype(np.float32)


def basket_launch(seed: int, c: dict, n_paths: int, n_steps: int, antithetic: bool,
                  first_tile: int, tile: int, device, mode: str):
    """One launch of csrc/basket.cu on a CUDA device in ``mode``: S
    (terminal: kernel 28's redesign; terminal_first: its first design;
    paths) or (log-states, W) (debug). Counts the launches of every mode
    but debug."""
    _build.require_cuda(device)
    n, n_tiles = _geometry(seed, c, n_paths, n_steps, first_tile, tile)
    n_pad = n_tiles * tile
    shape = (n, n_pad) if mode.startswith("terminal") else (n_steps + 1, n, n_pad)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    aux = (torch.empty((n_steps, n, n_pad), dtype=torch.float32, device=device)
           if mode == "debug" else out)
    packed = _packed(c)
    # up to REGISTER_ASSETS the kernel takes them by value from the host
    dev = None if n <= REGISTER_ASSETS else torch.from_numpy(packed).to(device)
    _build.launch("omt_basket", device, out.data_ptr(), aux.data_ptr(),
                  _build.float_buffer(packed), 0 if dev is None else dev.data_ptr(), seed,
                  first_tile, n_tiles, tile, n_steps, n, int(antithetic), _MODES[mode])
    if mode == "debug":
        return out, aux
    launches[f"basket_{mode}"] += 1
    return out


def basket_paths(seed: int, c: dict, n_paths: int, n_steps: int, antithetic: bool = True,
                 first_tile: int = 0, tile: int = PATH_TILE, device=None) -> torch.Tensor:
    """Kernel 27: S (n_steps+1, n, n_pad) on a CUDA device, the plain version
    on the CPU."""
    device = resolve_device(device)
    if device.type == "cpu":
        return basket_paths_reference(seed, c, n_paths, n_steps, antithetic, first_tile, tile,
                                      device)
    return basket_launch(seed, c, n_paths, n_steps, antithetic, first_tile, tile, device,
                         "paths")


def _terminal(mode: str, seed: int, c: dict, n_paths: int, n_steps: int, antithetic: bool,
              first_tile: int, tile: int, device) -> torch.Tensor:
    device = resolve_device(device)
    if device.type == "cpu":
        return basket_terminal_reference(seed, c, n_paths, n_steps, antithetic, first_tile,
                                         tile, device)
    return basket_launch(seed, c, n_paths, n_steps, antithetic, first_tile, tile, device, mode)


def basket_terminal(seed: int, c: dict, n_paths: int, n_steps: int, antithetic: bool = True,
                    first_tile: int = 0, tile: int = PATH_TILE, device=None) -> torch.Tensor:
    """Kernel 28 (its redesign): S_T (n, n_pad) on a CUDA device, the plain
    version on the CPU; on the same stream the paths kernel's last row and
    the first design's output bit for bit."""
    return _terminal("terminal", seed, c, n_paths, n_steps, antithetic, first_tile, tile, device)


def basket_terminal_first(seed: int, c: dict, n_paths: int, n_steps: int,
                          antithetic: bool = True, first_tile: int = 0, tile: int = PATH_TILE,
                          device=None) -> torch.Tensor:
    """Kernel 28's first design on a CUDA device, the plain version on the
    CPU: the redesign's yardstick, which no pricer calls. The arguments are
    basket_terminal's."""
    return _terminal("terminal_first", seed, c, n_paths, n_steps, antithetic, first_tile, tile,
                     device)


def basket_kernel_attrs(n_assets: int) -> dict:
    """Registers, local bytes and occupancy of the instances a launch at
    n_assets runs, by kernel name (kernel 28's redesign: its antithetic
    instance at terminal_slots(n_assets))."""
    return {name: _build.kernel_attrs("omt_basket_attrs", n_assets, mode)
            for name, mode in (("basket_paths", 1), ("basket_terminal", 0),
                               ("basket_terminal_first", 3))}
