"""Correlated multi-asset GBM kernels (csrc/basket.cu) and their plain
PyTorch versions: kernel 27 (``basket_paths``, the path matrix) and kernel
28 (``basket_terminal``, S_T only), the port's own for
options_model_tpu/models/multiasset.py:48 simulate_gbm_basket and :107
gbm_basket_terminal_exact, which the reference computes in XLA. Kernel 28
has two designs: ``basket_terminal`` launches the redesign
(basket_terminal_kernel: terminal_slots(n) adjacent slots a thread, the
round keys once per launch, a 2-D grid with no division),
``basket_terminal_first`` the first design (basket_kernel's terminal
mode, 1-8 assets), its yardstick, which no pricer calls; both give the
same bits.

The wrappers take the plain version (``basket_*_reference``: the basket
stream's normals, ops/philox.basket_path_draws, through
models/multiasset.basket_chain) for a CPU device and launch the kernel for
a CUDA device; there is no fallback between the two. ``c`` is
models/multiasset.basket_constants's dict. A launch takes one of three
routes by its assets (``route``): 1-8 and 9-REGISTER_ASSETS run
compile-time instances with the constants by value and the state in
registers; REGISTER_ASSETS + 1 to MAX_ASSETS the wide route
(basket.cuh basket_wide_kernel: a slot split across groups of threads
that hold its log-states in registers, z alone in shared memory, the
correlate WIDE_ROWS rows at a time over L packed in row blocks,
``pack_row_blocks``);
more raise. The first design of the route from 9 assets, the generic
instance (the constants and the state in shared memory), is the yardstick
of the two upper routes: ``basket_generic_first``, which no pricer calls.
``launches`` counts each route of each kernel and each yardstick apart.
"""

from __future__ import annotations

import numpy as np
import torch

from options_model_tpu_torch.models.multiasset import basket_chain
from options_model_tpu_torch.ops import _build
from options_model_tpu_torch.ops.cuda_heston import PATH_TILE, _tiles
from options_model_tpu_torch.ops.engine import resolve_device
from options_model_tpu_torch.ops.philox import basket_calls, basket_path_draws

# Kernel launches since the last reset, one integer per kernel and route:
# kernels 27 and 28 at 1-8 assets ("basket_paths", "basket_terminal"), at
# 9-16 and 17-128 (the keys with those suffixes), kernel 28's first design
# and the generic instance (the yardsticks).
launches = {"basket_paths": 0, "basket_paths_9_16": 0, "basket_paths_17_128": 0,
            "basket_terminal": 0, "basket_terminal_9_16": 0, "basket_terminal_17_128": 0,
            "basket_terminal_first": 0, "basket_generic_first": 0}
# The most assets the kernels take (csrc/basket.cuh kMaxAssets); up to
# REGISTER_ASSETS the state lives in registers (kRegisterAssets), the
# first design's register instances ended at FIRST_REGISTER_ASSETS.
MAX_ASSETS = 128
REGISTER_ASSETS = 16
FIRST_REGISTER_ASSETS = 8
# Rows of a block of the wide route's correlate (csrc/basket.cuh kWideRows).
WIDE_ROWS = 8
_MODES = {"terminal": 0, "paths": 1, "debug": 2, "terminal_first": 3,
          "generic_terminal": 4, "generic_paths": 5}


def route(n_assets: int) -> str:
    """The route a launch of kernels 27-28 takes at n_assets: "1_8",
    "9_16" (register instances) or "17_128" (the wide route); ValueError
    outside 1-MAX_ASSETS."""
    if not 1 <= n_assets <= MAX_ASSETS:
        raise ValueError(f"the basket kernels take 1 to {MAX_ASSETS} assets, got {n_assets}")
    if n_assets <= FIRST_REGISTER_ASSETS:
        return "1_8"
    return "9_16" if n_assets <= REGISTER_ASSETS else "17_128"


def terminal_slots(n_assets: int) -> int:
    """Adjacent slots a thread of kernel 28's redesign at n_assets (1-16;
    csrc/basket.cu kTermSlots), where the tile's half (its width without
    antithetics) is a multiple of it; one slot a thread elsewhere."""
    return 4 if n_assets <= 3 else 2 if n_assets <= 8 else 1


def wide_groups(n_assets: int, rows: int = WIDE_ROWS) -> list:
    """The row blocks each thread group of a wide launch owns at n_assets
    (csrc/basket.cuh wide_groups, basket_wide_kernel): of nb = ceil(n /
    rows) blocks, group g owns blocks g and nb - 1 - g (the middle block
    alone where they meet), so ceil(nb / 2) groups take about the same
    products."""
    nb = -(-n_assets // rows)
    return [sorted({g, nb - 1 - g}) for g in range((nb + 1) // 2)]


def pack_row_blocks(L: np.ndarray, rows: int = WIDE_ROWS) -> np.ndarray:
    """L (n, n) lower triangular in the wide route's order, float32: for
    row block rb (rows rb R .. rb R + R - 1, R = ``rows``, the last padded
    with zero rows) and column b < (rb + 1) R, the R coefficients L[rb R +
    r, b] contiguous. The entries past a row's diagonal are zeros that the
    kernel never multiplies (csrc/basket.cuh wide_chunk)."""
    L = np.asarray(L, np.float32)
    n = L.shape[0]
    nb = -(-n // rows)
    Lp = np.zeros((nb * rows, nb * rows), np.float32)
    Lp[:n, :n] = np.tril(L)
    blocks = [Lp[rb * rows:(rb + 1) * rows, :(rb + 1) * rows].T.ravel() for rb in range(nb)]
    return np.concatenate(blocks)


def unpack_row_blocks(packed: np.ndarray, n: int, rows: int = WIDE_ROWS) -> np.ndarray:
    """The inverse of pack_row_blocks: L (n, n) float32, lower triangular."""
    nb = -(-n // rows)
    if len(packed) != rows * rows * nb * (nb + 1) // 2:
        raise ValueError(f"{len(packed)} packed floats for {n} assets in blocks of {rows}, "
                         f"expected {rows * rows * nb * (nb + 1) // 2}")
    L = np.zeros((nb * rows, nb * rows), np.float32)
    at = 0
    for rb in range(nb):
        size = (rb + 1) * rows * rows
        L[rb * rows:(rb + 1) * rows, :(rb + 1) * rows] = (
            np.asarray(packed[at:at + size], np.float32).reshape((rb + 1) * rows, rows).T)
        at += size
    return np.tril(L[:n, :n])


def wide_constants(c: dict, rows: int = WIDE_ROWS) -> np.ndarray:
    """The wide route's constants, float32 (csrc/basket.cuh
    wide_consts4 float4s): (s0, drift, vol, 0) of each row, padded with zero
    rows to whole blocks, then L in row blocks (pack_row_blocks)."""
    n = c["s0"].shape[0]
    nr = -(-n // rows) * rows
    per_row = np.zeros((nr, 4), np.float32)
    per_row[:n, 0], per_row[:n, 1], per_row[:n, 2] = c["s0"], c["drift"], c["vol"]
    return np.concatenate([per_row.ravel(), pack_row_blocks(c["L"], rows)])


def _n_assets(c: dict) -> int:
    n = int(c["s0"].shape[0])
    route(n)
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


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A host float32 array on the card, copied from pinned memory on the
    current stream without holding the host until the card reaches it."""
    return torch.from_numpy(a).pin_memory().to(device, non_blocking=True)


def _counter(mode: str, n: int) -> str:
    """The key of ``launches`` a launch in ``mode`` at n assets adds to."""
    if mode.startswith("generic"):
        return "basket_generic_first"
    if mode == "terminal_first":
        return "basket_terminal_first"
    r = route(n)
    return f"basket_{mode}" + ("" if r == "1_8" else f"_{r}")


def basket_launcher(seed: int, c: dict, n_paths: int, n_steps: int, antithetic: bool,
                    first_tile: int, tile: int, device, mode: str):
    """basket_launch's launch as a callable on buffers made once: (launch,
    out, aux), out and aux as basket_launch fills them. Each call launches
    again on them, without the wrapper's host work (the constants packed
    and copied to the card), and counts nothing: chip_smoke.py's phase 5
    times the kernels so."""
    _build.require_cuda(device)
    n, n_tiles = _geometry(seed, c, n_paths, n_steps, first_tile, tile)
    n_pad = n_tiles * tile
    shape = ((n, n_pad) if mode in ("terminal", "terminal_first", "generic_terminal")
             else (n_steps + 1, n, n_pad))
    out = torch.empty(shape, dtype=torch.float32, device=device)
    aux = (torch.empty((n_steps, n, n_pad), dtype=torch.float32, device=device)
           if mode == "debug" else out)
    # the register instances take the constants by value from the host; the
    # generic instance reads them packed on the card, the wide route in its
    # own order (torch's allocations are 16-byte aligned)
    generic = mode.startswith("generic")
    wide = not generic and n > REGISTER_ASSETS
    packed = None if wide else _packed(c)
    dev = (_upload(packed, device) if generic
           else _upload(wide_constants(c), device) if wide else None)
    host = None if packed is None else _build.float_buffer(packed)

    def launch():
        _build.launch("omt_basket", device, out.data_ptr(), aux.data_ptr(), host,
                      0 if dev is None else dev.data_ptr(), seed, first_tile, n_tiles, tile,
                      n_steps, n, int(antithetic), _MODES[mode])

    return launch, out, aux


def basket_launch(seed: int, c: dict, n_paths: int, n_steps: int, antithetic: bool,
                  first_tile: int, tile: int, device, mode: str):
    """One launch of csrc/basket.cu on a CUDA device in ``mode``: S
    (terminal: kernel 28's redesign; terminal_first: its first design;
    paths: kernel 27; generic_terminal, generic_paths: the generic
    instance) or (log-states, W) (debug). Counts the launches of every mode
    but debug, each route apart (``_counter``)."""
    launch, out, aux = basket_launcher(seed, c, n_paths, n_steps, antithetic, first_tile, tile,
                                       device, mode)
    launch()
    if mode == "debug":
        return out, aux
    launches[_counter(mode, out.shape[-2])] += 1
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
    """Kernel 28's first design (1-FIRST_REGISTER_ASSETS assets) on a CUDA
    device, the plain version on the CPU: the redesign's yardstick, which no
    pricer calls. The arguments are basket_terminal's; more assets raise
    ValueError (their yardstick is basket_generic_first)."""
    n = _n_assets(c)
    if n > FIRST_REGISTER_ASSETS:
        raise ValueError(f"kernel 28's first design takes 1 to {FIRST_REGISTER_ASSETS} "
                         f"assets, got {n}: basket_generic_first is the yardstick above")
    return _terminal("terminal_first", seed, c, n_paths, n_steps, antithetic, first_tile, tile,
                     device)


def basket_generic_first(seed: int, c: dict, n_paths: int, n_steps: int,
                         antithetic: bool = True, first_tile: int = 0, tile: int = PATH_TILE,
                         device=None, paths: bool = False) -> torch.Tensor:
    """The generic instance, the first design of the routes from 9 assets,
    on a CUDA device (S paths with ``paths``, else S_T), the plain version
    on the CPU: the yardstick of both redesigned routes, which no pricer
    calls. The other arguments are basket_paths's; the same bits."""
    device = resolve_device(device)
    if device.type == "cpu":
        return basket_reference(seed, c, n_paths, n_steps, antithetic, first_tile, tile, device,
                                "paths" if paths else "terminal")
    return basket_launch(seed, c, n_paths, n_steps, antithetic, first_tile, tile, device,
                         "generic_paths" if paths else "generic_terminal")


def basket_kernel_attrs(n_assets: int) -> dict:
    """Registers, local bytes and occupancy (blocks an SM, threads a block)
    of the instances a launch at n_assets runs, by kernel name: kernels 27
    and 28 on their route (28's redesign: its antithetic instance at
    terminal_slots(n_assets)), kernel 28's first design (up to
    FIRST_REGISTER_ASSETS assets), and the generic instance's terminal and
    paths modes."""
    modes = (("basket_paths", 1), ("basket_terminal", 0), ("basket_terminal_first", 3),
             ("basket_generic_first_terminal", 4), ("basket_generic_first_paths", 5))
    return {name: _build.kernel_attrs("omt_basket_attrs", n_assets, mode)
            for name, mode in modes
            if mode != 3 or n_assets <= FIRST_REGISTER_ASSETS}
