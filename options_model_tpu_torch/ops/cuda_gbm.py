"""GBM log-Euler path kernels and their plain PyTorch versions:
- csrc/terminal.cu: the terminal kernel redesigned for Hopper, the route of
  every pricer;
- csrc/gbm.cu: the paths kernel, the route of every pricer, and the first
  design of the terminal kernel (accurate math, the key schedule at every
  Philox call), kept only as the redesign's yardstick under
  ``gbm_terminal_accurate``; no pricer reaches it.

Counterparts of gbm_terminal_pallas and gbm_paths_pallas
(options_model_tpu/ops/pallas_gbm.py:100, :126), flat layout only. The
wrappers take the plain version for a CPU device and launch the kernel for
a CUDA device; there is no fallback between the two.

The reference's Greeks differentiate its XLA simulator (models/gbm.py:35)
with jax.grad. Here ``gbm_paths_ad`` and ``gbm_terminal_ad`` run the same
kernels in the autograd graph, and their backward is a VJP kernel of
csrc/greeks.cu (``gbm_paths_vjp``, ``gbm_terminal_vjp``), or its plain
version on the Philox stream for a CPU tensor. Each reduces the
cotangent to A = sum g S, B = sum g S t and C = sum g S W
(models/gbm.gbm_chain), one row of float64 partial sums a block, summed
here in a fixed order: the same seed gives the same gradient bit for bit.
The paths VJP is a Hopper redesign (gbm_vjp_kernel: a thread a path, 16
blocks a tile, ``gbm_vjp_blocks``); its first design stays under
``gbm_paths_vjp_first`` as the yardstick, on a CUDA device only, and no
pricer reaches it.
"""

from __future__ import annotations

import torch

from options_model_tpu_torch.models.gbm import (gbm_chain, gbm_constants,
                                                gbm_euler_from_normals,
                                                gbm_euler_vjp_from_normals)
from options_model_tpu_torch.ops import _build
from options_model_tpu_torch.ops.autodiff import VJP_BLOCK, cotangent, differentiable
from options_model_tpu_torch.ops.cuda_heston import (PATH_TILE, TERMINAL_TILE, _tiles,
                                                    launch_terminal)
from options_model_tpu_torch.ops.engine import resolve_device
from options_model_tpu_torch.ops.philox import path_normals

# Kernel launches since the last reset, one integer per kernel.
launches = {"gbm_terminal": 0, "gbm_paths": 0, "gbm_terminal_accurate": 0,
            "gbm_terminal_vjp": 0, "gbm_paths_vjp": 0, "gbm_paths_vjp_first": 0}
# The most blocks of the terminal VJP's grid-stride loop (csrc/greeks.cu
# kTerminalBlocks).
TERMINAL_VJP_BLOCKS = 1024


def gbm_terminal_reference(seed: int, S0, r, sigma, T, n_paths: int, n_steps: int,
                           antithetic: bool = True, first_tile: int = 0,
                           device=None) -> torch.Tensor:
    """Plain version of the terminal kernel: S_T (n_pad,), n_pad = n_paths
    rounded up to TERMINAL_TILE."""
    n_tiles = _tiles(n_paths, TERMINAL_TILE, seed, first_tile, n_steps)
    z = path_normals(seed, first_tile, n_tiles, TERMINAL_TILE, n_steps,
                     antithetic, device)
    return gbm_euler_from_normals(z, S0, r, sigma, T, return_paths=False)


def gbm_paths_reference(seed: int, S0, r, sigma, T, n_paths: int, n_steps: int,
                        antithetic: bool = True, first_tile: int = 0,
                        device=None) -> torch.Tensor:
    """Plain version of the paths kernel: S (n_steps+1, n_pad), n_pad =
    n_paths rounded up to PATH_TILE."""
    n_tiles = _tiles(n_paths, PATH_TILE, seed, first_tile, n_steps)
    z = path_normals(seed, first_tile, n_tiles, PATH_TILE, n_steps, antithetic, device)
    return gbm_euler_from_normals(z, S0, r, sigma, T)


def _consts(S0, r, sigma, T, n_steps):
    c = gbm_constants(S0, r, sigma, T, n_steps)
    return _build.float_args([c[k] for k in ("s0", "drift", "diffusion", "drift_n")])


def _terminal(name, key, seed, S0, r, sigma, T, n_paths, n_steps, antithetic, first_tile,
              device) -> torch.Tensor:
    device = resolve_device(device)
    if device.type == "cpu":
        return gbm_terminal_reference(seed, S0, r, sigma, T, n_paths, n_steps, antithetic,
                                      first_tile, device)
    return launch_terminal(name, (launches, key), _consts(S0, r, sigma, T, n_steps), seed,
                           n_paths, n_steps, antithetic, first_tile, device)


def gbm_terminal(seed: int, S0, r, sigma, T, n_paths: int, n_steps: int,
                 antithetic: bool = True, first_tile: int = 0,
                 device=None) -> torch.Tensor:
    """Terminal prices S_T (n_pad,) from csrc/terminal.cu, or from the plain
    version for a CPU device."""
    return _terminal("omt_terminal_gbm", "gbm_terminal", seed, S0, r, sigma, T, n_paths,
                     n_steps, antithetic, first_tile, device)


def gbm_terminal_accurate(seed: int, S0, r, sigma, T, n_paths: int, n_steps: int,
                          antithetic: bool = True, first_tile: int = 0,
                          device=None) -> torch.Tensor:
    """Terminal prices S_T (n_pad,) from the first design of the terminal
    kernel (csrc/gbm.cu: accurate logf/sinf/cosf/sqrtf/expf, the key
    schedule at every Philox call), or from the plain version for a CPU
    device. No pricer reaches it: it is the redesign's yardstick."""
    return _terminal("omt_gbm_terminal", "gbm_terminal_accurate", seed, S0, r, sigma, T,
                     n_paths, n_steps, antithetic, first_tile, device)


def gbm_paths(seed: int, S0, r, sigma, T, n_paths: int, n_steps: int,
              antithetic: bool = True, first_tile: int = 0,
              device=None) -> torch.Tensor:
    """Path matrix S (n_steps+1, n_pad) from csrc/gbm.cu, or from the plain
    version for a CPU device."""
    device = resolve_device(device)
    if device.type == "cpu":
        return gbm_paths_reference(seed, S0, r, sigma, T, n_paths, n_steps,
                                   antithetic, first_tile, device)
    _build.require_cuda(device)
    n_tiles = _tiles(n_paths, PATH_TILE, seed, first_tile, n_steps)
    S = torch.empty((n_steps + 1, n_tiles * PATH_TILE), dtype=torch.float32,
                    device=device)
    _build.launch("omt_gbm_paths", device, S.data_ptr(),
                  _consts(S0, r, sigma, T, n_steps), seed, first_tile, n_tiles,
                  n_steps, int(antithetic))
    launches["gbm_paths"] += 1
    return S


def gbm_paths_vjp_reference(g: torch.Tensor, seed: int, S0, r, sigma, T, n_paths: int,
                            n_steps: int, antithetic: bool = True,
                            first_tile: int = 0) -> torch.Tensor:
    """Plain version of the paths VJP kernel: <g, dS/d(S0, r, sigma, T)>,
    float64 (4,), on the normals gbm_paths_reference draws."""
    n_tiles = _tiles(n_paths, PATH_TILE, seed, first_tile, n_steps)
    z = path_normals(seed, first_tile, n_tiles, PATH_TILE, n_steps, antithetic, g.device)
    return gbm_euler_vjp_from_normals(z, g, S0, r, sigma, T)


def gbm_terminal_vjp_reference(g: torch.Tensor, seed: int, S0, r, sigma, T, n_paths: int,
                               n_steps: int, antithetic: bool = True,
                               first_tile: int = 0) -> torch.Tensor:
    """Plain version of the terminal VJP kernel: <g, dS_T/d(S0, r, sigma,
    T)>, float64 (4,), on the normals gbm_terminal_reference draws (W is
    their sum, where the kernel recovers it from S_T)."""
    n_tiles = _tiles(n_paths, TERMINAL_TILE, seed, first_tile, n_steps)
    z = path_normals(seed, first_tile, n_tiles, TERMINAL_TILE, n_steps, antithetic,
                     g.device)
    return gbm_euler_vjp_from_normals(z, g, S0, r, sigma, T, return_paths=False)


def gbm_vjp_blocks(n_tiles: int) -> int:
    """Blocks (rows of sums) of the redesigned paths VJP kernel: VJP_BLOCK
    paths a block, so PATH_TILE / VJP_BLOCK = 16 a tile with or without
    antithetics, none straddling a tile. Raises for what the kernel refuses
    (no tile, or a grid beyond 2^31 - 1 blocks)."""
    n_blocks = n_tiles * (PATH_TILE // VJP_BLOCK)
    if n_tiles < 1 or n_blocks >= 1 << 31:
        raise ValueError(f"the GBM paths VJP kernel takes 1 to 2^27 - 1 tiles, got {n_tiles}")
    return n_blocks


def _paths_vjp_launch(name: str, blocks, g: torch.Tensor, seed: int, S0, r, sigma, T,
                      n_paths: int, n_steps: int, antithetic: bool,
                      first_tile: int) -> torch.Tensor:
    """One launch of C entry omt_``name`` on a CUDA cotangent g (n_steps+1,
    n_pad) over blocks(n_tiles) blocks: its (n_blocks, 3) float64 rows of
    block sums (A, B, C)."""
    _build.require_cuda(g.device)
    n_tiles = _tiles(n_paths, PATH_TILE, seed, first_tile, n_steps)
    g = cotangent(g, (n_steps + 1, n_tiles * PATH_TILE))
    rows = torch.empty((blocks(n_tiles), 3), dtype=torch.float64, device=g.device)
    _build.launch(f"omt_{name}", g.device, rows.data_ptr(), g.data_ptr(),
                  _consts(S0, r, sigma, T, n_steps), seed, first_tile, n_tiles, n_steps,
                  int(antithetic), rows.shape[0])
    launches[name] += 1
    return rows


def gbm_paths_vjp_rows(g: torch.Tensor, seed: int, S0, r, sigma, T, n_paths: int,
                       n_steps: int, antithetic: bool = True,
                       first_tile: int = 0) -> torch.Tensor:
    """One launch of csrc/greeks.cu's gbm_vjp_kernel on a CUDA cotangent g
    (n_steps+1, n_pad): its (gbm_vjp_blocks, 3) float64 rows of block sums
    (A, B, C). It redraws the forward's normals bit for bit and reads g
    only."""
    return _paths_vjp_launch("gbm_paths_vjp", gbm_vjp_blocks, g, seed, S0, r, sigma, T,
                             n_paths, n_steps, antithetic, first_tile)


def gbm_paths_vjp_rows_first(g: torch.Tensor, seed: int, S0, r, sigma, T, n_paths: int,
                             n_steps: int, antithetic: bool = True,
                             first_tile: int = 0) -> torch.Tensor:
    """gbm_paths_vjp_rows through the first design (gbm_paths_vjp_kernel, a
    thread a pair or a path, ceil(slots / VJP_BLOCK) rows), the redesign's
    yardstick, on a CUDA cotangent only."""
    width = PATH_TILE // 2 if antithetic else PATH_TILE
    return _paths_vjp_launch("gbm_paths_vjp_first", lambda n: -(-n * width // VJP_BLOCK), g,
                             seed, S0, r, sigma, T, n_paths, n_steps, antithetic, first_tile)


def gbm_paths_vjp(g: torch.Tensor, seed: int, S0, r, sigma, T, n_paths: int, n_steps: int,
                  antithetic: bool = True, first_tile: int = 0) -> torch.Tensor:
    """<g, dS/d(S0, r, sigma, T)> of gbm_paths for a cotangent g (n_steps+1,
    n_pad), float64 (4,): the kernel's rows summed in a fixed order for a
    CUDA g, the plain version for a CPU g."""
    if g.device.type == "cpu":
        return gbm_paths_vjp_reference(g, seed, S0, r, sigma, T, n_paths, n_steps,
                                       antithetic, first_tile)
    rows = gbm_paths_vjp_rows(g, seed, S0, r, sigma, T, n_paths, n_steps, antithetic,
                              first_tile)
    return gbm_chain(rows.sum(0), S0, r, sigma, T, n_steps)


def gbm_paths_vjp_first(g: torch.Tensor, seed: int, S0, r, sigma, T, n_paths: int,
                        n_steps: int, antithetic: bool = True,
                        first_tile: int = 0) -> torch.Tensor:
    """gbm_paths_vjp through the first design, on a CUDA cotangent only."""
    rows = gbm_paths_vjp_rows_first(g, seed, S0, r, sigma, T, n_paths, n_steps, antithetic,
                                    first_tile)
    return gbm_chain(rows.sum(0), S0, r, sigma, T, n_steps)


def gbm_terminal_vjp_rows(g: torch.Tensor, S_T: torch.Tensor, seed: int, S0, r, sigma, T,
                          n_paths: int, n_steps: int, first_tile: int = 0) -> torch.Tensor:
    """One launch of csrc/greeks.cu's gbm_terminal_vjp_kernel on a CUDA
    cotangent g (n_pad,) and the saved S_T: its (n_blocks, 2) float64 rows
    of block sums (A, C). It recovers each path's W from S_T, which needs
    sigma > 0."""
    _build.require_cuda(g.device)
    if not float(sigma) > 0.0:
        raise ValueError(f"gbm_terminal_vjp recovers W from S_T and needs sigma > 0, "
                         f"got {sigma}")
    n = _tiles(n_paths, TERMINAL_TILE, seed, first_tile, n_steps) * TERMINAL_TILE
    g, S_T = cotangent(g, (n,)), cotangent(S_T, (n,))
    rows = torch.empty((min(-(-n // VJP_BLOCK), TERMINAL_VJP_BLOCKS), 2), dtype=torch.float64,
                       device=g.device)
    _build.launch("omt_gbm_terminal_vjp", g.device, rows.data_ptr(), S_T.data_ptr(),
                  g.data_ptr(), _consts(S0, r, sigma, T, n_steps), n, rows.shape[0])
    launches["gbm_terminal_vjp"] += 1
    return rows


def gbm_terminal_vjp(g: torch.Tensor, S_T: torch.Tensor, seed: int, S0, r, sigma, T,
                     n_paths: int, n_steps: int, antithetic: bool = True,
                     first_tile: int = 0) -> torch.Tensor:
    """<g, dS_T/d(S0, r, sigma, T)> of gbm_terminal for a cotangent g
    (n_pad,), float64 (4,): the kernel's rows on the saved S_T for a CUDA
    g, the plain version (which redraws) for a CPU g."""
    if g.device.type == "cpu":
        return gbm_terminal_vjp_reference(g, seed, S0, r, sigma, T, n_paths, n_steps,
                                          antithetic, first_tile)
    A, C = gbm_terminal_vjp_rows(g, S_T, seed, S0, r, sigma, T, n_paths, n_steps,
                                 first_tile).sum(0).unbind()
    return gbm_chain(torch.stack([A, n_steps * A, C]), S0, r, sigma, T, n_steps)


def gbm_paths_ad(seed: int, S0, r, sigma, T, n_paths: int, n_steps: int,
                 antithetic: bool = True, first_tile: int = 0, device=None) -> torch.Tensor:
    """gbm_paths in the autograd graph of (S0, r, sigma, T), any of them a
    0-d tensor: the forward is the same launch with the same bits, the
    backward gbm_paths_vjp."""
    return differentiable(
        lambda *p: gbm_paths(seed, *p, n_paths, n_steps, antithetic, first_tile, device),
        lambda grads, outs, *p: gbm_paths_vjp(grads[0], seed, *p, n_paths, n_steps,
                                              antithetic, first_tile),
        S0, r, sigma, T)


def gbm_terminal_ad(seed: int, S0, r, sigma, T, n_paths: int, n_steps: int,
                    antithetic: bool = True, first_tile: int = 0,
                    device=None) -> torch.Tensor:
    """gbm_terminal in the autograd graph of (S0, r, sigma, T): the same
    launch, and gbm_terminal_vjp as its backward."""
    return differentiable(
        lambda *p: gbm_terminal(seed, *p, n_paths, n_steps, antithetic, first_tile, device),
        lambda grads, outs, *p: gbm_terminal_vjp(grads[0], outs[0], seed, *p, n_paths,
                                                 n_steps, antithetic, first_tile),
        S0, r, sigma, T)
