"""Local-vol path kernels and their plain PyTorch versions:
- csrc/terminal.cu: the terminal kernel redesigned for Hopper (static
  degree, one padded row load per step for both mirrors), the route of
  every pricer;
- csrc/localvol_paths.cu: the paths kernel redesigned on the terminal
  kernel's step (hopper_fast.cuh's lv_step) with a streamed row store, the
  route of every pricer;
- csrc/localvol.cu: the first design of both kernels, kept only as the
  redesigns' yardstick under ``localvol_terminal_accurate`` and
  ``localvol_paths_accurate``; no pricer reaches it.

Counterparts of localvol_terminal_pallas and localvol_paths_pallas
(options_model_tpu/ops/pallas_localvol.py:62, :149), flat layout only. The
wrappers take the plain version for a CPU device and launch the kernel for
a CUDA device; there is no fallback between the two.
"""

from __future__ import annotations

import torch

from options_model_tpu_torch.models.localvol import (check_table, localvol_constants,
                                                     localvol_euler_from_normals)
from options_model_tpu_torch.ops import _build
from options_model_tpu_torch.ops.cuda_heston import PATH_TILE, TERMINAL_TILE, _tiles
from options_model_tpu_torch.ops.engine import resolve_device
from options_model_tpu_torch.ops.philox import path_normals
from options_model_tpu_torch.surface.cheb import LocalVolTable

# Kernel launches since the last reset, one integer per kernel.
launches = {"localvol_terminal": 0, "localvol_paths": 0,
            "localvol_terminal_accurate": 0, "localvol_paths_accurate": 0}
# (paths, first design) -> C entry, tile, launch key
_ROUTES = {(False, False): ("omt_terminal_localvol", TERMINAL_TILE, "localvol_terminal"),
           (False, True): ("omt_localvol_terminal", TERMINAL_TILE, "localvol_terminal_accurate"),
           (True, False): ("omt_paths_localvol", PATH_TILE, "localvol_paths"),
           (True, True): ("omt_localvol_paths", PATH_TILE, "localvol_paths_accurate")}


def localvol_terminal_reference(seed: int, S0, r, T, table: LocalVolTable,
                                n_paths: int, n_steps: int, antithetic: bool = True,
                                first_tile: int = 0, device=None) -> torch.Tensor:
    """Plain version of the terminal kernel: S_T (n_pad,), n_pad = n_paths
    rounded up to TERMINAL_TILE."""
    n_tiles = _tiles(n_paths, TERMINAL_TILE, seed, first_tile, n_steps)
    z = path_normals(seed, first_tile, n_tiles, TERMINAL_TILE, n_steps, antithetic,
                     device)
    return localvol_euler_from_normals(z, S0, r, T, table, return_paths=False)


def localvol_paths_reference(seed: int, S0, r, T, table: LocalVolTable,
                             n_paths: int, n_steps: int, antithetic: bool = True,
                             first_tile: int = 0, device=None) -> torch.Tensor:
    """Plain version of the paths kernel: S (n_steps+1, n_pad), n_pad =
    n_paths rounded up to PATH_TILE."""
    n_tiles = _tiles(n_paths, PATH_TILE, seed, first_tile, n_steps)
    z = path_normals(seed, first_tile, n_tiles, PATH_TILE, n_steps, antithetic, device)
    return localvol_euler_from_normals(z, S0, r, T, table)


def padded_coeffs(table: LocalVolTable, n_steps: int) -> torch.Tensor:
    """Rows 0..n_steps-1 of the table as float32 (n_steps, 4 (degree // 4 +
    1)), each row zero-padded to whole float4 groups: the layout of
    csrc/terminal.cu and csrc/localvol_paths.cu, which read a row as float4
    loads. The zero columns leave Clenshaw's result bit for bit as it was."""
    check_table(table, n_steps)
    rows = table.coeffs[:n_steps].to(torch.float32)
    width = 4 * (table.degree // 4 + 1)
    return torch.nn.functional.pad(rows, (0, width - rows.shape[1])).contiguous()


def _rows_on(rows: torch.Tensor, device) -> torch.Tensor:
    """``rows`` on ``device``; a host tensor goes through pinned memory, so
    the copy does not wait for the work already queued on the stream (a
    pageable copy would, holding the host until the last kernel ends)."""
    if rows.device.type != "cpu":
        return rows.to(device)
    return rows.pin_memory().to(device, non_blocking=True)


def _launch(name, out, coeffs, S0, r, T, table, seed, first_tile, n_tiles, n_steps,
            antithetic, device, width) -> None:
    """Launch C entry ``name`` over ``coeffs`` (kept alive by the caller
    until the stream has run the kernel: the caching allocator orders reuse
    by stream); ``width`` is its last argument before antithetic (the
    coefficient count, or the degree)."""
    c = localvol_constants(S0, r, T, table, n_steps)
    consts = _build.float_args([c[k] for k in ("log_s0", "r", "dt", "sqrt_dt", "log_k",
                                               "m_center", "inv_m_half")])
    _build.launch(name, device, out.data_ptr(), coeffs.data_ptr(), consts, seed,
                  first_tile, n_tiles, n_steps, width, int(antithetic))


def _simulate(paths: bool, accurate: bool, seed, S0, r, T, table, n_paths, n_steps,
              antithetic, first_tile, device):
    """S (n_steps+1, n_pad) (``paths``) or S_T (n_pad,) from the redesign
    (padded rows, the degree) or the first design (csrc/localvol.cu: the
    rows as they are, the coefficient count), or from the plain version for
    a CPU device."""
    device = resolve_device(device)
    if device.type == "cpu":
        plain = localvol_paths_reference if paths else localvol_terminal_reference
        return plain(seed, S0, r, T, table, n_paths, n_steps, antithetic, first_tile, device)
    _build.require_cuda(device)
    check_table(table, n_steps)
    name, tile, key = _ROUTES[paths, accurate]
    n_tiles = _tiles(n_paths, tile, seed, first_tile, n_steps)
    shape = (n_steps + 1, n_tiles * tile) if paths else (n_tiles * tile,)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if accurate:
        coeffs = _rows_on(table.coeffs[:n_steps].to(torch.float32).contiguous(), device)
        width = coeffs.shape[1]
    else:
        coeffs = _rows_on(padded_coeffs(table, n_steps), device)
        width = table.degree
    _launch(name, out, coeffs, S0, r, T, table, seed, first_tile, n_tiles, n_steps,
            antithetic, device, width)
    launches[key] += 1
    return out


def localvol_terminal(seed: int, S0, r, T, table: LocalVolTable, n_paths: int,
                      n_steps: int, antithetic: bool = True, first_tile: int = 0,
                      device=None) -> torch.Tensor:
    """Terminal prices S_T (n_pad,) from csrc/terminal.cu, or from the plain
    version for a CPU device."""
    return _simulate(False, False, seed, S0, r, T, table, n_paths, n_steps, antithetic,
                     first_tile, device)


def localvol_terminal_accurate(seed: int, S0, r, T, table: LocalVolTable, n_paths: int,
                               n_steps: int, antithetic: bool = True, first_tile: int = 0,
                               device=None) -> torch.Tensor:
    """Terminal prices S_T (n_pad,) from the first design of the terminal
    kernel (csrc/localvol.cu: run-time Clenshaw, accurate Box-Muller), or
    from the plain version for a CPU device. No pricer reaches it: it is the
    redesign's yardstick."""
    return _simulate(False, True, seed, S0, r, T, table, n_paths, n_steps, antithetic,
                     first_tile, device)


def localvol_paths(seed: int, S0, r, T, table: LocalVolTable, n_paths: int,
                   n_steps: int, antithetic: bool = True, first_tile: int = 0,
                   device=None) -> torch.Tensor:
    """Path matrix S (n_steps+1, n_pad) from csrc/localvol_paths.cu, or from
    the plain version for a CPU device."""
    return _simulate(True, False, seed, S0, r, T, table, n_paths, n_steps, antithetic,
                     first_tile, device)


def localvol_paths_accurate(seed: int, S0, r, T, table: LocalVolTable, n_paths: int,
                            n_steps: int, antithetic: bool = True, first_tile: int = 0,
                            device=None) -> torch.Tensor:
    """Path matrix S (n_steps+1, n_pad) from the first design of the paths
    kernel (csrc/localvol.cu: run-time Clenshaw, accurate Box-Muller and
    expf, the absolute log S), or from the plain version for a CPU device.
    No pricer reaches it: it is the redesign's yardstick."""
    return _simulate(True, True, seed, S0, r, T, table, n_paths, n_steps, antithetic,
                     first_tile, device)


def paths_kernel_attrs() -> dict:
    """Registers, spills and occupancy of the redesigned paths kernel as
    built (the antithetic instance) at degree 7 and at a run-time degree."""
    return {name: _build.kernel_attrs("omt_paths_localvol_attrs", i) for i, name in
            enumerate(("localvol_paths", "localvol_paths (run-time degree)"))}
