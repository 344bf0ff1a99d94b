"""Build and load the CUDA kernels in csrc/.

At first use, nvcc compiles each ``csrc/*.cu`` into an object, one process
per source, all started together, and links them into one shared library
with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -c -o <name>.o csrc/<name>.cu                               (each source)
    nvcc -shared -o build/torch_kernels/libomt_<hash>.so <objects>

The file name carries a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads the existing library. The library goes
to ``build/torch_kernels/`` at the root of the checkout (listed in
.gitignore) and is loaded with ctypes. A failed build or load raises; there
is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64
# Every pointer and the stream are c_void_p: a plain int would be cut to 32 bits.
_SIGNATURES = {
    "omt_heston_paths": [_P, _P, _P, _U64, _I, _I, _I, _I, _P],
    "omt_heston_terminal": [_P, _P, _U64, _I, _I, _I, _I, _P],
    "omt_heston_variant": [_P, _P, _U64, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "omt_heston_paths_qe": [_P, _P, _P, _U64, _I, _I, _I, _I, _P],
    "omt_heston_paths_batched": [_P, _P, _P, _U64, _I, _I, _I, _I, _I, _I, _P],
    "omt_heston_terminal_qe": [_P, _P, _U64, _I, _I, _I, _I, _P],
    "omt_localvol_paths": [_P, _P, _P, _U64, _I, _I, _I, _I, _I, _P],
    "omt_localvol_terminal": [_P, _P, _P, _U64, _I, _I, _I, _I, _I, _P],
    "omt_terminal_localvol": [_P, _P, _P, _U64, _I, _I, _I, _I, _I, _P],
    "omt_paths_localvol": [_P, _P, _P, _U64, _I, _I, _I, _I, _I, _P],
    "omt_paths_variant": [_P, _P, _U64, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "omt_terminal_qe": [_P, _P, _U64, _I, _I, _I, _I, _P],
    "omt_terminal_euler": [_P, _P, _U64, _I, _I, _I, _I, _P],
    "omt_terminal_gbm": [_P, _P, _U64, _I, _I, _I, _I, _P],
    "omt_gbm_paths": [_P, _P, _U64, _I, _I, _I, _I, _P],
    "omt_gbm_terminal": [_P, _P, _U64, _I, _I, _I, _I, _P],
    "omt_philox_words": [_P, _U64, _I, _I, _I, _I, _I, _P],
    "omt_sincos_check": [_P, _P],
    "omt_path_normals": [_P, _U64, _I, _I, _I, _I, _I, _P],
    "omt_gbm_paths_vjp": [_P, _P, _P, _U64, _I, _I, _I, _I, _I, _P],
    "omt_gbm_paths_vjp_first": [_P, _P, _P, _U64, _I, _I, _I, _I, _I, _P],
    "omt_gbm_terminal_vjp": [_P, _P, _P, _P, ctypes.c_longlong, _I, _P],
    "omt_euler_paths_vjp": [_P, _P, _P, _P, _P, _U64, _I, _I, _I, _I, _I, _P],
    "omt_euler_paths_vjp_first": [_P, _P, _P, _P, _P, _U64, _I, _I, _I, _I, _I, _P],
    "omt_merton_paths": [_P, _P, _P, _U64, _I, _I, _I, _I, _I, _P],
    "omt_merton_paths_first": [_P, _P, _P, _U64, _I, _I, _I, _I, _P],
    "omt_merton_terminal": [_P, _P, _P, _P, _U64, _I, _I, _I, _I, _P],
    "omt_merton_terminal_first": [_P, _P, _P, _U64, _I, _I, _I, _I, _P],
    "omt_jump_overlay_paths": [_P, _P, _P, _U64, _I, _I, _I, _I, _P],
    "omt_jump_overlay_paths_first": [_P, _P, _P, _U64, _I, _I, _I, _I, _P],
    "omt_jump_overlay_terminal": [_P, _P, _P, _P, _U64, _I, _I, _I, _I, _P],
    "omt_jump_overlay_terminal_first": [_P, _P, _P, _U64, _I, _I, _I, _P],
    "omt_dual_ce": [_P] * 7 + [_U64] + [_I] * 8 + [_P],
    "omt_dual_ce_first": [_P] * 7 + [_U64] + [_I] * 8 + [_P],
    "omt_dual_ce_debug": [_P] * 10 + [_U64] + [_I] * 8 + [_P],
    "omt_dual_inner_states": [_P] * 8 + [_U64] + [_I] * 7 + [_P],
    "omt_dual_vg_terminal": [_P, _P, _P, _U64, _I, _I, _I, _I, _I, _P],
    "omt_dual_vg_terminal_first": [_P, _P, _P, _U64, _I, _I, _I, _I, _I, _P],
    "omt_dual_vg_terminal_debug": [_P] * 6 + [_U64] + [_I] * 5 + [_P],
    "omt_vg_paths": [_P, _P, _P, _P, _U64, _I, _I, _I, _I, _I, _P],
    "omt_vg_paths_first": [_P, _P, _P, _P, _U64, _I, _I, _I, _I, _I, _P],
    "omt_vg_terminal": [_P, _P, _P, _P, _U64, _I, _I, _I, _P],
    "omt_vg_terminal_first": [_P, _P, _P, _P, _U64, _I, _I, _I, _P],
    "omt_vg_decide": [_P, _P, _P, _P, _P, ctypes.c_longlong, _P],
    "omt_sabr_paths": [_P, _P, _P, _U64, _I, _I, _I, _I, _P],
    "omt_sabr_terminal": [_P, _P, _P, _P, _U64, _I, _I, _I, _I, _P],
    "omt_sabr_terminal_first": [_P, _P, _P, _P, _U64, _I, _I, _I, _I, _P],
    "omt_rbergomi_dw": [_P, ctypes.c_float, _U64, _I, _I, _I, _I, _P],
    "omt_rbergomi_paths": [_P, _P, _P, _P, _P, _P, _P, _U64, _I, _I, _I, _I, _I, _P],
    "omt_rbergomi_fused": [_P, _P, _P, _P, _P, _P, _U64, _I, _I, _I, _I, _I, _P],
    "omt_basket": [_P, _P, _P, _P, _U64, _I, _I, _I, _I, _I, _I, _I, _P],
}

# Registers, spills and occupancy of a built kernel (csrc/kernel_attrs.cuh).
_ATTRS = {
    "omt_heston_paths_attrs": [_P],
    "omt_heston_paths_qe_attrs": [_P],
    "omt_heston_paths_batched_attrs": [_I, _P],
    "omt_terminal_attrs": [_I, _P],
    "omt_paths_localvol_attrs": [_I, _P],
    "omt_greeks_attrs": [_I, _P],
    "omt_jumps_attrs": [_I, _P],
    "omt_dual_attrs": [_I, _P],
    "omt_vg_attrs": [_I, _P],
    "omt_sabr_attrs": [_I, _P],
    "omt_rbergomi_attrs": [_I, _I, _P],
    "omt_basket_attrs": [_I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "on PATH (or under /usr/local/cuda)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libomt_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> None:
    """Run the commands concurrently; raise, with their output, if any failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)) for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    obj_dir = out.with_name(f"{out.stem}.{os.getpid()}.obj")
    obj_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [obj_dir / f"{src.stem}.o" for src in _sources()[0]]
    _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(_sources()[0], objs)])
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    os.replace(tmp, out)
    shutil.rmtree(obj_dir)
    return out


def load_library() -> ctypes.CDLL:
    """The kernel library, built at first use; raises when it cannot be."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name, argtypes in _ATTRS.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.omt_error_string.argtypes = [ctypes.c_int]
        lib.omt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_launch(seed: int, first_tile: int, n_tiles: int, n_steps: int) -> None:
    """The kernels take a 64-bit seed and 32-bit tile and step counts: raise
    on values the C interface would silently wrap."""
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must be in [0, 2^64), got {seed}")
    if n_tiles <= 0 or n_steps <= 0:
        raise ValueError(f"need at least one tile and one step, got {n_tiles}, {n_steps}")
    if first_tile < 0 or first_tile + n_tiles >= 1 << 31:
        raise ValueError(f"first_tile {first_tile} + {n_tiles} tiles leaves int32")


def require_cuda(device: torch.device) -> None:
    """The kernels run on a CUDA device only: raise for any other device, or
    when torch has no CUDA. Wrappers call this before they allocate."""
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels run on a CUDA device, got {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available to torch")


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry ``name`` on the current stream of ``device``; raise on the
    launch's cudaGetLastError(). The caller has checked the device
    (require_cuda) before allocating the kernel's buffers."""
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.omt_error_string(err).decode()} ({err})")


def kernel_attrs(name: str, *args) -> dict:
    """Registers per thread, spill bytes, resident blocks per SM and block
    threads of a built kernel, from its C entry ``name`` (one of _ATTRS)."""
    lib = load_library()
    out = (ctypes.c_int * 4)()
    err = getattr(lib, name)(*args, out)
    if err != 0:
        raise RuntimeError(f"{name} failed: {lib.omt_error_string(err).decode()} ({err})")
    regs, spill, blocks, threads = out
    return dict(registers=regs, spill_bytes=spill, blocks_per_sm=blocks, block=threads)


def float_args(values) -> ctypes.Array:
    """A host float32 array for a kernel's constants (kept alive by the caller
    for the duration of the call)."""
    return (ctypes.c_float * len(values))(*map(float, values))


def float_buffer(a: np.ndarray) -> ctypes.Array:
    """float_args of a float32 NumPy array without a copy (the ctypes array
    keeps ``a`` alive): a long table of constants costs the host no loop."""
    a = np.ascontiguousarray(a, np.float32)
    return (ctypes.c_float * a.size).from_buffer(a)
