"""The redesigned terminal kernels' host side (csrc/terminal.cu: local vol,
kernel 7, Heston QE-M, kernel 5, Heston Euler, kernel 3, and GBM, kernel 1)
held against the JAX package and the port's plain versions on the CPU.

- The padded table the local-vol kernel reads: every row zero-padded to
  whole float4 groups, rows bit-equal, and Clenshaw over it (the plain
  versions eval_table and localvol_euler_from_normals) bit-equal to the
  unpadded table, since zero coefficients keep b1 = b2 = 0 exactly.
- Every degree the kernel has an instance for (a compile-time one up to
  its maximum, 12, and the run-time one past it): the plain version on zero
  normals against localvol_terminal_pallas in interpret mode, rtol 1e-6.
- On a CPU tensor the redesigned wrappers and the first designs'
  (``*_accurate``) are their plain versions and launch nothing; without
  CUDA each raises for device="cuda" and for no device.
- The local-vol kernels' log-S update in a float32 emulation: no bias in
  S_T, nor in any stored row of the paths kernel, where adding r dt on its
  own to the absolute log S has one.
- The Euler kernel's log-S update in a float32 emulation at the main
  path's Heston parameters: no bias in S_T against float64 on the same
  normals, where the paths kernel's form (x + r dt rounded first) has one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from options_model_tpu.ops.pallas_localvol import localvol_terminal_pallas
from options_model_tpu.surface import cheb as jcheb
from options_model_tpu_torch.core.config import HestonParams
from options_model_tpu_torch.models.localvol import localvol_euler_from_normals
from options_model_tpu_torch.ops import cuda_gbm, cuda_heston, cuda_localvol
from options_model_tpu_torch.surface.cheb import (LocalVolTable, compile_localvol_table,
                                                  eval_table)

S0, R, T = 100.0, 0.05, 0.5
N_STEPS = 16
DEGREES = (1, 3, 7, 12, 17)
HESTON = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)


def _smile_jax(S, tau):
    m = jnp.log(jnp.asarray(S) / 100.0)
    iv = 0.2 + 0.1 * jnp.abs(m) + 0.05 * m**2 + 0.02 * jnp.sqrt(tau)
    return jnp.clip(iv, 0.05, 1.0)


def _smile_torch(S, tau):
    m = torch.log(S / 100.0)
    iv = 0.2 + 0.1 * torch.abs(m) + 0.05 * m * m + 0.02 * torch.sqrt(tau)
    return torch.clamp(iv, 0.05, 1.0)


def _table(degree: int) -> LocalVolTable:
    return compile_localvol_table(_smile_torch, 100.0, T, N_STEPS, S0, degree=degree)


def _padded(table: LocalVolTable) -> LocalVolTable:
    return LocalVolTable(coeffs=cuda_localvol.padded_coeffs(table, N_STEPS),
                         m_center=table.m_center, m_half=table.m_half, K=table.K)


@pytest.mark.parametrize("degree", (0,) + DEGREES)
def test_padded_table_has_zero_columns_and_equal_rows(degree):
    table = _table(degree)
    P = cuda_localvol.padded_coeffs(table, N_STEPS)
    width = 4 * (degree // 4 + 1)
    assert P.shape == (N_STEPS, width) and P.dtype == torch.float32 and P.is_contiguous()
    assert width % 4 == 0 and degree + 1 <= width < degree + 5
    assert torch.equal(P[:, :degree + 1], table.coeffs)
    assert not bool(P[:, degree + 1:].any())


def test_padded_table_keeps_only_the_steps_asked_for():
    table = _table(7)
    assert torch.equal(cuda_localvol.padded_coeffs(table, 5), cuda_localvol.padded_coeffs(
        table, N_STEPS)[:5])
    with pytest.raises(ValueError, match="step slices"):
        cuda_localvol.padded_coeffs(table, N_STEPS + 1)


@pytest.mark.parametrize("degree", DEGREES)
def test_clenshaw_over_the_padded_table_is_bit_equal(degree):
    table = _table(degree)
    padded = _padded(table)
    assert padded.degree > degree or degree % 4 == 3
    rng = np.random.default_rng(degree)
    S = torch.from_numpy(rng.uniform(40.0, 250.0, 4096).astype(np.float32))
    for t in (0, N_STEPS // 2, N_STEPS - 1):
        assert torch.equal(eval_table(padded, S, t), eval_table(table, S, t))
    z = torch.from_numpy(rng.standard_normal((N_STEPS, 4096)).astype(np.float32))
    assert torch.equal(localvol_euler_from_normals(z, S0, R, T, padded),
                       localvol_euler_from_normals(z, S0, R, T, table))


@pytest.mark.parametrize("degree", DEGREES)
def test_localvol_terminal_zero_normals_match_interpret_kernel_at_degree(degree):
    jt = jcheb.compile_localvol_table(_smile_jax, 100.0, T, N_STEPS, S0, degree=degree)
    t = LocalVolTable.from_reference(vars(jt))
    assert t.degree == degree
    ST_j = localvol_terminal_pallas(1, S0, R, T, jt, 16384, N_STEPS, interpret=True)
    ST = localvol_euler_from_normals(torch.zeros((N_STEPS, 16384)), S0, R, T, t,
                                     return_paths=False)
    np.testing.assert_allclose(ST.numpy(), np.asarray(ST_j), rtol=1e-6)


def _localvol(fn, **kw):
    return fn(21, S0, R, T, _table(7), 5000, N_STEPS, True, 1, **kw)


def _heston(fn, **kw):
    return fn(21, S0, R, T, HESTON, 5000, N_STEPS, True, 1, **kw)


def _gbm(fn, **kw):
    return fn(21, S0, R, 0.2, T, 5000, N_STEPS + 1, True, 1, **kw)


def _counts() -> dict:
    return dict(cuda_localvol.launches, **cuda_heston.launches, **cuda_gbm.launches)


WRAPPERS = {
    "localvol_terminal": lambda **kw: _localvol(cuda_localvol.localvol_terminal, **kw),
    "localvol_terminal_accurate":
        lambda **kw: _localvol(cuda_localvol.localvol_terminal_accurate, **kw),
    "heston_terminal_qe": lambda **kw: _heston(cuda_heston.heston_terminal_qe, **kw),
    "heston_terminal_qe_accurate":
        lambda **kw: _heston(cuda_heston.heston_terminal_qe_accurate, **kw),
    "heston_terminal": lambda **kw: _heston(cuda_heston.heston_terminal, **kw),
    "heston_terminal_accurate":
        lambda **kw: _heston(cuda_heston.heston_terminal_accurate, **kw),
    "gbm_terminal": lambda **kw: _gbm(cuda_gbm.gbm_terminal, **kw),
    "gbm_terminal_accurate": lambda **kw: _gbm(cuda_gbm.gbm_terminal_accurate, **kw),
}
PLAIN = {
    "localvol_terminal": lambda: _localvol(cuda_localvol.localvol_terminal_reference,
                                           device="cpu"),
    "heston_terminal_qe": lambda: _heston(cuda_heston.heston_terminal_qe_reference,
                                      device="cpu"),
    "heston_terminal": lambda: _heston(cuda_heston.heston_terminal_reference, device="cpu"),
    "gbm_terminal": lambda: _gbm(cuda_gbm.gbm_terminal_reference, device="cpu"),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_cpu_wrappers_are_the_plain_versions_and_launch_nothing(name):
    before = _counts()
    got = WRAPPERS[name](device="cpu")
    assert got.shape == (16384,) and bool(torch.isfinite(got).all())
    assert torch.equal(got, PLAIN[name.removesuffix("_accurate")]())
    assert _counts() == before


@pytest.mark.parametrize("device", ["cuda", None], ids=["cuda", "no_device"])
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_terminal_wrappers_raise_without_cuda(name, device):
    """A CUDA device, or none (the card by default), goes to the kernel or
    raises; neither falls back to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py covers the kernels")
    before = _counts()
    with pytest.raises(RuntimeError, match="CUDA"):
        WRAPPERS[name](device=device)
    assert _counts() == before


def _log_s_bias(form: str, n_steps: int = 100, T: float = 1.0) -> np.ndarray:
    """Mean relative error of S against float64 at each of rows 1..n_steps
    of a log-Euler path at sigma 0.2, r 0.05 in a float32 emulation (an FMA
    rounds once: its float64 value of two float32 factors is exact before
    the sum) of the local-vol update in one of three forms: "kernel" (both
    redesigned local-vol kernels) carries log S - log S0 and adds each
    step's whole increment; "absolute" adds r dt to the absolute log S
    first; "plain" is the plain version's log S + (r - sigma^2/2) dt +
    sigma sqrt(dt) z on the absolute log S. The last entry is S_T's."""
    f = np.float32
    z = np.random.default_rng(5).standard_normal((n_steps, 1 << 14)).astype(f)
    sig, dt = f(0.2), f(T) / f(n_steps)
    rdt, mhdt, sdt = f(0.05) * dt, f(-0.5) * dt, np.sqrt(dt)
    log_s0 = np.log(f(100.0))

    def fma(a, b, c):
        return (np.float64(a) * np.float64(b) + np.float64(c)).astype(f)

    x = np.full(z.shape[1], 0.0 if form == "kernel" else log_s0, f)
    exact = np.zeros(z.shape[1])
    rows = []
    for zt in z:
        inc = fma(sig, mhdt, sdt * zt)
        if form == "kernel":
            x = x + fma(sig, inc, rdt)
        elif form == "absolute":
            x = fma(sig, inc, x + rdt)
        else:
            x = (x + (f(0.05) - f(0.5) * sig * sig) * dt) + sig * sdt * zt
        exact += (np.float64(rdt) + np.float64(mhdt) * np.float64(sig) ** 2
                  + np.float64(sig) * np.float64(sdt) * zt.astype(np.float64))
        got = (log_s0 + x).astype(f) if form == "kernel" else x
        rows.append(np.mean(np.expm1(got.astype(np.float64) - (np.float64(log_s0) + exact))))
    return np.asarray(rows)


def test_log_s_update_rounds_without_bias():
    """Why csrc/terminal.cu carries log S - log S0: a constant added on its
    own to the absolute log S (~4.6, ulp 4.8e-7) rounds the same way at
    every step. r dt = 5e-4 rounds up by 0.42 ulp (+2e-5 in S_T over 100
    steps); the plain version's (r - sigma^2/2) dt, constant at constant
    sigma, rounds down (-7e-6), which is what the kernel is held against at
    rtol 1e-4; the kernel's form stays at ~1e-8."""
    assert abs(_log_s_bias("kernel")[-1]) < 1e-7
    assert _log_s_bias("absolute")[-1] > 1.5e-5
    assert -1e-5 < _log_s_bias("plain")[-1] < -5e-6


def test_localvol_paths_stored_rows_round_without_bias():
    """The paths kernel (csrc/localvol_paths.cu) stores every row of the
    kernel's form, so no row may carry a bias: at the local-vol American
    put's shape (50 steps, T 0.5) every stored row's mean relative error
    stays below 1e-7 (7e-9), while r dt added on its own to the absolute
    log S drifts up row by row (+0.42 ulp a step at r dt = 5e-4, +1.0e-5 at
    row 50) and the plain version's form down (-3.5e-6)."""
    kernel, absolute, plain = (_log_s_bias(form, 50, 0.5)
                               for form in ("kernel", "absolute", "plain"))
    assert kernel.shape == (50,) and float(np.abs(kernel).max()) < 1e-7
    assert absolute[-1] > 5e-6 and bool((np.diff(absolute[::10]) > 0).all())
    assert plain[-1] < -2e-6


def _euler_log_s_bias(seed: int = 5) -> dict:
    """Mean relative error of S_T against float64 on the same normals, after
    100 full-truncation Euler steps at the main path's Heston parameters
    (kappa 2, theta 0.04, xi 0.3, rho -0.7, v0 0.04, r 0.05, T 1), in a
    float32 emulation (an FMA rounds once) of x = log S - log S0 updated in
    one of three forms, each with its own variance chain: "kernel" (the
    terminal kernel) adds each step's whole increment fmaf(sqrt(dt v+), z1,
    fmaf(v+, -dt/2, r dt)); "paths" (the paths kernel, hopper_fast.cuh's
    euler_step without kWhole) rounds x + r dt first; "plain" is the plain
    version's x + (r - v+/2) dt + sqrt(v+) sqrt(dt) z1. S0 is a common
    factor, so the relative error of S_T is expm1(x - x_exact)."""
    f = np.float32
    rng = np.random.default_rng(seed)
    z1, z2 = rng.standard_normal((2, 100, 1 << 14)).astype(f)
    dt = f(1.0) / f(100)
    sdt, rho, rho_bar = np.sqrt(dt), f(-0.7), np.sqrt(f(1.0) - f(-0.7) * f(-0.7))
    kd = f(2.0) * dt
    ca, cb, rdt, mhdt, xi_sdt = f(1.0) - kd, kd * f(0.04), f(0.05) * dt, f(-0.5) * dt, f(0.3) * sdt

    def fma(a, b, c):
        return (np.float64(a) * np.float64(b) + np.float64(c)).astype(f)

    out = {}
    for form in ("kernel", "paths", "plain"):
        x, v = np.zeros(z1.shape[1], f), np.full(z1.shape[1], f(0.04))
        x64, v64 = np.zeros(z1.shape[1]), np.full(z1.shape[1], 0.04)
        for a, b in zip(z1, z2):
            vp, w2 = np.maximum(v, f(0.0)), fma(rho, a, rho_bar * b)
            sv = np.sqrt(vp)
            if form == "plain":
                sq = sv * sdt
                v = np.maximum(vp + f(2.0) * (f(0.04) - vp) * dt + f(0.3) * sq * w2, f(0.0))
                x = (x + (f(0.05) - f(0.5) * vp) * dt) + sq * a
            else:
                v = np.maximum(fma(xi_sdt * sv, w2, fma(vp, ca, cb)), f(0.0))
                x = (x + fma(sdt * sv, a, fma(vp, mhdt, rdt)) if form == "kernel"
                     else fma(sdt * sv, a, fma(vp, mhdt, x + rdt)))
            a64, b64 = a.astype(np.float64), b.astype(np.float64)
            vp64 = np.maximum(v64, 0.0)
            sq64 = np.sqrt(vp64 * 0.01)
            x64 = x64 + (0.05 - 0.5 * vp64) * 0.01 + sq64 * a64
            v64 = np.maximum(vp64 + 2.0 * (0.04 - vp64) * 0.01
                             + 0.3 * sq64 * (-0.7 * a64 + np.sqrt(1.0 - 0.49) * b64), 0.0)
        out[form] = float(np.mean(np.expm1(x.astype(np.float64) - x64)))
    return out


def test_euler_log_s_update_rounds_without_bias():
    """Why the Euler terminal kernel (csrc/terminal.cu) adds each step's
    whole increment to x = log S - log S0: x + r dt rounded on its own rounds
    the same way wherever x stays in one binade, -1.6e-7 in S_T over 100
    steps at these parameters; the kernel's form and the plain version's
    stay within ~1e-8 of float64 on the same normals."""
    bias = _euler_log_s_bias()
    print(f"mean relative bias of S_T vs float64: {bias}")
    assert abs(bias["kernel"]) <= 1e-6 and abs(bias["kernel"]) < 5e-8
    assert abs(bias["plain"]) < 5e-8
    assert bias["paths"] < -1e-7
