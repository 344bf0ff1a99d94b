"""The local-vol paths kernel's host side (kernel 8: the redesign in
csrc/localvol_paths.cu, its first design in csrc/localvol.cu) held against
the JAX package and the port's plain version on the CPU.

- On a CPU tensor ``localvol_paths`` and ``localvol_paths_accurate`` are the
  plain version and launch nothing; without CUDA each raises for
  device="cuda" and for no device (the card by default).
- The plain version on zero normals against localvol_paths_pallas in
  interpret mode at the degrees past the default (3, and 17 where the
  redesign takes its run-time instance), rtol 1e-6; degree 7 is
  tests/test_torch_localvol.py's.

The padded table both redesigns read, and the float32 emulation of the
kernel's log-S update at every stored row
(``test_localvol_paths_stored_rows_round_without_bias``), are in
tests/test_torch_terminal.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from options_model_tpu.ops.pallas_localvol import localvol_paths_pallas
from options_model_tpu.surface import cheb as jcheb
from options_model_tpu_torch.models.localvol import localvol_euler_from_normals
from options_model_tpu_torch.ops import cuda_localvol
from options_model_tpu_torch.surface.cheb import LocalVolTable, compile_localvol_table

S0, R, T = 100.0, 0.05, 0.5
N_STEPS = 16


def _smile_jax(S, tau):
    m = jnp.log(jnp.asarray(S) / 100.0)
    return jnp.clip(0.2 + 0.1 * jnp.abs(m) + 0.05 * m**2 + 0.02 * jnp.sqrt(tau), 0.05, 1.0)


def _smile_torch(S, tau):
    m = torch.log(S / 100.0)
    return torch.clamp(0.2 + 0.1 * torch.abs(m) + 0.05 * m * m + 0.02 * torch.sqrt(tau),
                       0.05, 1.0)


def _table(degree: int = 7) -> LocalVolTable:
    return compile_localvol_table(_smile_torch, 100.0, T, N_STEPS, S0, degree=degree)


WRAPPERS = ("localvol_paths", "localvol_paths_accurate")


def _run(name, **kw):
    return getattr(cuda_localvol, name)(21, S0, R, T, _table(), 5000, N_STEPS - 1, True, 1,
                                        **kw)


@pytest.mark.parametrize("name", WRAPPERS)
def test_cpu_paths_wrappers_are_the_plain_version_and_launch_nothing(name):
    before = dict(cuda_localvol.launches)
    got = _run(name, device="cpu")
    assert got.shape == (N_STEPS, 8192) and bool(torch.isfinite(got).all())
    want = cuda_localvol.localvol_paths_reference(21, S0, R, T, _table(), 5000, N_STEPS - 1,
                                                  True, 1, device="cpu")
    assert torch.equal(got, want)
    assert cuda_localvol.launches == before


@pytest.mark.parametrize("device", ["cuda", None], ids=["cuda", "no_device"])
@pytest.mark.parametrize("name", WRAPPERS)
def test_paths_wrappers_raise_without_cuda(name, device):
    """A CUDA device, or none, goes to the kernel or raises; neither falls
    back to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py covers the kernels")
    before = dict(cuda_localvol.launches)
    with pytest.raises(RuntimeError, match="CUDA"):
        _run(name, device=device)
    assert cuda_localvol.launches == before


@pytest.mark.parametrize("degree", [3, 17])
def test_localvol_paths_zero_normals_match_interpret_kernel_at_degree(degree):
    jt = jcheb.compile_localvol_table(_smile_jax, 100.0, T, N_STEPS, S0, degree=degree)
    t = LocalVolTable.from_reference(vars(jt))
    assert t.degree == degree
    S_j = localvol_paths_pallas(1, S0, R, T, jt, 4096, N_STEPS, interpret=True)
    S = localvol_euler_from_normals(torch.zeros((N_STEPS, 4096)), S0, R, T, t)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_j), rtol=1e-6)
