"""The port's path recursions held against the JAX package.

- Zero normals: the JAX Pallas kernels in interpret mode draw zero bits (see
  tests/test_pallas_kernels.py), so their dynamics are the deterministic
  skeleton; the port's recursion on zero normals must give the same matrix.
- Identical non-zero normals: the JAX XLA simulators' own normals, rebuilt
  from models/blocks.block_normals with the keys simulate_heston and
  simulate_gbm fold, drive the port's recursion. Tolerance rtol 2e-5 on S and
  atol 1e-6 on v: f32 rounding compounding over 16 steps (the kernels carry
  log S relative to log S0, the XLA simulators absolute log S).
- The CPU wrappers are the plain versions, with the kernels' tile rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from options_model_tpu.core.config import HestonParams as JHestonParams
from options_model_tpu.core.config import MCConfig as JMCConfig
from options_model_tpu.models.blocks import block_normals
from options_model_tpu.models.gbm import simulate_gbm as j_simulate_gbm
from options_model_tpu.models.heston import simulate_heston as j_simulate_heston
from options_model_tpu.ops.pallas_gbm import gbm_paths_pallas, gbm_terminal_pallas
from options_model_tpu.ops.pallas_heston import (heston_paths_pallas,
                                                 heston_terminal_pallas)
from options_model_tpu_torch.core.config import HestonParams
from options_model_tpu_torch.models.gbm import gbm_euler_from_normals
from options_model_tpu_torch.models.heston import heston_euler_from_normals
from options_model_tpu_torch.ops import cuda_gbm, cuda_heston

FIELDS = dict(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
J_HESTON = JHestonParams(**FIELDS)
HESTON = HestonParams.from_reference(vars(J_HESTON))
S0, R, SIGMA, T = 100.0, 0.05, 0.2, 0.5
N_STEPS = 16


def _zeros(n_paths):
    return torch.zeros((N_STEPS, n_paths), dtype=torch.float32)


def test_heston_paths_zero_normals_match_interpret_kernel():
    S_j, v_j = heston_paths_pallas(1, S0, R, T, J_HESTON, 4096, N_STEPS, interpret=True,
                                   return_variance=True)
    S, v = heston_euler_from_normals(_zeros(4096), _zeros(4096), S0, R, T, HESTON,
                                     return_variance=True)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_j), rtol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=1e-6)
    # row 0 is exp(log S0) in f32 (100.00001 for S0 = 100), v0
    assert float(S[0, 0]) == float(S_j[0, 0]) == float(np.float32(100.00001))
    assert float(v[0, 0]) == np.float32(FIELDS["v0"])


def test_heston_terminal_zero_normals_match_interpret_kernel():
    ST_j = heston_terminal_pallas(1, S0, R, T, J_HESTON, 16384, N_STEPS, interpret=True)
    ST = heston_euler_from_normals(_zeros(16384), _zeros(16384), S0, R, T, HESTON,
                                   return_paths=False)
    np.testing.assert_allclose(ST.numpy(), np.asarray(ST_j), rtol=1e-6)


def test_gbm_paths_zero_normals_match_interpret_kernel():
    S_j = gbm_paths_pallas(1, S0, R, SIGMA, T, 4096, N_STEPS, interpret=True)
    S = gbm_euler_from_normals(_zeros(4096), S0, R, SIGMA, T)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_j), rtol=1e-6)
    assert float(S[0, 0]) == S0


def test_gbm_terminal_zero_normals_match_interpret_kernel():
    ST_j = gbm_terminal_pallas(1, S0, R, SIGMA, T, 16384, N_STEPS, interpret=True)
    ST = gbm_euler_from_normals(_zeros(16384), S0, R, SIGMA, T, return_paths=False)
    np.testing.assert_allclose(ST.numpy(), np.asarray(ST_j), rtol=1e-6)


def _jax_normals(key, cfg, n_draws):
    """The (n_steps, n_paths) normals simulate_heston / simulate_gbm draw:
    block b uses fold_in(key, b), step t and draw d fold in (t, d)."""
    half = cfg.path_block // 2
    n_blocks = cfg.n_paths // cfg.path_block
    out = np.zeros((n_draws, cfg.n_steps, cfg.n_paths), np.float32)
    for b in range(n_blocks):
        block_key = jax.random.fold_in(key, b)
        for t in range(cfg.n_steps):
            zs = block_normals(block_key, t, half, n_draws, cfg.antithetic, jnp.float32)
            for d, z in enumerate(zs):
                out[d, t, b * cfg.path_block:(b + 1) * cfg.path_block] = np.asarray(z)
    return [torch.from_numpy(z) for z in out]


@pytest.fixture(scope="module")
def cfg():
    return JMCConfig(n_paths=8192, n_steps=N_STEPS, path_block=4096)


@pytest.mark.parametrize("return_paths", [True, False])
def test_heston_recursion_matches_xla_simulator_on_its_normals(cfg, return_paths):
    key = jax.random.key(int(np.random.default_rng(3).integers(1 << 31)))
    z1, z2 = _jax_normals(key, cfg, 2)
    out_j = j_simulate_heston(key, S0, R, T, J_HESTON, cfg, return_paths=return_paths,
                              return_variance=return_paths)
    out = heston_euler_from_normals(z1, z2, S0, R, T, HESTON,
                                    return_variance=return_paths,
                                    return_paths=return_paths)
    if return_paths:
        (S, v), (S_j, v_j) = out, out_j
        np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=0, atol=1e-6)
    else:
        S, S_j = out, out_j
    assert S.shape == tuple(S_j.shape)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_j), rtol=2e-5)


@pytest.mark.parametrize("return_paths", [True, False])
def test_gbm_recursion_matches_xla_simulator_on_its_normals(cfg, return_paths):
    key = jax.random.key(int(np.random.default_rng(4).integers(1 << 31)))
    (z,) = _jax_normals(key, cfg, 1)
    S_j = j_simulate_gbm(key, S0, R, SIGMA, T, cfg, return_paths=return_paths)
    S = gbm_euler_from_normals(z, S0, R, SIGMA, T, return_paths=return_paths)
    assert S.shape == tuple(S_j.shape)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_j), rtol=2e-5)


def test_cpu_wrappers_are_the_plain_versions_with_tile_rounding():
    """On a CPU tensor each wrapper is its plain version, and the path count
    rounds up to whole kernel tiles, as the TPU kernels do."""
    args = (21, S0, R, T, HESTON, 5000, 8, True)
    S, v = cuda_heston.heston_paths(*args, return_variance=True, device="cpu")
    S_ref, v_ref = cuda_heston.heston_paths_reference(*args, return_variance=True,
                                                      device="cpu")
    assert S.shape == v.shape == (9, 8192)
    assert torch.equal(S, S_ref) and torch.equal(v, v_ref)
    assert torch.equal(cuda_heston.heston_paths(*args, device="cpu"), S)
    ST = cuda_heston.heston_terminal(*args, device="cpu")
    assert ST.shape == (16384,)
    G = cuda_gbm.gbm_paths(21, S0, R, SIGMA, T, 5000, 8, device="cpu")
    assert G.shape == (9, 8192) and bool((G[0] == S0).all())
    assert cuda_gbm.gbm_terminal(21, S0, R, SIGMA, T, 5000, 8, device="cpu").shape == (16384,)
    assert sum(cuda_heston.launches.values()) + sum(cuda_gbm.launches.values()) == 0


def test_wrappers_refuse_a_cuda_device_without_cuda():
    """A CUDA tensor goes to the kernel or raises; it never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py covers the kernels")
    with pytest.raises((RuntimeError, ValueError)):
        cuda_heston.heston_paths(1, S0, R, T, HESTON, 4096, 4, device="cuda")
    with pytest.raises((RuntimeError, ValueError)):
        cuda_gbm.gbm_terminal(1, S0, R, SIGMA, T, 4096, 4, device="cuda")
