"""The fused rough Bergomi kernel's plain version (ops/cuda_rbergomi.py
rbergomi_fused_reference, models/rbergomi.volterra_ordered) on the CPU:
the ascending-order Volterra sum, the plain chain against the first
design's, the JAX package on its own draws at the paths' step counts, the
stream's tiles and the wrappers' routes.

Tolerances, each with its reason:
- volterra_ordered against a float32 NumPy sum in ascending i: bit for bit
  (each product rounded, then added, in the same order); against the
  float64 product of the same float32 inputs: n 2^-24 sum_i |w dW_i| per
  entry (n roundings of at most half an ulp of a partial sum each, the
  partial sums bounded by the sum of the absolute terms); mirrored columns
  exactly -G (round to nearest is symmetric).
- The fused plain chain against the first design's (cuBLAS's order on the
  card, the CPU matmul's here): RB_RTOL 1e-5 on S, v, S_T, v_T and G_T, the
  dual state hist within RB_RTOL of its largest entry (G sums in two
  orders; its near-zero entries have no relative accuracy to hold).
- rbergomi_from_draws on the JAX package's draws at R5's and R4's step
  counts: rtol 1e-5 (XLA's matmul sums G in its own order; the scheme's
  outputs keep tests/test_torch_rbergomi.py's bar).
- The stream's tiles, the mirror's negated Y, dB and G, and the routes:
  bit for bit (the same float32 operations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from options_model_tpu.core.config import MCConfig as JMCConfig
from options_model_tpu.core.config import RBergomiParams as JRBergomiParams
from options_model_tpu.models import rbergomi as jrb
from options_model_tpu.models.blocks import block_normals
from options_model_tpu_torch.core.config import RBergomiParams
from options_model_tpu_torch.models import rbergomi as rb
from options_model_tpu_torch.ops import cuda_rbergomi as cr
from options_model_tpu_torch.ops.cuda_heston import PATH_TILE
from options_model_tpu_torch.ops.philox import rbergomi_path_draws
from _torch_threads import one_torch_thread_module  # noqa: F401

FIELDS = dict(H=0.1, eta=1.5, rho=-0.7, xi0=0.04)      # tests/test_rbergomi.py:30
SEED = 0x13198A2E03707344
RB_RTOL = 1e-5
MODES = {"paths": dict(return_variance=True, return_dual_state=True),
         "terminal": dict(return_variance=True), "cv": {}}

pytestmark = pytest.mark.usefixtures("one_torch_thread_module")


def _params(H):
    return RBergomiParams(**dict(FIELDS, H=H))


# ---- the Volterra sum in ascending order ----------------------------------------

@pytest.mark.parametrize("n", [12, 50, 96, 512])
@pytest.mark.parametrize("H", [0.1, 0.5])
def test_volterra_ordered_sums_ascending_within_its_bound(n, H):
    c = rb.rbergomi_constants(100.0, 1.0, _params(H), n)
    W = c["W_mat"]
    z = np.random.default_rng(n).standard_normal((n, 64)).astype(np.float32)
    z = np.concatenate([z, -z], axis=1)
    dW = np.float32(c["sqrt_dt"]) * z
    G = rb.volterra_ordered(torch.from_numpy(W), torch.from_numpy(dW)).numpy()
    want = np.zeros_like(dW)
    for i in range(n - 1):
        want[i + 1:] = want[i + 1:] + W[i + 1:, i:i + 1] * dW[i]
    assert want.dtype == np.float32 and np.array_equal(G, want)
    if n == 12:
        for k in range(n):
            acc = np.zeros(dW.shape[1], np.float32)
            for i in range(k):
                acc = acc + W[k, i] * dW[i]
            assert np.array_equal(G[k], acc)
    W64, dW64 = W.astype(np.float64), dW.astype(np.float64)
    bound = n * 2.0 ** -24 * (np.abs(W64) @ np.abs(dW64))
    assert np.all(np.abs(G - W64 @ dW64) <= bound)
    assert np.array_equal(G[:, 64:], -G[:, :64])
    assert not G[0].any()


def test_mirror_gives_negated_y_db_and_g():
    """The fused kernel walks a pair's mirror on -Y and -dB: on the stream,
    the mirror's dW, G (ascending), Y and dB are exactly the negated
    values."""
    n, c = 20, rb.rbergomi_constants(100.0, 0.5, _params(0.1), 20, 0.05)
    z1, z2, zp = rbergomi_path_draws(SEED, 0, 2, PATH_TILE, n, True)
    dW = float(c["sqrt_dt"]) * z1
    G = rb.volterra_ordered(torch.from_numpy(c["W_mat"]), dW)
    f = lambda v: torch.tensor(float(v), dtype=torch.float32)  # noqa: E731
    Y = f(c["sqrt2H"]) * ((G + f(c["c1"]) * dW) + f(c["c2"]) * z2)
    dB = f(c["rho"]) * dW + f(c["rbsd"]) * zp
    half = PATH_TILE // 2
    for a in (dW, G, Y, dB):
        t = a.reshape(n, 2, 2, half)
        assert torch.equal(t[:, :, 1], -t[:, :, 0])


# ---- the fused plain chain ---------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("anti", [True, False])
@pytest.mark.parametrize("H", [0.1, 0.5])
def test_fused_reference_equals_first_design_plain_chain(mode, anti, H):
    args = (SEED, 100.0, 0.5, _params(H), 2 * PATH_TILE, 50, 0.05, mode, anti, 0, "cpu")
    got = cr.rbergomi_fused(*args, **MODES[mode])
    want = cr.rbergomi_simulate_first(*args, **MODES[mode])
    names = {"paths": ("S", "v", "hist"), "terminal": ("S_T", "v_T"), "cv": ("S_T", "G_T")}
    assert len(got) == len(want) == len(names[mode])
    for name, a, b in zip(names[mode], got, want):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        if name == "hist":
            assert float((a - b).abs().max()) <= RB_RTOL * float(b.abs().max())
            assert torch.equal(a[:2], b[:2])    # rows 0 and 1: no sum to order
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RB_RTOL, err_msg=name)
    assert torch.equal(got[0], cr.rbergomi_fused_reference(*args, **MODES[mode])[0])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("anti", [True, False])
def test_first_tile_chunks_reproduce_their_tiles(mode, anti):
    P = _params(0.1)
    full = cr.rbergomi_fused(SEED, 100.0, 0.5, P, 3 * PATH_TILE, 10, 0.05, mode, anti, 0, "cpu",
                             **MODES[mode])
    part = cr.rbergomi_fused(SEED, 100.0, 0.5, P, 2 * PATH_TILE, 10, 0.05, mode, anti, 1, "cpu",
                             **MODES[mode])
    for a, b in zip(full, part):
        assert torch.equal(a[..., PATH_TILE:], b)


def test_simulate_routes_to_the_fused_plain_version():
    """simulate_rbergomi and terminal_cv_core on the CPU are the fused
    kernel's plain version bit for bit, and count no launch."""
    before = dict(cr.launches)
    P = _params(0.1)
    cfg = rb.MCConfig(n_paths=PATH_TILE, n_steps=12)
    got = rb.simulate_rbergomi(SEED, 100.0, 0.5, P, cfg, 0.05, return_paths=True,
                               return_variance=True, return_dual_state=True, device="cpu")
    want = cr.rbergomi_fused_reference(SEED, 100.0, 0.5, P, PATH_TILE, 12, 0.05, "paths",
                                       True, 0, "cpu", True, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    cv = rb.terminal_cv_core(SEED, 100.0, 0.05, 0.5, P, 12, PATH_TILE, device="cpu")
    want = cr.rbergomi_fused_reference(SEED, 100.0, 0.5, P, PATH_TILE, 12, 0.05, "cv",
                                       device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(cv, want))
    assert cr.launches == before


@pytest.mark.parametrize("n", [1, 50, 512])
def test_launch_constants_layout(n):
    """The host tables the fused kernel takes by value (csrc/rbergomi.cu RbK
    and RbW): RB_FIELDS, the compensator's length and the table padded to
    MAX_STEPS + 1; W_mat's first column padded to MAX_STEPS, w_{lag+1} at
    lag, the Toeplitz diagonal of every row."""
    c = rb.rbergomi_constants(100.0, 0.5, _params(0.1), n, 0.05)
    a = np.ctypeslib.as_array(cr.rb_args(c))
    f = len(cr.RB_FIELDS)
    assert a.size == f + 2 + cr.MAX_STEPS and a.dtype == np.float32
    assert list(a[:f]) == [np.float32(c[k]) for k in cr.RB_FIELDS] and a[f] == n + 1
    assert np.array_equal(a[f + 1:f + 2 + n], c["comp"]) and not a[f + 2 + n:].any()
    w = np.ctypeslib.as_array(cr.rb_weights(c))
    assert w.size == cr.MAX_STEPS and np.array_equal(w[:n], c["W_mat"][:, 0])
    assert not w[n:].any() and w[0] == 0.0
    for k in range(n):
        assert np.array_equal(c["W_mat"][k, :k], w[k:0:-1])


def test_fused_wrapper_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py drives the kernel")
    P = _params(0.1)
    for fn in (cr.rbergomi_fused, cr.rbergomi_simulate, cr.rbergomi_simulate_first):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(SEED, 100.0, 0.5, P, PATH_TILE, 4, device="cuda")
    with pytest.raises(ValueError, match="mode"):
        cr.rbergomi_fused(SEED, 100.0, 0.5, P, PATH_TILE, 4, mode="walk", device="cpu")
    with pytest.raises(ValueError, match="at most"):
        cr.rbergomi_fused(SEED, 100.0, 0.5, P, PATH_TILE, cr.MAX_STEPS + 1, device="cpu")


# ---- the JAX package's draws at the paths' step counts ----------------------------

def _jax_draws(key, cfg):
    """(z1, z2, zp), each (n_steps, n_paths): block_normals under the keys
    simulate_rbergomi and terminal_cv_core fold, in path order."""
    half = cfg.path_block // 2
    out = [[], [], []]
    for b in range(cfg.n_paths // cfg.path_block):
        bk = jax.random.fold_in(key, b)
        z = jax.vmap(lambda t: block_normals(bk, t, half, 3, cfg.antithetic,
                                             jnp.float32))(jnp.arange(cfg.n_steps))
        for o, zi in zip(out, z):
            o.append(zi)
    return tuple(torch.from_numpy(np.array(jnp.concatenate(o, axis=1))) for o in out)


@pytest.mark.parametrize("n_steps", [50, 96])
@pytest.mark.parametrize("H", [0.1, 0.5])
def test_from_draws_matches_the_jax_package_at_the_path_shapes(n_steps, H):
    """R5's 50 and R4's longest expiry's 96 steps: S and v paths, and the
    control variate's (S_T, G_T), on the JAX package's own draws."""
    jp, p = JRBergomiParams(**dict(FIELDS, H=H)), _params(H)
    cfg = JMCConfig(n_paths=2048, n_steps=n_steps, path_block=1024)
    key = jax.random.key(n_steps)
    S_j, v_j = jrb.simulate_rbergomi(key, 100.0, 1.0, jp, cfg, rate=0.05, return_paths=True,
                                     return_variance=True)
    S, v = rb.rbergomi_from_draws(*_jax_draws(key, cfg), 100.0, 1.0, p, 0.05,
                                  return_paths=True, return_variance=True)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_j), rtol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=1e-5)
    key = jax.random.key(n_steps + 1)
    S_j, G_j = jrb.rbergomi_terminal_cv(key, 100.0, 0.05, 1.0, jp, cfg)
    S_T, G_T = rb.rbergomi_from_draws(*_jax_draws(key, cfg), 100.0, 1.0, p, 0.05,
                                      return_cv=True)
    np.testing.assert_allclose(S_T.numpy(), np.asarray(S_j), rtol=1e-5)
    np.testing.assert_allclose(G_T.numpy(), np.asarray(G_j), rtol=1e-5)
