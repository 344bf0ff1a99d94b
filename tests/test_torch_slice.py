"""The port's slice as a whole: price_american end to end on the CPU engine
held against the JAX package and the oracles, the package's independence
from JAX, and the absence of any silent fallback.

Monte-Carlo comparisons use 4 combined standard errors: the two packages
draw different streams (Philox here, threefry there), so only their
distributions can agree.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from options_model_tpu.core.config import PUT
from options_model_tpu.core.config import BatesParams as JBatesParams
from options_model_tpu.core.config import HestonParams as JHestonParams
from options_model_tpu.core.config import LSMConfig as JLSMConfig
from options_model_tpu.core.config import MCConfig as JMCConfig
from options_model_tpu.core.config import MertonParams as JMertonParams
from options_model_tpu.core.config import OptionSpec as JOptionSpec
from options_model_tpu.pricers.american import price_american as j_price_american
from options_model_tpu.pricers.american import (
    price_american_with_stats as j_price_american_with_stats)
from options_model_tpu_torch.core.config import (BatesParams, HestonParams, LSMConfig, MCConfig,
                                                  MertonParams, OptionSpec)
from options_model_tpu_torch.pricers.american import (price_american, price_american_with_stats,
                                                      simulate_paths)
from options_model_tpu_torch.pricers.binomial import crr_american
from options_model_tpu_torch.pricers.european import (make_terminal_sampler,
                                                      price_european_mc)

REPO = Path(__file__).resolve().parents[1]
J_HESTON = JHestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
HESTON = HestonParams.from_reference(vars(J_HESTON))
J_MC = JMCConfig(n_paths=1 << 14, n_steps=16, path_block=4096)
MC = MCConfig.from_reference(vars(J_MC))
J_MERTON = JMertonParams(sigma=0.2, lam=1.0, mu_j=-0.10, sigma_j=0.15)
J_BATES = JBatesParams(heston=J_HESTON, lam=0.3, mu_j=-0.1, sigma_j=0.15)
MERTON = MertonParams.from_reference(vars(J_MERTON))
BATES = BatesParams.from_reference(vars(J_BATES))
# The routes of the jump families through the reference's dispatchers; the
# NN at 2^12 x 8 with a 16-unit net (tests/test_torch_nn_lsm.py's size).
JUMP_ROUTES = {"cv": {}, "richardson": dict(richardson=True),
               "european": dict(european_approximation=True), "stats": {},
               "nn": dict(regressor="nn", nn_hidden=16, nn_layers=1, nn_epochs=3,
                          nn_batch=512)}
# The port's stderr over the JAX package's, off the NN, at J_MC: different
# streams, so the two stderrs are each estimates (0.94-1.06 over three
# seeds of every route).
JUMP_SE_RATIO = 0.15


def _port(sigma, **lsm):
    js = JOptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=sigma)
    jl = JLSMConfig(**lsm)
    return js, jl, OptionSpec.from_reference(vars(js)), LSMConfig.from_reference(vars(jl))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _agree(p, se, p_j, se_j, n_se=4.0):
    gap = abs(float(p) - float(p_j))
    assert gap <= n_se * float(np.hypot(float(se), float(se_j))), (p, se, p_j, se_j)


def test_heston_american_slice_matches_reference():
    """The main path: Heston American put, (S, v) basis of degree 5 / 3,
    COS control variate and common-path Richardson."""
    js, jl, spec, lsm = _port(None, poly_degree=5, variance_basis_degree=3, richardson=True)
    p, se = price_american(_gen(1), 100.0, 0.5, spec, MC, lsm, "heston", heston=HESTON,
                           engine="torch", device="cpu")
    p_j, se_j = j_price_american(jax.random.key(1), 100.0, 0.5, js, J_MC, jl, "heston",
                                 heston=J_HESTON, engine="xla")
    assert p.shape == () and p.dtype == torch.float32 and 0 < float(se) < 0.05
    _agree(p, se, p_j, se_j)


def test_heston_american_cv_only_matches_reference():
    js, jl, spec, lsm = _port(None)
    p, se = price_american(_gen(2), 100.0, 0.5, spec, MC, lsm, "heston", heston=HESTON,
                           engine="torch", device="cpu")
    p_j, se_j = j_price_american(jax.random.key(2), 100.0, 0.5, js, J_MC, jl, "heston",
                                 heston=J_HESTON, engine="xla")
    _agree(p, se, p_j, se_j)


def test_gbm_american_put_within_4_stderr_of_crr():
    _, _, spec, lsm = _port(0.2, richardson=True)
    p, se = price_american(_gen(3), 100.0, 0.5, spec, MC, lsm, "gbm", engine="torch",
                           device="cpu")
    crr = crr_american(100.0, 100.0, 0.5, 0.05, 0.2, cp=-1.0, n_steps=1024)
    assert abs(float(p) - crr) <= 4.0 * float(se), (float(p), float(se), crr)


@pytest.mark.parametrize("model", ["heston", "gbm"])
def test_european_branch_matches_reference(model):
    sigma = 0.2 if model == "gbm" else None
    js, jl, spec, lsm = _port(sigma, european_approximation=True)
    jmc = JMCConfig(n_paths=1 << 15, n_steps=16, path_block=4096)
    mc = MCConfig.from_reference(vars(jmc))
    p, se = price_american(_gen(4), 100.0, 1.0, spec, mc, lsm, model, heston=HESTON,
                           engine="torch", device="cpu")
    p_j, se_j = j_price_american(jax.random.key(4), 100.0, 1.0, js, jmc, jl, model,
                                 heston=J_HESTON, engine="xla")
    _agree(p, se, p_j, se_j)


@pytest.mark.parametrize("route", [pytest.param(r, marks=pytest.mark.slow) if r == "nn" else r
                                   for r in sorted(JUMP_ROUTES)])
@pytest.mark.parametrize("model", ["merton", "bates"])
def test_jump_american_routes_match_reference(model, route):
    """The Merton (degree 5, series CV) and Bates (degree 3, COS CV) American
    puts through the CV, Richardson, European-approximation, stats and NN
    routes, against the JAX package's XLA engine within MC error; off the
    NN, each package's stderr within JUMP_SE_RATIO of the other's, so the
    port's jump streams and CV legs are no noisier than the reference's.
    The NN cases compile and train the JAX package's network (~12 s alone,
    several times that beside other test workers): marked slow."""
    sigma = 0.2 if model == "merton" else None
    js, jl, spec, lsm = _port(sigma, poly_degree=5 if model == "merton" else 3,
                              **JUMP_ROUTES[route])
    jmc = JMCConfig(n_paths=1 << 12, n_steps=8, path_block=2048) if route == "nn" else J_MC
    mc = MCConfig.from_reference(vars(jmc))
    kw, jkw = ((dict(merton=MERTON), dict(merton=J_MERTON)) if model == "merton"
               else (dict(bates=BATES), dict(bates=J_BATES)))
    if route == "stats":
        p, se, stats = price_american_with_stats(_gen(21), 100.0, 0.5, spec, mc, lsm, model,
                                                 device="cpu", **kw)
        p_j, se_j, stats_j = j_price_american_with_stats(jax.random.key(21), 100.0, 0.5, js,
                                                         jmc, jl, model, engine="xla", **jkw)
        assert set(stats) == set(stats_j)
    else:
        p, se = price_american(_gen(21), 100.0, 0.5, spec, mc, lsm, model, device="cpu", **kw)
        p_j, se_j = j_price_american(jax.random.key(21), 100.0, 0.5, js, jmc, jl, model,
                                     engine="xla", **jkw)
    assert bool(torch.isfinite(p)) and 0 < float(se) < 0.2
    _agree(p, se, p_j, se_j)
    if route != "nn":
        assert abs(float(se) / float(se_j) - 1.0) <= JUMP_SE_RATIO, (float(se), float(se_j))


@pytest.mark.slow
def test_merton_bench_leg_stderr_matches_reference():
    """bench.py's Merton American leg as chip_smoke.py's J1 runs it (2^18 x
    50, degree 5, series CV) on its first four seeds: the port's per-seed
    stderr against the JAX package's, within 3% pooled. Run with -s, it
    prints each seed's price and stderr and both packages' pooled stderr
    and seed spread (~25 s on the CPU: marked slow)."""
    js, jl, spec, lsm = _port(0.2, poly_degree=5)
    jmc = JMCConfig(n_paths=1 << 18, n_steps=50, path_block=4096)
    mc = MCConfig.from_reference(vars(jmc))
    rows = []
    for s in range(4):
        p, se = price_american(_gen(33 + s), 100.0, 0.5, spec, mc, lsm, "merton",
                               merton=MERTON, device="cpu")
        p_j, se_j = j_price_american(jax.random.fold_in(jax.random.key(33), s), 100.0, 0.5,
                                     js, jmc, jl, "merton", merton=J_MERTON, engine="xla")
        rows.append((float(p), float(se), float(p_j), float(se_j)))
    p, se, p_j, se_j = np.asarray(rows).T
    ratio = float(np.sqrt(np.sum(se ** 2) / np.sum(se_j ** 2)))
    for s, row in enumerate(rows):
        print(f"seed {s}: port {row[0]:.6f} +- {row[1]:.6f}, JAX {row[2]:.6f} +- {row[3]:.6f}")
    print(f"stderr ratio port/JAX {ratio:.4f}; per-seed stderr {se.mean() / p.mean():.4%} "
          f"/ {se_j.mean() / p_j.mean():.4%}; 4-seed spread (ddof 1) "
          f"{p.std(ddof=1) / p.mean():.4%} / {p_j.std(ddof=1) / p_j.mean():.4%}")
    assert abs(ratio - 1.0) <= 0.03, rows
    _agree(p.mean(), np.sqrt(np.sum(se ** 2)) / 4, p_j.mean(), np.sqrt(np.sum(se_j ** 2)) / 4)


def test_european_price_does_not_depend_on_chunk_size():
    """Chunks are keyed by global tile, so chunking only bounds memory."""
    _, _, spec, _ = _port(None)
    sampler = make_terminal_sampler("heston", 100.0, 0.05, 1.0, heston=HESTON, device="cpu")
    mc = MCConfig(n_paths=3 * 16384, n_steps=8)
    whole = price_european_mc(_gen(5), sampler, spec, 1.0, mc)
    chunked = price_european_mc(_gen(5), sampler, spec, 1.0, mc, max_paths_per_chunk=16384)
    assert float(whole[2]) == float(chunked[2]) == 3 * 16384
    assert float(whole[0]) == pytest.approx(float(chunked[0]), rel=1e-6)
    assert float(whole[1]) == pytest.approx(float(chunked[1]), rel=1e-4)


def test_simulate_paths_shapes_and_generator_determinism():
    S, v = simulate_paths(_gen(6), 100.0, 0.5, MC, "heston", rate=0.05, heston=HESTON,
                          return_variance=True, device="cpu")
    assert S.shape == v.shape == (17, 1 << 14)
    S2, _ = simulate_paths(_gen(6), 100.0, 0.5, MC, "heston", rate=0.05, heston=HESTON,
                           return_variance=True, device="cpu")
    assert torch.equal(S, S2)
    G = simulate_paths(_gen(6), 100.0, 0.5, MC, "gbm", sigma=0.2, rate=0.05, device="cpu")
    assert G.shape == (17, 1 << 14) and bool(torch.isfinite(G).all())


def test_package_imports_no_jax():
    """Every module of the port imports without JAX, flax or optax (in a
    fresh interpreter: this test process has JAX loaded)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import options_model_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax')]\n"
        "assert not bad, bad\n"
        "assert 'options_model_tpu' not in sys.modules\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_no_silent_fallback_to_the_cpu():
    _, _, spec, lsm = _port(None)
    args = (_gen(7), 100.0, 0.5, spec, MC, lsm, "heston")
    with pytest.raises(ValueError, match="engine"):
        price_american(*args, heston=HESTON, engine="cuda", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py drives the CUDA engine")
    with pytest.raises(RuntimeError, match="CUDA"):
        price_american(*args, heston=HESTON, engine="cuda", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        price_american(*args, heston=HESTON, device="cuda")


@pytest.mark.parametrize("case", ["vg", "sabr", "localvol", "axis_name", "blocked"])
def test_unported_features_name_their_reference(case):
    _, _, spec, lsm = _port(None)
    if case == "localvol":
        # Local vol is ported under a compiled table or a bare sigma_fn (the
        # surface-network route). With neither it raises ValueError, as the
        # reference does (options_model_tpu/pricers/european.py:190-191); a
        # bare sigma_fn prices (a constant 0.2: the GBM put's neighbourhood).
        with pytest.raises(ValueError, match="sigma_fn"):
            simulate_paths(_gen(8), 100.0, 0.5, MC, "localvol", rate=0.05, device="cpu")
        flat = lambda S, tau: torch.full_like(S, 0.2)  # noqa: E731
        S = simulate_paths(_gen(8), 100.0, 0.5, MC, "localvol", rate=0.05, sigma_fn=flat,
                           device="cpu")
        assert S.shape[0] == MC.n_steps + 1 and bool(torch.isfinite(S).all())
        p, se = price_american(_gen(8), 100.0, 0.5, spec, MC, lsm, "localvol", sigma_fn=flat,
                               device="cpu")
        assert 4.0 < float(p) < 5.3 and float(se) > 0
        return
    with pytest.raises(NotImplementedError, match="options_model_tpu\\."):
        # VG and SABR price through every American route and bracket; what
        # stays unported of them is the path-sharded dual (VG) and the
        # surface (SABR, which the reference's surface takes no parameters
        # for either)
        if case == "vg":
            from options_model_tpu_torch.core.config import VGParams
            from options_model_tpu_torch.pricers.dual import (dual_upper_from_policy,
                                                              fit_lsm_policy)
            S = simulate_paths(_gen(8), 100.0, 0.5, MC, "vg", rate=0.05,
                               vg=VGParams(0.2, -0.14, 0.2), device="cpu")
            policy, _ = fit_lsm_policy(S, spec, 0.5)
            dual_upper_from_policy(0, S, spec, 0.5, policy, model="vg",
                                   vg=VGParams(0.2, -0.14, 0.2), axis_name="paths")
        elif case == "sabr":
            from options_model_tpu_torch.pricers.surface_american import price_american_surface
            price_american_surface(_gen(8), 100.0, [100.0], [0.5], 0.05, MC, model="sabr",
                                   device="cpu")
        elif case == "axis_name":
            price_american(_gen(8), 100.0, 0.5, spec, MC, lsm, "heston", heston=HESTON,
                           axis_name="paths", device="cpu")
        else:
            simulate_paths(_gen(8), 100.0, 0.5, MC, "heston", heston=HESTON,
                           layout="blocked", device="cpu")
