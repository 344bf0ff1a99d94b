"""The port's Black-Scholes Greeks, implied vol, config checks and native CRR
held against the JAX package.

- bs_delta, bs_vega, bs_greeks (autograd) and bs_greeks_closed_form in
  float32 on a numpy-seeded grid, calls and puts, q = 0 and q > 0: rtol
  1e-5 (Gamma 1e-4: a second derivative through erfc in f32), with an
  absolute floor of 1e-5 of the largest value for elements near 0.
- implied_vol: the reference's round-trip cases within 1e-5 of its solve;
  its gradient in price, S, K, T and r within rtol 1e-4 of jax.grad of the
  reference's (both implicit: the same formula, f32 vega), and 0 on the
  [lo, hi] clamp.
- validate() and cp_from_str / cp_to_str: the same exception type and
  message, or the same value.
- The native CRR equals the NumPy CRR to 1e-12 relative (one tree in C++
  double, one in numpy float64; u^k and exp(k log u) differ in the last
  ulps).
- Entry points given no device resolve to the card: without CUDA they raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from options_model_tpu.core import config as jcfg
from options_model_tpu.pricers import blackscholes as jbs
from options_model_tpu.pricers.binomial import crr_price as j_crr_price
from options_model_tpu_torch.core import config as cfg
from options_model_tpu_torch.core.config import HestonParams, MCConfig, OptionSpec
from options_model_tpu_torch.ops.engine import checked_device
from options_model_tpu_torch.pricers import blackscholes as bs
from options_model_tpu_torch.pricers.binomial import crr_price

RNG = np.random.default_rng(8)
N = 64
GRID = dict(S=RNG.uniform(70.0, 130.0, N), K=RNG.uniform(80.0, 120.0, N),
            T=RNG.uniform(0.1, 2.0, N), r=RNG.uniform(0.0, 0.08, N),
            sigma=RNG.uniform(0.1, 0.6, N))
GRID = {k: v.astype(np.float32) for k, v in GRID.items()}
S0, K, T, R = 100.0, 100.0, 0.5, 0.05
HESTON = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)


def _torch_grid():
    return [torch.from_numpy(GRID[k]) for k in ("S", "K", "T", "r", "sigma")]


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("cp", [1.0, -1.0])
@pytest.mark.parametrize("q", [0.0, 0.03])
def test_delta_and_vega_match(cp, q):
    S, K_, T_, r, sig = _torch_grid()
    j = [jnp.asarray(GRID[k]) for k in ("S", "K", "T", "r", "sigma")]
    _close(bs.bs_delta(S, K_, T_, r, sig, cp, q).numpy(), jbs.bs_delta(*j, cp, q), 1e-5)
    _close(bs.bs_vega(S, K_, T_, r, sig, q).numpy(), jbs.bs_vega(*j, q), 1e-5)


@pytest.mark.parametrize("cp", [1.0, -1.0])
@pytest.mark.parametrize("q", [0.0, 0.03])
@pytest.mark.parametrize("form", ["autograd", "closed_form"])
def test_greeks_match(cp, q, form):
    """bs_greeks (autograd, elementwise over the grid) and the closed form
    against the reference's (jax.grad of a scalar, vmapped; and its closed
    form)."""
    fn = bs.bs_greeks if form == "autograd" else bs.bs_greeks_closed_form
    jfn = jbs.bs_greeks if form == "autograd" else jbs.bs_greeks_closed_form
    got = fn(*_torch_grid(), cp, q)
    want = jax.vmap(lambda *a: jfn(*a, cp, q))(*[jnp.asarray(GRID[k]) for k in
                                                 ("S", "K", "T", "r", "sigma")])
    for name in ("Delta", "Gamma", "Vega", "Theta", "Rho"):
        _close(got[name].numpy(), want[name], 1e-4 if name == "Gamma" else 1e-5)


def test_autograd_greeks_equal_closed_form():
    ad = bs.bs_greeks(*_torch_grid(), -1.0, 0.01)
    cf = bs.bs_greeks_closed_form(*_torch_grid(), -1.0, 0.01)
    for name in ad:
        _close(ad[name].numpy(), cf[name].numpy(), 1e-4 if name == "Gamma" else 1e-5)


@pytest.mark.parametrize("sigma_true", [0.08, 0.2, 0.5, 1.2])
@pytest.mark.parametrize("cp", [1.0, -1.0])
def test_implied_vol_round_trip_matches(sigma_true, cp):
    """tests/test_blackscholes.py:65-70 at its S0 = K = 100, T = 1."""
    price = jbs.bs_price(100.0, 100.0, 1.0, R, sigma_true, cp)
    want = float(jbs.implied_vol(price, 100.0, 100.0, 1.0, R, cp))
    got = float(bs.implied_vol(float(price), 100.0, 100.0, 1.0, R, cp, device="cpu"))
    assert got == pytest.approx(want, abs=1e-5)
    assert got == pytest.approx(sigma_true, rel=1e-4)


def test_implied_vol_vectorized_and_short_dated_match():
    """tests/test_blackscholes.py:72-80."""
    sigmas = np.linspace(0.1, 0.8, 16).astype(np.float32)
    prices = jbs.bs_price(100.0, 100.0, 1.0, R, jnp.asarray(sigmas), 1.0)
    got = bs.implied_vol(torch.from_numpy(np.asarray(prices)), 100.0, 100.0, 1.0, R, 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jbs.implied_vol(prices, 100.0, 100.0,
                                                                      1.0, R, 1.0)),
                               rtol=0, atol=1e-5)
    p = jbs.bs_price(100.0, 120.0, 0.1, R, 0.3, 1.0)
    got = float(bs.implied_vol(float(p), 100.0, 120.0, 0.1, R, 1.0, device="cpu"))
    assert got == pytest.approx(float(jbs.implied_vol(p, 100.0, 120.0, 0.1, R, 1.0)),
                                abs=1e-5)


@pytest.mark.parametrize("cp, K_, T_, sig", [(1.0, 100.0, 0.5, 0.25), (-1.0, 110.0, 1.5, 0.4),
                                             (1.0, 90.0, 0.2, 0.15)])
def test_implied_vol_gradient_matches_jax(cp, K_, T_, sig):
    """d sigma / d(price, S, K, T, r): the implicit-function rule in both."""
    x0 = np.array([float(bs.bs_price(S0, K_, T_, R, sig, cp, device="cpu")), S0, K_, T_, R],
                  np.float32)
    want = jax.grad(lambda x: jbs.implied_vol(x[0], x[1], x[2], x[3], x[4], cp))(
        jnp.asarray(x0))
    x = torch.from_numpy(x0).requires_grad_()
    (got,) = torch.autograd.grad(bs.implied_vol(*x.unbind(), cp), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    assert abs(float(got[0])) > 0   # d sigma / d price = 1 / vega


def test_implied_vol_gradient_is_zero_on_the_clamp():
    """A price below intrinsic pins sigma at lo; one above the sup pins it
    at hi: both have gradient 0 in every input."""
    x = torch.tensor([[1e-6, S0, K, T, R], [99.0, S0, K, T, R]], dtype=torch.float32,
                     requires_grad=True)
    iv = bs.implied_vol(*x.unbind(1), 1.0)
    assert float(iv[0]) == pytest.approx(1e-4) and float(iv[1]) == pytest.approx(5.0)
    (g,) = torch.autograd.grad(iv.sum(), x)
    assert torch.equal(g, torch.zeros_like(g))


def _case(cls, **fields):
    return pytest.param(cls, fields, id=f"{cls}-" + "-".join(f"{k}={v}" for k, v in
                                                           fields.items()))


VALIDATE_CASES = [
    _case("OptionSpec", strike=100.0, rate=0.05),
    _case("OptionSpec", strike=0.0, rate=0.05),
    _case("OptionSpec", strike=100.0, rate=-0.01),
    _case("OptionSpec", strike=100.0, rate=0.05, cp=0.5),
    _case("OptionSpec", strike=100.0, rate=0.05, sigma=-0.2),
    _case("OptionSpec", strike=100.0, rate=0.05, div_yield=-0.01),
    _case("HestonParams", kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04),
    _case("HestonParams", kappa=25.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04),
    _case("HestonParams", kappa=2.0, theta=2.5, xi=0.3, rho=-0.7, v0=0.04),
    _case("HestonParams", kappa=2.0, theta=0.04, xi=0.0, rho=-0.7, v0=0.04),
    _case("HestonParams", kappa=2.0, theta=0.04, xi=0.3, rho=-1.0, v0=0.04),
    _case("HestonParams", kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=2.0),
    _case("MCConfig", n_paths=1000, n_steps=10),
    _case("MCConfig", n_paths=0, n_steps=10),
    _case("MCConfig", n_paths=1000, n_steps=10, path_block=1000),
    _case("LSMConfig"),
    _case("LSMConfig", regressor="tree"),
    _case("LSMConfig", poly_degree=9),
    _case("LSMConfig", nn_policy_iters=0),
    _case("LSMConfig", cv_beta="two"),
    _case("LSMConfig", variance_basis_degree=4),
]


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the outcome is compared, whatever it is
        return type(e), str(e)
    return None


@pytest.mark.parametrize("cls, fields", VALIDATE_CASES)
def test_validate_matches(cls, fields):
    want = _outcome(lambda: getattr(jcfg, cls)(**fields).validate())
    got = _outcome(lambda: getattr(cfg, cls)(**fields).validate())
    assert got == want


@pytest.mark.parametrize("text", ["call", " Put ", "c", "P", "straddle"])
def test_cp_from_str_matches(text):
    assert _outcome(lambda: cfg.cp_from_str(text)) == _outcome(lambda: jcfg.cp_from_str(text))
    if _outcome(lambda: cfg.cp_from_str(text)) is None:
        assert cfg.cp_from_str(text) == jcfg.cp_from_str(text)
        assert cfg.cp_to_str(cfg.cp_from_str(text)) == jcfg.cp_to_str(jcfg.cp_from_str(text))


@pytest.mark.parametrize("args", [(100.0, 100.0, 0.5, 0.05, 0.2, -1.0, 1024, True, 0.0),
                                  (100.0, 95.0, 0.75, 0.04, 0.25, 1.0, 512, True, 0.01),
                                  (100.0, 105.0, 1.0, 0.03, 0.3, -1.0, 300, False, 0.02)])
def test_native_crr_equals_numpy(args):
    *head, american, q = args
    want = crr_price(*head, american=american, q=q)
    got = crr_price(*head, american=american, q=q, use_native=True)
    assert got == pytest.approx(want, rel=1e-12, abs=0)
    assert want == pytest.approx(j_crr_price(*head, american=american, q=q,
                                             use_native=False), rel=1e-12, abs=0)


def test_native_crr_rejects_an_invalid_tree():
    with pytest.raises(ValueError):
        crr_price(100.0, 100.0, 1.0, 0.5, 0.01, -1.0, 4, use_native=True)


def _mc_greeks():
    from options_model_tpu_torch.pricers.greeks import mc_greeks

    return mc_greeks(torch.Generator().manual_seed(1), S0, T,
                     OptionSpec(strike=K, rate=R, cp=-1.0, sigma=0.2),
                     MCConfig(n_paths=4096, n_steps=4))


def _mc_greeks_heston():
    from options_model_tpu_torch.pricers.greeks import mc_greeks_heston

    return mc_greeks_heston(torch.Generator().manual_seed(1), S0, T,
                            OptionSpec(strike=K, rate=R, cp=-1.0), MCConfig(n_paths=4096,
                                                                           n_steps=4),
                            HESTON)


def _cos_greeks():
    from options_model_tpu_torch.pricers.greeks import cos_greeks_heston

    return cos_greeks_heston(S0, K, 1.0, R, HESTON)


def _exact_price():
    from options_model_tpu_torch.pricers.european import price_european_gbm_exact

    return price_european_gbm_exact(torch.Generator().manual_seed(1), S0,
                                    OptionSpec(strike=K, rate=R, sigma=0.2), 1.0, 16384)


@pytest.mark.parametrize("call", [
    lambda: bs.bs_price(S0, K, T, R, 0.2),
    lambda: bs.bs_delta(S0, K, T, R, 0.2),
    lambda: bs.bs_vega(S0, K, T, R, 0.2),
    lambda: bs.bs_greeks(S0, K, T, R, 0.2),
    lambda: bs.bs_greeks_closed_form(S0, K, T, R, 0.2),
    lambda: bs.implied_vol(5.0, S0, K, T, R),
    lambda: __import__("options_model_tpu_torch.calibration.charfn", fromlist=["x"])
    .heston_cos_price(S0, K, 1.0, R, HESTON),
    _cos_greeks, _mc_greeks, _mc_greeks_heston, _exact_price,
], ids=["bs_price", "bs_delta", "bs_vega", "bs_greeks", "bs_greeks_closed_form",
        "implied_vol", "heston_cos_price", "cos_greeks_heston", "mc_greeks",
        "mc_greeks_heston", "price_european_gbm_exact"])
def test_entry_points_without_a_device_raise_without_cuda(call):
    """Called with no device and no tensor argument on a machine without
    CUDA, each entry point raises instead of computing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


def test_closed_forms_resolve_to_the_card_by_default(monkeypatch):
    """bs_price and heston_cos_price ask for the card when no tensor sets the
    device: the device they would allocate on is checked_device(None)."""
    seen = []

    def spy(device=None):
        seen.append(device)
        return torch.device("cpu")

    import options_model_tpu_torch.calibration.charfn as charfn

    monkeypatch.setattr(bs, "checked_device", spy)
    monkeypatch.setattr(charfn, "checked_device", spy)
    bs.bs_price(S0, K, T, R, 0.2)
    charfn.heston_cos_price(S0, K, 1.0, R, HESTON)
    assert seen == [None, None]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert checked_device(None) == torch.device("cuda")
