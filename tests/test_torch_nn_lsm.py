"""The NN-LSM path of the port (ops/lsm_basis, models/heston.effective_bs_sigma,
the continuation MLP of pricers/regressors, the NN half of pricers/american,
core/stats.cashflow_statistics) held against the JAX package on the CPU.

Deterministic pieces take identical inputs, made with numpy or by the JAX
XLA simulator, and agree within f32 rounding (rtol 1e-5 unless stated).
The MLP is compared with Flax's weights carried across
(``mlp_state_from_flax``). The trained prices cannot agree draw for draw:
the two packages draw their weights, minibatches and dropout masks from
different generators, so on identical paths they agree within 3 times the
larger stderr plus 1% (two fits of a 16-unit net differ by more than MC
noise at 4096 paths).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from options_model_tpu.core.config import PUT
from options_model_tpu.core.config import HestonParams as JHestonParams
from options_model_tpu.core.config import LSMConfig as JLSMConfig
from options_model_tpu.core.config import MCConfig as JMCConfig
from options_model_tpu.core.config import MertonParams as JMertonParams
from options_model_tpu.core.config import OptionSpec as JOptionSpec
from options_model_tpu.core.stats import cashflow_statistics as j_cashflow_statistics
from options_model_tpu.models.heston import effective_bs_sigma as j_effective_bs_sigma
from options_model_tpu.ops.lsm_basis import poly_features as j_poly_features
from options_model_tpu.ops.lsm_basis import regression_features as j_regression_features
from options_model_tpu.pricers import american as ja
from options_model_tpu.pricers import regressors as jr
from options_model_tpu_torch.core.config import (HestonParams, LSMConfig, MCConfig,
                                                  MertonParams, OptionSpec)
from options_model_tpu_torch.core.stats import cashflow_statistics, masked_mean_stderr
from options_model_tpu_torch.models.heston import effective_bs_sigma
from options_model_tpu_torch.ops.lsm_basis import poly_features, regression_features
from options_model_tpu_torch.ops.philox import seed_from_generator
from options_model_tpu_torch.pricers import american as pa
from options_model_tpu_torch.pricers import regressors as pr

J_HESTON = JHestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
HESTON = HestonParams.from_reference(vars(J_HESTON))
J_MERTON = JMertonParams(sigma=0.2, lam=1.0, mu_j=-0.10, sigma_j=0.15)
MERTON = MertonParams.from_reference(vars(J_MERTON))
S0, T = 100.0, 0.5
J_MC = JMCConfig(n_paths=4096, n_steps=8, path_block=2048)
MC = MCConfig.from_reference(vars(J_MC))
# 4096 x 8 paths, a 16-unit net, 3 epochs; minibatches of 512 give each fit 168
# steps, enough that two fits land near one policy.
SMALL = dict(regressor="nn", nn_hidden=16, nn_layers=1, nn_epochs=3, nn_batch=512)


def _spec(sigma):
    js = JOptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=sigma)
    return js, OptionSpec.from_reference(vars(js))


def _lsm(**kw):
    jl = JLSMConfig(**{**SMALL, **kw})
    return jl, LSMConfig.from_reference(vars(jl))


def _t(x):
    return torch.tensor(np.asarray(x))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def xla_paths():
    """Identical paths for both packages: the JAX XLA simulators' GBM,
    Merton and Heston (S, v) paths at 4096 x 8."""
    key = jax.random.key(11)
    S_g = ja.simulate_paths(key, S0, T, J_MC, "gbm", sigma=0.2, rate=0.05, engine="xla")
    S_m = ja.simulate_paths(key, S0, T, J_MC, "merton", rate=0.05, engine="xla",
                            merton=J_MERTON)
    S_h, v_h = ja.simulate_paths(key, S0, T, J_MC, "heston", rate=0.05, heston=J_HESTON,
                                 engine="xla", return_variance=True)
    return {"gbm": (np.asarray(S_g), None), "merton": (np.asarray(S_m), None),
            "heston": (np.asarray(S_h), np.asarray(v_h))}


def test_regression_and_poly_features_match_reference():
    rng = np.random.default_rng(0)
    S = rng.uniform(60.0, 140.0, (5, 64)).astype(np.float32)
    tau = rng.uniform(0.0, 1.0, (5, 1)).astype(np.float32)
    tau[0] = 0.0   # the sqrt(max(tau, 1e-6)) floor
    np.testing.assert_allclose(regression_features(_t(S), 100.0, _t(tau)).numpy(),
                               np.asarray(j_regression_features(S, 100.0, tau)), rtol=1e-6)
    np.testing.assert_allclose(regression_features(_t(S[0]), 100.0, 0.25).numpy(),
                               np.asarray(j_regression_features(S[0], 100.0, 0.25)),
                               rtol=1e-6)
    np.testing.assert_allclose(poly_features(_t(S), 100.0, None, 4).numpy(),
                               np.asarray(j_poly_features(S, 100.0, None, 4)), rtol=1e-6)


def test_effective_bs_sigma_matches_reference():
    rng = np.random.default_rng(1)
    v = rng.uniform(0.0, 0.2, (6, 32)).astype(np.float32)
    tau = rng.uniform(0.0, 1.0, (6, 1)).astype(np.float32)
    tau[0] = 0.0   # kappa tau floored at 1e-6
    np.testing.assert_allclose(effective_bs_sigma(_t(v), _t(tau), HESTON).numpy(),
                               np.asarray(j_effective_bs_sigma(v, tau, J_HESTON)), rtol=1e-5)


def _flax_pair(hidden, layers, d=7, seed=0, dropout=0.1):
    """(Flax model, its params as numpy, the port's net with those weights)."""
    jm = jr.ContinuationMLP(hidden=hidden, num_layers=layers, dropout=dropout)
    params = jm.init(jax.random.key(seed), jnp.zeros((1, d)), deterministic=True)
    params = jax.tree.map(np.asarray, params)
    net = pr.ContinuationMLP(d, hidden, layers, dropout)
    net.load_state_dict(pr.mlp_state_from_flax(params))
    return jm, params, net


@pytest.mark.parametrize("hidden,layers", [(32, 2), (128, 3)])
def test_mlp_forward_with_flax_weights_matches_reference(hidden, layers):
    jm, params, net = _flax_pair(hidden, layers)
    X = np.random.default_rng(2).normal(size=(257, 7)).astype(np.float32)
    want = np.asarray(jm.apply(params, X, deterministic=True))
    with torch.no_grad():
        got = net(_t(X)).numpy()
    assert got.shape == want.shape == (257, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_chunked_loss_and_predict_match_reference_and_unchunked():
    """A chunk smaller than n, n not a multiple of it."""
    cfg_j = JLSMConfig(regressor="nn", nn_hidden=16, nn_layers=2)
    jm, params, net = _flax_pair(16, 2, d=5)
    rng = np.random.default_rng(3)
    X = rng.normal(size=(1000, 5)).astype(np.float32)
    y = rng.normal(size=1000).astype(np.float32)
    w = (rng.uniform(size=1000) > 0.3).astype(np.float32)
    loss = pr.full_weighted_loss(net, _t(X), _t(y), _t(w), chunk=256)
    np.testing.assert_allclose(float(loss), float(jr.full_weighted_loss(
        params, X, y, w, cfg_j, chunk=256)), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(pr.full_weighted_loss(
        net, _t(X), _t(y), _t(w), chunk=1 << 17)), rtol=1e-6)
    pred = pr.mlp_predict(net, _t(X), chunk=256)
    assert pred.shape == (1000,)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jr.mlp_predict(params, X, cfg_j,
                                                                       chunk=256)),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(pred, pr.mlp_predict(net, _t(X)))


def test_one_adamw_step_matches_optax():
    """make_optimizer's AdamW and weighted_mse, dropout 0, one step on a
    fixed batch, against jax.value_and_grad + optax.adamw."""
    jm, params, net = _flax_pair(16, 2, d=7, dropout=0.0)
    rng = np.random.default_rng(4)
    X = rng.normal(size=(512, 7)).astype(np.float32)
    y = rng.normal(size=512).astype(np.float32)
    w = (rng.uniform(size=512) > 0.4).astype(np.float32)

    def loss_fn(p):
        pred = jm.apply(p, X, deterministic=True)[:, 0]
        return jnp.sum(w * (pred - y) ** 2) / jnp.maximum(jnp.sum(w), 1.0)

    tx = optax.adamw(1e-3, weight_decay=1e-5)
    j_loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = pr.mlp_state_from_flax(jax.tree.map(np.asarray, optax.apply_updates(params, updates)))

    opt = pr.make_optimizer(net, LSMConfig(regressor="nn", nn_lr=1e-3))
    loss = pr.weighted_mse(net(_t(X))[:, 0], _t(y), _t(w))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    loss.backward()
    opt.step()
    for name, p in net.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)


def test_init_is_flax_lecun_normal_truncated():
    """Zero bias; kernel std 1/sqrt(fan_in) (the truncation's 0.8796 factor
    undone), every weight within 2 of the pre-truncation std, and the same
    std as Flax's own init."""
    net = pr.ContinuationMLP(64, hidden=512, num_layers=1, dropout=0.1)
    net.reset_parameters(torch.Generator().manual_seed(5))
    W = net.layers[0].weight.detach()
    limit = 2.0 * (1.0 / 8.0) / 0.87962566103423978
    assert float(W.abs().max()) <= limit
    assert abs(float(W.std()) - 1.0 / 8.0) < 0.03 / 8.0
    assert all(bool((lin.bias == 0).all()) for lin in net.layers)
    jm = jr.ContinuationMLP(hidden=512, num_layers=1)
    kernel = np.asarray(jm.init(jax.random.key(5), jnp.zeros((1, 64)))["params"]["Dense_0"]
                        ["kernel"])
    assert abs(float(W.std()) - kernel.std()) < 0.03 * kernel.std()
    # the same generator state gives the same weights; the global one is untouched
    torch.manual_seed(0)
    before = torch.rand(1)
    torch.manual_seed(0)
    net2 = pr.ContinuationMLP(64, hidden=512, num_layers=1)
    net2.reset_parameters(torch.Generator().manual_seed(5))
    assert torch.equal(net2.layers[0].weight, net.layers[0].weight)
    assert torch.equal(torch.rand(1), before)


def test_dropout_masks_come_from_the_generator():
    net = pr.ContinuationMLP(4, hidden=64, num_layers=2, dropout=0.5)
    net.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(32, 4, generator=torch.Generator().manual_seed(1))
    a = net(x, torch.Generator().manual_seed(9))
    b = net(x, torch.Generator().manual_seed(9))
    c = net(x, torch.Generator().manual_seed(10))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(net(x), net(x))


def test_fit_keeps_the_best_epoch():
    """The returned net scores the minimum of the per-epoch full-data losses."""
    rng = np.random.default_rng(6)
    X = _t(rng.normal(size=(4096, 3)).astype(np.float32))
    y = torch.sin(X[:, 0]) + 0.1 * _t(rng.normal(size=4096).astype(np.float32))
    w = _t((rng.uniform(size=4096) > 0.3).astype(np.float32))
    cfg = LSMConfig(regressor="nn", nn_epochs=6, nn_hidden=16, nn_layers=1, nn_batch=256)
    net, losses = pr.fit_continuation_mlp(_gen(7), X, y, w, cfg)
    assert losses.shape == (6,)
    best = float(pr.full_weighted_loss(net, X, y, w))
    np.testing.assert_allclose(best, float(losses.min()), rtol=1e-6)
    again, _ = pr.fit_continuation_mlp(_gen(7), X, y, w, cfg)
    assert all(torch.equal(a, b) for a, b in zip(net.parameters(), again.parameters()))


def test_policy_targets_match_reference():
    rng = np.random.default_rng(8)
    imm = (rng.uniform(size=(6, 64)) * 5.0).astype(np.float32)
    imm[rng.uniform(size=imm.shape) < 0.3] = 0.0
    cont = (rng.uniform(size=(6, 64)) * 5.0).astype(np.float32)
    term = (rng.uniform(size=64) * 5.0).astype(np.float32)
    got = pa._policy_targets(_t(imm), _t(cont), _t(term), np.float32(0.97))
    want = ja._policy_targets(imm, cont, term, np.float32(0.97))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("stride", [1, 2])
def test_stopped_cash_matches_reference(stride):
    rng = np.random.default_rng(9 + stride)
    n_steps = 9
    imm = (rng.uniform(size=(n_steps - 1, 128)) * 4.0).astype(np.float32)
    imm[rng.uniform(size=imm.shape) < 0.4] = 0.0
    cont = (rng.uniform(size=imm.shape) * 4.0).astype(np.float32)
    term = (rng.uniform(size=128) * 4.0).astype(np.float32)
    js, spec = _spec(0.2)
    got = pa._nn_stopped_cash(_t(imm), _t(cont), _t(term), torch.arange(1, n_steps), spec,
                              T, n_steps, exercise_stride=stride)
    want = ja._nn_stopped_cash(imm, cont, term, jnp.arange(1, n_steps), js, T, n_steps,
                               exercise_stride=stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("case", ["gbm", "heston", "gbm_oos", "no_baseline"])
def test_nn_continuation_deterministic_part_matches_reference(xla_paths, case):
    """Features, weights, standardization, baseline and first-fit targets,
    through return_net's (x_mean, x_std, y_mean, y_std, has_baseline) with
    one policy iteration (later targets depend on the trained net)."""
    model = "heston" if case == "heston" else "gbm"
    S, v = xla_paths[model]
    js, spec = _spec(None if case in ("heston", "no_baseline") else 0.2)
    jl, lsm = _lsm(nn_policy_iters=1, nn_epochs=1)
    mask = None
    if case == "gbm_oos":
        mask = np.asarray(ja.oos_masks(S.shape[1], 1024)[0])
    out_j = ja._nn_continuation(jax.random.key(0), S, js, T, jl, v, mask, return_net=True,
                                heston=J_HESTON if v is not None else None)
    out = pa._nn_continuation(3, _t(S), spec, T, lsm, None if v is None else _t(v),
                              None if mask is None else _t(mask), return_net=True,
                              heston=HESTON if v is not None else None)
    for got, want in zip(out[:4:2], out_j[:4:2]):          # immediate, terminal
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert torch.equal(out[3], _t(np.asarray(out_j[3])))   # ts
    (_, xm, xs, ym, ys, has_b), (_, xm_j, xs_j, ym_j, ys_j, has_b_j) = out[4], out_j[4]
    assert has_b == has_b_j == (case != "no_baseline")
    assert xm.shape == (8 if v is not None else 7,)
    np.testing.assert_allclose(xm.numpy(), np.asarray(xm_j), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(xs.numpy(), np.asarray(xs_j), rtol=1e-5)
    np.testing.assert_allclose(float(ys), float(ys_j), rtol=1e-5)
    # the residual mean is small against its spread: f32 sums in another order
    np.testing.assert_allclose(float(ym), float(ym_j), rtol=0, atol=1e-5 * float(ys_j))
    assert out[1].shape == out[0].shape and bool(torch.isfinite(out[1]).all())


def _agree(p, se, p_j, se_j):
    gap = abs(float(p) - float(p_j))
    assert gap <= 3.0 * max(float(se), float(se_j)) + 0.01 * abs(float(p_j)), (
        float(p), float(se), float(p_j), float(se_j))


@pytest.mark.parametrize("model", ["gbm", "heston"])
def test_lsm_nn_backward_matches_reference_on_identical_paths(xla_paths, model):
    S, v = xla_paths[model]
    js, spec = _spec(0.2 if model == "gbm" else None)
    jl, lsm = _lsm()
    hj, hp = (J_HESTON, HESTON) if model == "heston" else (None, None)
    p, se = pa.lsm_nn_backward(5, _t(S), spec, T, lsm, stat_pair_block=2048,
                               v_paths=None if v is None else _t(v), heston=hp)
    p_j, se_j = ja.lsm_nn_backward(jax.random.key(5), S, js, T, jl, stat_pair_block=2048,
                                   v_paths=v, heston=hj)
    assert p.dtype == torch.float32 and 0 < float(se) < 0.2
    _agree(p, se, p_j, se_j)
    # out of sample: the eval mask is the complement of the training blocks
    p_o, se_o, (cash, mask) = pa.lsm_nn_backward(
        5, _t(S), spec, T, lsm, stat_pair_block=2048, v_paths=None if v is None else _t(v),
        out_of_sample=True, pair_block=2048, return_cash=True, heston=hp)
    assert float(mask.sum()) == 2048 and bool((mask[:2048] == 0).all())
    _agree(p_o, se_o, p_j, se_j)
    with pytest.raises(ValueError, match="pair_block"):
        pa.lsm_nn_backward(5, _t(S), spec, T, lsm, out_of_sample=True)


@pytest.mark.parametrize("model", ["gbm", "merton", "heston"])
def test_richardson_nn_stat_matches_reference_on_identical_paths(xla_paths, model):
    """The NN Richardson statistic's price on the same paths. Merton takes
    no control variate here, as in the reference: through the dispatcher,
    its price and stderr with the CV on are those with it off, bit for
    bit."""
    S, v = xla_paths[model]
    js, spec = _spec(None if model == "heston" else 0.2)
    jl, lsm = _lsm()
    hj, hp = (J_HESTON, HESTON) if model == "heston" else (None, None)
    stat, mask = pa.richardson_nn_stat(6, _t(S), None if v is None else _t(v), spec, T, lsm,
                                       heston=hp, model=model, pair_block=2048)
    stat_j, mask_j = ja.richardson_nn_stat(jax.random.key(6), S, v, js, T, jl, heston=hj,
                                           model=model, pair_block=2048)
    assert stat.shape == (S.shape[1],) and bool((mask == 1).all())
    p, se, _ = masked_mean_stderr(stat, mask, 2048)
    p_j, se_j = float(jnp.mean(stat_j)), float(jnp.std(stat_j)) / np.sqrt(S.shape[1] / 2)
    _agree(p, se, p_j, se_j)
    if model == "merton":
        on, off = (pa.price_american_richardson(torch.Generator().manual_seed(6), S0, T, spec,
                                                MC, _lsm(use_control_variate=cv)[1], model,
                                                merton=MERTON, device="cpu")
                   for cv in (True, False))
        assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])


@pytest.mark.parametrize("model", ["gbm", "heston"])
def test_price_american_routes_nn(model):
    """The dispatcher prices regressor='nn' under CV, Richardson and plain
    LSM, as the JAX dispatcher routes it; the fit seed is the generator's
    second draw, after the simulation's."""
    _, spec = _spec(0.2 if model == "gbm" else None)
    _, lsm = _lsm()
    kw = dict(heston=HESTON if model == "heston" else None, device="cpu")
    args = (100.0, T, spec, MC)
    p, se = pa.price_american(_gen(1), *args, lsm, model, **kw)
    p_cv, se_cv = pa.price_american_with_control_variate(_gen(1), *args, lsm, model, **kw)
    assert float(p) == float(p_cv) and float(se) == float(se_cv)
    assert np.isfinite(float(p)) and 0 < float(se) < 0.2
    plain = LSMConfig(**{**vars(lsm), "use_control_variate": False})
    p_l, se_l = pa.price_american(_gen(1), *args, plain, model, **kw)
    g = _gen(1)
    S_v = pa.simulate_paths(g, 100.0, T, MC, model, sigma=spec.sigma, rate=0.05,
                            heston=kw["heston"], return_variance=model == "heston",
                            device="cpu")
    S, v = S_v if model == "heston" else (S_v, None)
    want = pa.lsm_nn_backward(seed_from_generator(g), S, spec, T, plain,
                              stat_pair_block=4096, v_paths=v, pair_block=4096,
                              heston=kw["heston"])
    assert float(p_l) == float(want[0]) and float(se_l) == float(want[1])
    rich = LSMConfig(**{**vars(lsm), "richardson": True})
    p_r, se_r = pa.price_american(_gen(1), *args, rich, model, **kw)
    assert (float(p_r), float(se_r)) == tuple(
        float(x) for x in pa.price_american_richardson(_gen(1), *args, rich, model, **kw))
    for x in (p_l, se_l, p_r, se_r):
        assert np.isfinite(float(x))


def test_cashflow_statistics_matches_reference():
    rng = np.random.default_rng(12)
    cash = np.maximum(rng.normal(1.0, 2.0, 777), 0.0).astype(np.float32)
    mask = (rng.uniform(size=777) > 0.5).astype(np.float32)
    for m in (None, mask):
        got = cashflow_statistics(_t(cash), None if m is None else _t(m))
        want = j_cashflow_statistics(cash, m)
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("regressor", ["poly", "nn"])
def test_price_american_with_stats(regressor):
    _, spec = _spec(0.2)
    _, lsm = _lsm(regressor=regressor)
    price, se, stats = pa.price_american_with_stats(_gen(2), 100.0, T, spec, MC, lsm, "gbm",
                                                    device="cpu")
    assert np.isfinite(float(price)) and float(se) > 0
    assert all(isinstance(v, float) for v in stats.values())
    assert stats["min"] <= stats["mean"] <= stats["max"] and stats["n"] == MC.n_paths
    assert 0.2 < stats["p_worthless"] < 1.0     # an ATM put: many paths expire worthless
    p_l, se_l = pa.price_american_lsm(_gen(2), 100.0, T, spec, MC, lsm, "gbm", device="cpu")
    assert float(price) == float(p_l) and float(se) == float(se_l)
