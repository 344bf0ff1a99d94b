"""The martingale dual of the port (pricers/dual.py, the dual's Philox stream
of ops/philox.py and the plain versions of kernels 18-19, ops/cuda_dual.py)
held against the JAX package (options_model_tpu/pricers/dual.py) on the CPU.

Paths come from the JAX package's XLA simulators, passed through numpy.
The JAX package's inner draws (its _inner_normals and _inner_poisson under
jax.random.fold_in(inner_key, date), as dual.py draws them) are fed to the
port's plain inner expectation, so both packages bound the same martingale
on the same paths, policy and draws. They agree within float32 rounding:
the port takes the powers of u as running products and its own exp, log
and erfc, and XLA contracts multiply-adds, so an inner state within an ulp
of x' = 1 can land on the other side of the surrogate's in-the-money gate
(one value of a (date, path) moves by the early-exercise premium there);
(upper, stderr) agree to DUAL_RTOL.

The brackets on the port's own stream are in tests/test_torch_dual_brackets.py.
"""

import jax
import jax.numpy as jnp
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
from options_model_tpu.pricers import american as ja
from options_model_tpu.pricers import dual as jd
from options_model_tpu_torch.core.config import (BatesParams, HestonParams, LSMConfig,
                                                  MCConfig, MertonParams, OptionSpec)
from options_model_tpu_torch.ops import cuda_dual
from options_model_tpu_torch.ops.philox import (DUAL_STREAM, box_muller, dual_calls,
                                                dual_inner_draws, poisson_from_uniform,
                                                poisson_table, stream_words, uniform_from_bits)
from options_model_tpu_torch.pricers import american as pa
from options_model_tpu_torch.pricers import dual as pd
from _torch_threads import one_torch_thread  # noqa: F401

S0, K, T, R = 100.0, 100.0, 0.5, 0.05
J_HESTON = JHestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
HESTON = HestonParams.from_reference(vars(J_HESTON))
J_MERTON = JMertonParams(sigma=0.2, lam=0.5, mu_j=-0.1, sigma_j=0.15)
MERTON = MertonParams.from_reference(vars(J_MERTON))
J_BATES = JBatesParams(heston=J_HESTON, lam=0.3, mu_j=-0.1, sigma_j=0.15)
BATES = BatesParams.from_reference(vars(J_BATES))
# 4096 paths x 12 steps in pair blocks of 1024: the parity cases.
J_MC = JMCConfig(n_paths=4096, n_steps=12, path_block=1024)
PB = 1024
N_INNER = 8
# (upper, stderr) of the two packages on the same paths, policy and draws:
# float32 rounding of ~10^5 surrogate evaluations, and the rare gate flip
# of the module docstring (measured: within 3.5e-7 in every case, x86-64).
DUAL_RTOL = 2e-6
SPECS = {
    "put": JOptionSpec(strike=K, rate=R, cp=PUT, sigma=0.2),
    "call_div": JOptionSpec(strike=K, rate=R, cp=1.0, sigma=0.2, div_yield=0.03),
    "sv_put": JOptionSpec(strike=K, rate=R, cp=PUT, sigma=None),
}
CASES = {  # name: (model, spec)
    "gbm_put": ("gbm", "put"), "gbm_call_div": ("gbm", "call_div"),
    "heston": ("heston", "sv_put"), "merton": ("merton", "put"), "bates": ("bates", "sv_put"),
}


def _port(spec: JOptionSpec) -> OptionSpec:
    return OptionSpec.from_reference(vars(spec))


def _t(a):
    return torch.from_numpy(np.array(a))


# One torch intra-op thread while LSM fits run: several test workers share the
# machine, and each worker's default pool (a thread a core) oversubscribes the
# cores (ROADMAP item B).
# The tests that need it take tests/_torch_threads.py's one_torch_thread.


@pytest.fixture(scope="module")
def xla_paths():
    """The JAX XLA simulators' paths of each case's model, (S, v or None)."""
    key = jax.random.key(3)
    out = {}
    for model in ("gbm", "heston", "merton", "bates"):
        use_v = model in ("heston", "bates")
        res = ja.simulate_paths(key, S0, T, J_MC, model, sigma=0.2, rate=R, heston=J_HESTON,
                                merton=J_MERTON, bates=J_BATES, engine="xla",
                                return_variance=use_v)
        S, v = res if use_v else (res, None)
        out[model] = (np.asarray(S), None if v is None else np.asarray(v))
    return out


def _jax_draws(inner_key, model: str, n_paths: int, half: int, lam_dt):
    """The JAX package's inner draws of date i, as its dual draws them
    (dual.py:579-620, 706-735), in the port's draws dict."""
    use_v = model in ("heston", "bates")

    def at(i):
        dkey = jax.random.fold_in(inner_key, i)
        lead = (2, half) if use_v else (half,)
        z = np.asarray(jd._inner_normals(dkey, lead, n_paths, PB, 0, jnp.float32))
        d = {"z1": _t(z[0]), "z2": _t(z[1])} if use_v else {"z": _t(z)}
        if model in ("merton", "bates"):
            d["n"] = _t(jd._inner_poisson(jax.random.fold_in(dkey, 1), (half,), n_paths, PB, 0,
                                          lam_dt, jnp.float32))
            d["zj"] = _t(jd._inner_normals(jax.random.fold_in(dkey, 2), (half,), n_paths, PB, 0,
                                           jnp.float32))
        return d

    return at


def _params(model):
    return (dict(heston=J_HESTON, merton=J_MERTON, bates=J_BATES),
            dict(heston=HESTON, merton=MERTON, bates=BATES))


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("model", ["gbm", "heston"])
def test_fit_lsm_policy_matches_jax_float64(xla_paths, model):
    """betas, x_mean, x_rstd (v_mean, v_rstd) of both packages in float64,
    dates in forward order, to 1e-9."""
    S, v = xla_paths[model]
    spec = SPECS["sv_put" if model == "heston" else "put"]
    with jax.enable_x64(True):
        pol, cash = jd.fit_lsm_policy(jnp.asarray(S, jnp.float64), spec, T,
                                      v_paths=None if v is None else jnp.asarray(v, jnp.float64))
        want = [None if a is None else np.asarray(a) for a in pol] + [np.asarray(cash)]
    got_pol, got_cash = pd.fit_lsm_policy(_t(S).double(), _port(spec), T,
                                          v_paths=None if v is None else _t(v).double())
    for name, g, w in zip(pd.LSMPolicy._fields + ("cash",), list(got_pol) + [got_cash], want):
        assert (g is None) == (w is None), name
        if w is not None:
            assert g.dtype == torch.float64
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-9, atol=1e-9, err_msg=name)
    assert got_pol.betas.shape == (J_MC.n_steps - 1, 8 if v is not None else 5)
    # forward order: date 1's ITM spread is narrower than the last date's
    assert float(got_pol.x_rstd[0]) > float(got_pol.x_rstd[-1])


@pytest.mark.parametrize("model,oos", [("gbm", False), ("heston", False), ("gbm", True),
                                       ("bates", True)])
def test_fit_lsm_policy_cash_is_lsm_poly_backward(xla_paths, model, oos):
    """In float32 the policy fit's stopped cash is the port's own
    lsm_poly_backward's bit for bit, in sample and out of sample."""
    S, v = xla_paths[model]
    spec = _port(SPECS["sv_put" if v is not None else "put"])
    S_t, v_t = _t(S), None if v is None else _t(v)
    train = pa.oos_masks(S.shape[1], PB)[0] if oos else None
    _, cash = pd.fit_lsm_policy(S_t, spec, T, train_mask=train, v_paths=v_t)
    _, _, (cash_ref, _) = pa.lsm_poly_backward(S_t, spec, T, out_of_sample=oos, pair_block=PB,
                                               return_cash=True, v_paths=v_t)
    assert torch.equal(cash, cash_ref)


@pytest.mark.parametrize("case", list(CASES))
def test_dual_upper_matches_jax_on_shared_draws(xla_paths, case):
    """dual_upper_from_policy on the JAX package's paths, its fitted policy
    (lsm_policy_from_jax) and its inner draws equals the JAX package's
    (upper, stderr), out of sample with pair-block stderr."""
    model, spec_name = CASES[case]
    S, v = xla_paths[model]
    spec = SPECS[spec_name]
    jp, pp = _params(model)
    train, evm = ja.oos_masks(S.shape[1], PB)
    pol, _ = jd.fit_lsm_policy(jnp.asarray(S), spec, T, train_mask=train,
                               v_paths=None if v is None else jnp.asarray(v))
    inner_key = jax.random.key(17)
    kw = dict(n_inner=N_INNER, model=model, eval_mask=evm, stat_pair_block=PB, inner_block=PB)
    up, se = jd.dual_upper_from_policy(inner_key, jnp.asarray(S), spec, T, pol,
                                       v_paths=None if v is None else jnp.asarray(v),
                                       **{k: jp[k] for k in ("heston", "merton", "bates")
                                          if model == k}, **kw)
    lam_dt = None
    if model in ("merton", "bates"):
        lam = (J_MERTON if model == "merton" else J_BATES).lam
        lam_dt = jnp.asarray(lam, jnp.float32) * (jnp.asarray(T, jnp.float32) / J_MC.n_steps)
    draws = _jax_draws(inner_key, model, S.shape[1], N_INNER // 2, lam_dt)
    kw["eval_mask"] = _t(evm)
    got_up, got_se = pd.dual_upper_from_policy(
        0, _t(S), _port(spec), T, pd.lsm_policy_from_jax(pol, device="cpu"),
        v_paths=None if v is None else _t(v), inner_draws=draws,
        **{k: pp[k] for k in ("heston", "merton", "bates") if model == k}, **kw)
    np.testing.assert_allclose(float(got_up), float(up), rtol=DUAL_RTOL)
    np.testing.assert_allclose(float(got_se), float(se), rtol=DUAL_RTOL)


# A tiny net for the NN dual's parity: the JAX package trains it, and its
# weights and standardization are carried across (nn_policy_from_jax).
J_NN = JLSMConfig(regressor="nn", nn_hidden=8, nn_layers=1, nn_epochs=1, nn_batch=512)
# The nets' outputs on the same weights: Flax's f32 matmuls and torch's
# differ in their sums' order, and the surrogate takes the net's value
# wherever it beats the floor (measured: within 1e-6, x86-64).
NN_DUAL_RTOL = 1e-5


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("model", ["gbm", "heston"])
def test_nn_dual_upper_matches_jax_on_shared_draws(xla_paths, model):
    """dual_upper_from_nn_policy on the JAX package's paths, its trained
    net (nn_policy_from_jax) and its inner draws equals the JAX package's
    (upper, stderr); the Heston net carries the variance feature."""
    S, v = xla_paths[model]
    spec = SPECS["sv_put" if model == "heston" else "put"]
    train, evm = ja.oos_masks(S.shape[1], PB)
    jv = None if v is None else jnp.asarray(v)
    heston = J_HESTON if model == "heston" else None
    pol, _ = jd.fit_nn_policy(jax.random.key(5), jnp.asarray(S), spec, T, J_NN,
                              train_mask=train, v_paths=jv, heston=heston)
    inner_key = jax.random.key(23)
    kw = dict(n_inner=N_INNER, model=model, eval_mask=evm, stat_pair_block=PB, inner_block=PB)
    up, se = jd.dual_upper_from_nn_policy(inner_key, jnp.asarray(S), spec, T, pol, J_NN,
                                          heston=heston, v_paths=jv, **kw)
    params = jax.tree_util.tree_map(np.asarray, pol.params)
    stats = [np.asarray(a) for a in (pol.x_mean, pol.x_std, pol.y_mean, pol.y_std)]
    policy = pd.nn_policy_from_jax(params, stats + [pol.residual], device="cpu")
    assert policy.x_mean.shape == ((8,) if model == "heston" else (7,))
    kw["eval_mask"] = _t(evm)
    got_up, got_se = pd.dual_upper_from_nn_policy(
        0, _t(S), _port(spec), T, policy, LSMConfig.from_reference(vars(J_NN)),
        heston=HESTON if model == "heston" else None, v_paths=None if v is None else _t(v),
        inner_draws=_jax_draws(inner_key, model, S.shape[1], N_INNER // 2, None), **kw)
    np.testing.assert_allclose(float(got_up), float(up), rtol=NN_DUAL_RTOL)
    np.testing.assert_allclose(float(got_se), float(se), rtol=NN_DUAL_RTOL)


@pytest.mark.parametrize("model", ["gbm", "heston", "merton", "bates"])
def test_dual_inner_draws_first_tile_chunk(model):
    """Tiles [2, 4) drawn at first_tile 2 are the full run's bit for bit
    (an odd pair count leaves a call's last pair unused); the counts are
    poisson_from_uniform's of the uniforms."""
    args = (0x9E3779B97F4A7C15,)
    full = dual_inner_draws(*args, 0, 4, 256, 5, model, 3, 0.8)
    part = dual_inner_draws(*args, 2, 2, 256, 5, model, 3, 0.8)
    assert set(full) == set(part) == ({"z"} if model in ("gbm", "merton") else {"z1", "z2"}) | (
        {"u", "n", "zj"} if model in ("merton", "bates") else set())
    for k in full:
        assert full[k].shape == (5, 1024)
        assert torch.equal(full[k][:, 512:], part[k]), k
    if "n" in full:
        assert torch.equal(full["n"], poisson_from_uniform(full["u"], poisson_table(0.8)))
        assert float(full["n"].max()) >= 2


def test_dual_inner_draws_layout():
    """The stream is counter word 3 = DUAL_STREAM at draw date x calls +
    call: GBM's pair k takes normal k of its call's two Box-Mullers,
    Heston's pair k (z1, z2) one Box-Muller, the jump calls follow the
    diffusion calls; at lam = 0 Merton's and Bates's normals are GBM's and
    Heston's bit for bit, and no count is drawn above 0."""
    seed, half, date = 12345, 6, 2
    assert dual_calls("gbm", half) == (2, 0, 5) and dual_calls("heston", half) == (3, 0, 6)
    assert dual_calls("merton", half) == (2, 3, 5) and dual_calls("bates", half) == (3, 3, 6)
    assert dual_calls("gbm", 1) == (1, 0, 2) and dual_calls("bates", 1) == (1, 1, 2)
    calls = dual_calls("merton", half)[2]
    words = stream_words(seed, 0, 1, 64, (date + 1) * calls, stream=DUAL_STREAM)
    u = [uniform_from_bits(words[date * calls + 1, i]) for i in range(4)]
    g = dual_inner_draws(seed, 0, 1, 64, half, "merton", date, 0.3)
    want = [*box_muller(u[0], u[1]), *box_muller(u[2], u[3])]
    for k in range(2):
        assert torch.equal(g["z"][4 + k], want[k])
    uj = [uniform_from_bits(words[date * calls + 2 + 1, i]) for i in range(4)]
    assert torch.equal(g["zj"][2], box_muller(uj[0], uj[1])[0])
    assert torch.equal(g["u"][3], uj[3])
    assert not torch.equal(words, stream_words(seed, 0, 1, 64, (date + 1) * calls))
    for jumpy, plain in (("merton", "gbm"), ("bates", "heston")):
        a = dual_inner_draws(seed, 0, 1, 64, half, jumpy, date, 0.0)
        b = dual_inner_draws(seed, 0, 1, 64, half, plain, date)
        for k in b:
            assert torch.equal(a[k], b[k])
        assert float(a["n"].abs().max()) == 0.0


def _small_case(model):
    """Port-stream inputs of the wrapper tests: x = S / K (and v) of the
    port's own simulation, a fitted policy's rows and the law."""
    mc = MCConfig(n_paths=2048, n_steps=6, path_block=512)
    sv = model in ("heston", "bates")
    spec = OptionSpec(strike=K, rate=R, cp=-1.0, sigma=None if sv else 0.2)
    kw = dict(heston=HESTON, merton=MERTON, bates=BATES)
    out = pa.simulate_paths(torch.Generator().manual_seed(1), S0, T, mc, model, sigma=spec.sigma,
                            rate=R, return_variance=sv, device="cpu", **kw)
    S, v = out if sv else (out, None)
    policy, _ = pd.fit_lsm_policy(S, spec, T, v_paths=v)
    law = pd.inner_law(model, spec, T, mc.n_steps, **kw)
    rows = cuda_dual.policy_rows(policy, torch.from_numpy(pd.date_taus(T, mc.n_steps)))
    return S / K, v, rows, law


@pytest.mark.parametrize("model", ["gbm", "heston", "merton", "bates"])
def test_dual_wrappers_on_cpu(model):
    """On CPU tensors both wrappers are their plain versions: kernel 18's ce
    is the surrogate's mean over kernel 19's states of the same stream, a
    first_tile chunk is the full run's slice bit for bit, the counts are the
    draws', and a tensor on another device goes to the kernels and raises."""
    x, v, rows, law = _small_case(model)
    args = (0xABCDEF, 0, 512, 6)
    ce = cuda_dual.dual_ce(x, v, rows, law, *args)
    assert torch.equal(ce, cuda_dual.dual_ce_reference(x, v, rows, law, *args))
    assert ce.shape == (rows.shape[0], x.shape[1]) and bool(torch.isfinite(ce).all())
    part = cuda_dual.dual_ce(x[:, 1024:].contiguous(), None if v is None else v[:, 1024:]
                             .contiguous(), rows, law, 0xABCDEF, 2, 512, 6)
    assert torch.equal(ce[:, 1024:], part)
    xs, vs, counts = cuda_dual.dual_inner_states(x, v, law, *args, 1, 3, return_counts=True)
    assert xs.shape == (3, 2, 3, x.shape[1]) and (vs is None) == (v is None)
    degree = rows.shape[1] - pd.ROW_HEAD - (5 if law.use_v else 2)
    for c in range(3):
        t, row = 1 + c, rows[1 + c]
        vals = pd._vhat(xs[c], law.K, law.cp, row[0], law.rate, law.q,
                        pd._floor_vol(law, None if vs is None else vs[c], row[0]),
                        row[pd.ROW_HEAD:], row[1], row[2], degree,
                        v=None if vs is None else vs[c], vm=row[3], vr=row[4])
        torch.testing.assert_close((vals[0] + vals[1]).mean(0) * 0.5, ce[t], rtol=1e-6, atol=0)
        n = dual_inner_draws(0xABCDEF, 0, x.shape[1] // 512, 512, 3, model, t,
                             law.lam_dt).get("n")
        assert torch.equal(counts[c], torch.zeros_like(counts[c]) if n is None
                           else n.to(torch.int32))
    meta = x.to("meta")
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_dual.dual_ce(meta, None if v is None else v.to("meta"), rows, law, *args)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_dual.dual_inner_states(meta, None if v is None else v.to("meta"), law, *args, 0, 1)


def test_law_and_rows_layout():
    """The kernels' host constants are csrc/dual.cu DualT's: the law's
    fields in LAW_FIELDS order, the Poisson table's length, the table
    zero-padded; the policy rows carry tau and the standardization ahead of
    the betas; Merton's diffusion vol is merton.sigma, not spec.sigma."""
    spec = OptionSpec(strike=K, rate=R, cp=-1.0, sigma=0.35)
    law = pd.inner_law("merton", spec, T, 50, merton=MERTON)
    f = np.float32
    dt = f(T) / f(50)
    assert law.a == float(f(0.2) * np.sqrt(dt)) and law.lam_dt == float(f(0.5) * dt)
    vals = np.ctypeslib.as_array(cuda_dual.law_args(law))
    table = poisson_table(law.lam_dt)
    assert vals.size == len(cuda_dual.LAW_FIELDS) + 1 + 120
    assert vals[:len(cuda_dual.LAW_FIELDS)].tolist() == [getattr(law, k)
                                                         for k in cuda_dual.LAW_FIELDS]
    assert vals[len(cuda_dual.LAW_FIELDS)] == table.size
    assert np.array_equal(vals[len(cuda_dual.LAW_FIELDS) + 1:][:table.size], table)
    assert not vals[len(cuda_dual.LAW_FIELDS) + 1 + table.size:].any()
    pol = pd.LSMPolicy(torch.arange(10.0).reshape(2, 5), torch.tensor([1.0, 2.0]),
                       torch.tensor([3.0, 4.0]))
    rows = cuda_dual.policy_rows(pol, torch.tensor([0.4, 0.2]))
    assert torch.equal(rows, torch.tensor([[0.4, 1.0, 3.0, 0.0, 0.0, 0, 1, 2, 3, 4],
                                           [0.2, 2.0, 4.0, 0.0, 0.0, 5, 6, 7, 8, 9]]))
    with pytest.raises(ValueError, match="gbm, heston, merton or bates"):
        dual_calls("vg", 4)


def _gbm_inputs():
    mc = MCConfig(n_paths=2048, n_steps=6, path_block=512)
    spec = OptionSpec(strike=K, rate=R, cp=-1.0, sigma=0.2)
    S = pa.simulate_paths(torch.Generator().manual_seed(2), S0, T, mc, "gbm", sigma=0.2, rate=R,
                          device="cpu")
    return S, spec, pd.fit_lsm_policy(S, spec, T)[0]


def test_validation_errors():
    """The reference's checks, with its messages (tests/test_dual.py)."""
    S, spec, policy = _gbm_inputs()
    bad = pd.LSMPolicy(torch.zeros(3, 5), torch.zeros(3), torch.ones(3))
    with pytest.raises(ValueError, match="dates"):
        pd.dual_upper_from_policy(0, S, spec, T, bad)
    with pytest.raises(ValueError, match="n_inner"):
        pd.dual_upper_from_policy(0, S, spec, T, policy, n_inner=7)
    with pytest.raises(ValueError, match="model must be"):
        pd.dual_upper_from_policy(0, S, spec, T, policy, model="cir")
    sv = OptionSpec(strike=K, rate=R, cp=-1.0, sigma=None)
    with pytest.raises(ValueError, match="sigma"):
        pd.price_american_bracket(torch.Generator(), S0, T, sv, MCConfig(4096, 10, 1024),
                                  device="cpu")
    with pytest.raises(ValueError, match="heston"):
        pd.price_american_bracket(torch.Generator(), S0, T, sv, MCConfig(4096, 10, 1024),
                                  model="heston", device="cpu")
    with pytest.raises(ValueError, match="nn-policy"):
        pd.price_american_bracket(torch.Generator(), S0, T, spec, MCConfig(4096, 10, 1024),
                                  model="merton", merton=MERTON,
                                  lsm=LSMConfig(regressor="nn"), device="cpu")
    with pytest.raises(ValueError, match="out_of_sample"):
        pd.price_american_bracket(torch.Generator(), S0, T, spec, MCConfig(1024, 4, 1024),
                                  device="cpu")
    v = torch.full_like(S, 0.04)
    with pytest.raises(ValueError, match="v_paths"):  # a policy fitted without v
        pd.dual_upper_from_policy(0, S, sv, T, policy, model="heston", heston=HESTON, v_paths=v)
    pol_v, _ = pd.fit_lsm_policy(S, sv, T, v_paths=v)
    with pytest.raises(ValueError, match="sigma"):  # spec.sigma under Heston
        pd.dual_upper_from_policy(0, S, spec, T, pol_v, model="heston", heston=HESTON, v_paths=v)
    net7 = pd.NNPolicy(pd.ContinuationMLP(7, 4, 1), torch.zeros(7), torch.ones(7),
                       torch.tensor(0.0), torch.tensor(1.0))
    with pytest.raises(ValueError, match="variance feature"):
        pd.dual_upper_from_nn_policy(0, S, sv, T, net7, model="heston", heston=HESTON,
                                     v_paths=v)
    with pytest.raises(ValueError, match="model must be 'gbm' or 'heston'"):
        pd.dual_upper_from_nn_policy(0, S, spec, T, net7, model="merton")
    with pytest.raises(ValueError, match="inner_block"):
        pd.dual_upper_from_policy(0, S, spec, T, policy, inner_block=3000)
    with pytest.raises(RuntimeError, match="CUDA"):  # the card by default, never the CPU
        pd.price_american_bracket(torch.Generator(), S0, T, spec, MCConfig(4096, 10, 1024))


@pytest.mark.parametrize("model", ["vg", "sabr", "rbergomi"])
def test_unported_families_raise(model):
    """VG, SABR and rBergomi are ROADMAP item 3: not_ported, naming the JAX
    function; so is the path-sharded dual (axis_name)."""
    S, spec, policy = _gbm_inputs()
    with pytest.raises(NotImplementedError, match="pricers.dual.dual_upper_from_policy"):
        pd.dual_upper_from_policy(0, S, spec, T, policy, model=model)
    params = {model: object()}
    with pytest.raises(NotImplementedError, match="pricers.dual.price_american_bracket"):
        pd.price_american_bracket(torch.Generator(), S0, T, spec, MCConfig(4096, 10, 1024),
                                  model=model, device="cpu", **params)
    with pytest.raises(NotImplementedError, match="axis_name"):
        pd.dual_upper_from_policy(0, S, spec, T, policy, axis_name="paths")
    with pytest.raises(NotImplementedError, match="axis_name"):
        pd.fit_lsm_policy(S, spec, T, axis_name="paths")
