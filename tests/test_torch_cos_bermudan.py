"""The port's NumPy copy of the COS-Bermudan oracle (pricers/cos_bermudan.py)
against the JAX package's, on the port's MertonParams / VGParams and the
reference's: the same float64 NumPy arithmetic, so the two agree to 1e-12
for GBM, Merton and VG at 1, 16 and 50 exercise dates, Bermudan and
American (the Richardson ladder M, 2M, 4M). The parity runs at 64 cosine
terms (N_TERMS), where the default 512 costs ~N^2 per date (the American
ladder at 50 dates is 350 dates): the code path is the same at every N,
and the M = 1 limit is also held at the default against the closed
forms."""

import numpy as np
import pytest

from options_model_tpu.core.config import MertonParams as JMertonParams
from options_model_tpu.core.config import VGParams as JVGParams
from options_model_tpu.pricers import cos_bermudan as jcos
from options_model_tpu_torch.core.config import MertonParams, VGParams
from options_model_tpu_torch.pricers import cos_bermudan as tcos

MERTON = dict(sigma=0.2, lam=1.0, mu_j=-0.10, sigma_j=0.15)
VG = dict(sigma=0.12, theta=-0.14, nu=0.2)
N_TERMS = 64
MODELS = {
    "gbm": (dict(sigma=0.2), dict(sigma=0.2)),
    "merton": (dict(merton=MertonParams(**MERTON)), dict(merton=JMertonParams(**MERTON))),
    "vg": (dict(vg=VGParams(**VG)), dict(vg=JVGParams(**VG))),
}


@pytest.mark.parametrize("n_dates", [1, 16, 50])
@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("fn", ["cos_bermudan_price", "cos_american_price"])
def test_cos_oracle_equals_the_jax_package(fn, model, n_dates):
    port_kw, jax_kw = MODELS[model]
    # the American ladder costs 7 Bermudan prices' dates: the put alone
    cases = ((-1.0, 100.0, 0.0), (1.0, 95.0, 0.03))[:1 if fn == "cos_american_price" else 2]
    for cp, K, q in cases:
        args = (100.0, K, 0.5, 0.05, model)
        got = getattr(tcos, fn)(*args, cp=cp, q=q, n_dates=n_dates, n_terms=N_TERMS,
                                **port_kw)
        want = getattr(jcos, fn)(*args, cp=cp, q=q, n_dates=n_dates, n_terms=N_TERMS,
                                 **jax_kw)
        assert np.isfinite(got) and got > 0.0
        assert abs(got - want) <= 1e-12 * max(1.0, abs(want)), (fn, model, n_dates, cp)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_one_date_is_the_european_closed_form(model):
    """At M = 1 and the default 512 terms the oracle is the European price:
    Black-Scholes, the Merton series, or the VG COS price."""
    import torch

    from options_model_tpu_torch.calibration.charfn import vg_cos_price
    from options_model_tpu_torch.models.merton import merton_price
    from options_model_tpu_torch.pricers.blackscholes import bs_price

    got = tcos.cos_bermudan_price(100.0, 100.0, 0.5, 0.05, model, cp=-1.0, n_dates=1,
                                  **MODELS[model][0])
    kw = dict(cp=-1.0, dtype=torch.float64, device="cpu")
    want = {"gbm": lambda: bs_price(100.0, 100.0, 0.5, 0.05, 0.2, **kw),
            "merton": lambda: merton_price(100.0, 100.0, 0.5, 0.05, MertonParams(**MERTON),
                                           **kw),
            "vg": lambda: vg_cos_price(100.0, 100.0, 0.5, 0.05, VGParams(**VG), n_terms=2048,
                                       **kw)}[model]()
    assert got == pytest.approx(float(want), rel=1e-6)


def test_unsupported_model_raises_as_the_reference():
    with pytest.raises(ValueError, match="unsupported model"):
        tcos.cos_bermudan_price(100.0, 100.0, 0.5, 0.05, "heston")
    with pytest.raises(ValueError, match="martingale"):
        tcos.cos_bermudan_price(100.0, 100.0, 0.5, 0.05, "vg",
                                vg=VGParams(sigma=0.5, theta=2.0, nu=1.0))
