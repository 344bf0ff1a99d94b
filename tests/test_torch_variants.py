"""The kernel-4 store/exp/layout variants (ops/cuda_heston_variants, the
port of TPU kernels 9 and 10) and utils/profiling, held against the JAX
package on the CPU.

- Zero normals: the JAX experiment kernels of scripts/exp_paths_kernel.py
  and scripts/exp_fullpath_layout.py run in TPU interpret mode, which draws
  zero bits, so they give the deterministic skeleton; the port's plain
  variants on zero normals must give the same matrix (rtol 1e-6, as
  tests/test_torch_kernels.py holds kernel 4). The scripts take no
  interpret flag, so ``pl.pallas_call`` is wrapped for the test.
- Only ``_make_paths_fn(rows, "batched", U)`` and ``_make_storeless`` still
  run in the reference: its per_step_exp, bulk_exp and no_exp modes and
  ``_make_strided`` / ``_make_contig`` store one step per ``emit`` call,
  while ``_heston_body`` now hands each emit a stacked (unroll, rows, 128)
  chunk, and they raise inside the script (ValueError: Invalid shape for
  swap). Those modes are held against what the scripts' own pin says they
  compute (exp_paths_kernel.py:148-156): kernel 4's matrix
  (``heston_paths_pallas``), as is or as exp(log S0 + out) for the log-only
  form, in the flat or blocked layout.
- On the Philox stream each plain variant is kernel 4's plain version
  (``cuda_heston.heston_paths_reference``) rearranged: bit-equal layouts,
  the storeless S_T equal to the last row, the log-only form within rtol
  1e-6 after exp, and ``first_tile`` chunks equal to the full run's slice.
- On a CPU tensor both designs' wrappers (``heston_variant``, csrc/
  paths_variants.cu; ``heston_variant_accurate``, csrc/heston_variants.cu)
  are the plain version; without CUDA both raise.
- The experiment scripts pin and time the redesign against kernel 4 as the
  pricers run it (``cuda_heston.heston_paths``); only their first-design
  row reaches ``heston_paths_accurate`` and ``heston_variant_accurate``.
"""

import functools
import importlib.util
import logging
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from options_model_tpu.core.config import HestonParams as JHestonParams
from options_model_tpu.ops.pallas_heston import heston_paths_pallas
from options_model_tpu.utils import profiling as j_profiling
from options_model_tpu_torch.core.config import HestonParams
from options_model_tpu_torch.models.heston import heston_constants
from options_model_tpu_torch.ops import cuda_heston, cuda_heston_variants as hv
from options_model_tpu_torch.scripts import exp_fullpath_layout, exp_paths_kernel
from options_model_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
J_HESTON = JHestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
HESTON = HestonParams.from_reference(vars(J_HESTON))
S0, R, T = 100.0, 0.05, 1.0
N_STEPS = 20          # a multiple of every unroll (1, 2, 4, 10)
TILE = 4096


def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """Every pl.pallas_call in TPU interpret mode (zero random bits)."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=pltpu.InterpretParams()))


def _zeros(n):
    return torch.zeros((N_STEPS, n), dtype=torch.float32)


def _zero_variant(exp_mode, layout, tile=TILE):
    return hv.heston_variant_from_normals(_zeros(tile), _zeros(tile), S0, R, T, HESTON,
                                          exp_mode, layout, tile)


@pytest.mark.parametrize("unroll", [2, 4])
def test_batched_stores_zero_normals_match_interpret_script(interpret, unroll):
    fn = _load_script("exp_paths_kernel")._make_paths_fn(32, "batched", unroll)
    S_j = np.asarray(fn(7, S0, R, T, J_HESTON, TILE, N_STEPS))
    S = _zero_variant("bulk", "flat")
    assert S.shape == S_j.shape == (N_STEPS + 1, TILE)
    np.testing.assert_allclose(S.numpy(), S_j, rtol=1e-6)


def test_storeless_zero_normals_match_interpret_script(interpret):
    fn = _load_script("exp_fullpath_layout")._make_storeless(32)
    ST_j = np.asarray(fn(7, S0, R, T, J_HESTON, TILE, N_STEPS))
    ST = _zero_variant("per_step", "terminal")
    assert ST.shape == ST_j.shape == (TILE,)
    np.testing.assert_allclose(ST.numpy(), ST_j, rtol=1e-6)


@pytest.mark.parametrize("exp_mode,layout", [("per_step", "flat"), ("bulk", "flat"),
                                             ("none", "flat"), ("bulk", "blocked")])
def test_modes_failing_in_the_reference_match_kernel4_on_zero_normals(exp_mode, layout):
    """per_step_exp, bulk_exp, no_exp, _make_strided (flat, bulk exp) and
    _make_contig (blocked, bulk exp): kernel 4's matrix, the log-only form
    as exp(log(100) + out) with row 0 = 0, as the scripts' pin states."""
    S_j = np.asarray(heston_paths_pallas(7, S0, R, T, J_HESTON, 2 * TILE, N_STEPS,
                                         interpret=True))
    out = hv.heston_variant_from_normals(_zeros(2 * TILE), _zeros(2 * TILE), S0, R, T,
                                         HESTON, exp_mode, layout, TILE)
    if layout == "blocked":
        assert out.shape == (2, N_STEPS + 1, TILE)
        out = out.permute(1, 0, 2).reshape(N_STEPS + 1, -1)
    if exp_mode == "none":
        assert bool((out[0] == 0).all())
        out = torch.exp(math.log(100.0) + out)
    np.testing.assert_allclose(out.numpy(), S_j, rtol=1e-6)


@pytest.mark.parametrize("exp_mode,layout,unroll", hv.VARIANTS)
def test_plain_variant_is_kernel4_plain_rearranged(exp_mode, layout, unroll):
    args = (21, S0, R, T, HESTON, 2 * TILE, N_STEPS)
    k4 = cuda_heston.heston_paths_reference(*args, device="cpu")
    out = hv.heston_variant_reference(*args, exp_mode, layout, unroll, device="cpu")
    if layout == "blocked":
        assert out.shape == (2, N_STEPS + 1, TILE)
        out = out.permute(1, 0, 2).reshape(N_STEPS + 1, -1)
    want = k4[-1] if layout == "terminal" else k4
    if exp_mode == "none":
        log_s0 = float(heston_constants(S0, R, T, HESTON, N_STEPS)["log_s0"])
        np.testing.assert_allclose(torch.exp(log_s0 + out).numpy(), want.numpy(), rtol=1e-6)
    else:
        assert torch.equal(out, want)
    # a run at first_tile 1 is tile 1 of the two-tile run
    part = hv.heston_variant_reference(21, S0, R, T, HESTON, TILE, N_STEPS, exp_mode,
                                       layout, unroll, first_tile=1, device="cpu")
    full = hv.heston_variant_reference(*args, exp_mode, layout, unroll, device="cpu")
    tail = full[:, TILE:] if layout == "flat" else full[1:] if layout == "blocked" else full[TILE:]
    assert torch.equal(part, tail)


def test_smaller_tile_draws_its_own_stream():
    """Tile 2048 (16 rows on the TPU) keys the stream by its own tiles: same
    shape, other draws, mirrors within each 2048-path tile."""
    a = hv.heston_variant_reference(3, S0, R, T, HESTON, 4096, 4, "bulk", "flat", 4,
                                    tile=2048, device="cpu")
    b = hv.heston_variant_reference(3, S0, R, T, HESTON, 4096, 4, "bulk", "flat", 4,
                                    device="cpu")
    assert a.shape == b.shape == (5, 4096) and not torch.equal(a, b)
    # step 1's log-return is c + d z on a path and c - d z on its mirror
    r1 = torch.log(a[1] / a[0]).double()
    pair_sum = r1[:1024] + r1[1024:2048]
    assert float(pair_sum.std()) < 1e-6 * float(r1.abs().max())


def test_cpu_wrapper_is_the_plain_version_and_checks_its_arguments():
    args = (5, S0, R, T, HESTON, 5000, 8)
    got = hv.heston_variant(*args, "bulk", "blocked", 2, device="cpu")
    assert got.shape == (2, 9, TILE)
    assert torch.equal(got, hv.heston_variant_reference(*args, "bulk", "blocked", 2,
                                                        device="cpu"))
    with pytest.raises(ValueError, match="multiple of unroll"):
        hv.heston_variant(*args, "bulk", "flat", 10, device="cpu")
    with pytest.raises(ValueError, match="no variant"):
        hv.heston_variant(*args, "none", "terminal", 1, device="cpu")
    with pytest.raises(ValueError, match="tile"):
        hv.heston_variant(*args, "bulk", "flat", 1, tile=1000, device="cpu")
    assert sum(hv.launches.values()) == 0


def test_variant_wrapper_refuses_a_cuda_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py covers the variants")
    with pytest.raises((RuntimeError, ValueError)):
        hv.heston_variant(1, S0, R, T, HESTON, 4096, 4, device="cuda")


@pytest.mark.parametrize("exp_mode,layout,unroll", [("bulk", "blocked", 2), ("none", "flat", 1),
                                                    ("per_step", "terminal", 1)])
def test_cpu_first_design_wrapper_is_the_plain_version(exp_mode, layout, unroll):
    args = (5, S0, R, T, HESTON, 5000, 8, exp_mode, layout, unroll)
    got = hv.heston_variant_accurate(*args, device="cpu")
    assert torch.equal(got, hv.heston_variant_reference(*args, device="cpu"))
    assert torch.equal(got, hv.heston_variant(*args, device="cpu"))
    assert sum(hv.launches.values()) == 0


@pytest.mark.parametrize("device", ["cuda", None], ids=["cuda", "no_device"])
@pytest.mark.parametrize("fn", [hv.heston_variant, hv.heston_variant_accurate],
                         ids=["redesign", "first_design"])
def test_variant_wrappers_raise_without_cuda(fn, device):
    """A CUDA device, or none (the card by default), goes to the kernel or
    raises; neither falls back to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py covers the variants")
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(1, S0, R, T, HESTON, 4096, 4, device=device)
    assert sum(hv.launches.values()) == 0


@pytest.mark.parametrize("script", [exp_paths_kernel, exp_fullpath_layout])
def test_experiment_entry_points_raise_without_a_card(script):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs the experiments")
    with pytest.raises(RuntimeError, match="CUDA"):
        script.main()


def test_experiment_sets_are_the_scripts_own():
    """Each script's set at its own shape, every variant built, and one
    first-design row: its old headline (9: B bulk exp; 10: C blocked)."""
    assert (exp_paths_kernel.N_PATHS, exp_paths_kernel.N_STEPS) == (1 << 19, 100)
    assert (exp_fullpath_layout.N_PATHS, exp_fullpath_layout.N_STEPS) == (1 << 20, 100)
    built = set(hv.VARIANTS)
    assert exp_paths_kernel.VARIANTS[0][1:] == (None, 1, 4096, False)
    for _, e, u, tile, _ in exp_paths_kernel.VARIANTS[1:]:
        assert (e, "flat", u) in built and N_STEPS % u == 0 and tile in (2048, 4096)
    for _, layout, tile, _, _ in exp_fullpath_layout.VARIANTS:
        assert ("per_step" if layout == "terminal" else "bulk", layout, 1) in built
        assert tile // 128 in (32, 64, 128, 256)
    first_9 = [v[1:4] for v in exp_paths_kernel.VARIANTS if v[-1]]
    first_10 = [v[1:4] for v in exp_fullpath_layout.VARIANTS if v[-1]]
    assert first_9 == [("bulk", 1, 4096)] and first_10 == [("blocked", 4096, False)]


def _counting(monkeypatch, module, names):
    """Wrap ``module``'s functions ``names`` to count their calls."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(module, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("script", [exp_paths_kernel, exp_fullpath_layout],
                         ids=["exp_paths_kernel", "exp_fullpath_layout"])
def test_experiments_pin_and_time_against_heston_paths(monkeypatch, script):
    """The redesign's rows (and row A of experiment 9) run
    cuda_heston.heston_paths and csrc/paths_variants.cu; only the
    first-design row runs heston_paths_accurate and heston_variant_accurate.
    The pins hold on the CPU's plain versions at a small shape."""
    monkeypatch.setattr(script, "PIN_PATHS", TILE)
    monkeypatch.setattr(script, "PIN_STEPS", N_STEPS)
    k4 = _counting(monkeypatch, cuda_heston, ("heston_paths", "heston_paths_accurate"))
    var = _counting(monkeypatch, hv, ("heston_variant", "heston_variant_accurate"))
    if script is exp_paths_kernel:
        script._call(1, None, 1, TILE, TILE, 4, device="cpu")    # row A, as timed
        assert k4 == {"heston_paths": 1, "heston_paths_accurate": 0}
        for _, e, u, tile, accurate in script.VARIANTS:
            if tile == TILE:
                assert script.pin(e, u, accurate, device="cpu") <= script.LOG_RTOL
    else:
        script.pin(device="cpu")
    # one first-design pin: its variant against its kernel 4
    assert k4["heston_paths"] > 0 and k4["heston_paths_accurate"] == 1
    assert var["heston_variant"] > 0 and var["heston_variant_accurate"] == 1
    assert sum(hv.launches.values()) == 0


def test_timer_and_runtime_estimate_match_the_reference():
    with profiling.Timer("x", log=logging.getLogger("t")) as t:
        pass
    assert t.elapsed >= 0.0
    for args in ((12.0, 3, 30, 1), (12.0, 3, 30, 4), (5.0, 0, 10, 1)):
        assert profiling.estimate_total_runtime(*args) == j_profiling.estimate_total_runtime(*args)


def test_device_timers_refuse_the_host():
    """No device number from the CPU: time_per_call raises, the memory
    telemetry is empty, as the reference's is on a backend without stats."""
    assert profiling.device_memory_stats("cpu") == {}
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert profiling.device_memory_stats() == {}
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.time_per_call(lambda: None)


def test_spans_record_only_inside_a_recorder():
    with profiling.span("outside"):
        pass
    with profiling.spans() as s:
        with profiling.span("a", "cpu"):
            pass
        with profiling.span("a"):
            pass
        with profiling.span("b"):
            pass
    assert set(s) == {"a", "b"} and all(v >= 0.0 for v in s.values())
    with profiling.span("after"):
        pass
    assert "after" not in s


def test_trace_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "trace.json"
    with profiling.trace(str(path)):
        torch.ones(8).sum()
    assert path.exists() and path.stat().st_size > 0
