"""Kernel 18's SABR redesign and VG's terminal redesign in the dual (csrc/dual.cu
dual_ce_sabr_kernel, dual_vg_terminal_warp_kernel) on the host, where no
kernel runs: torch mirrors of what each does differently from its first
design, held against the plain versions (ops/cuda_dual.dual_ce_reference,
dual_inner_states_reference; ops/philox.dual_gamma_draws,
pricers/dual.vg_terminal_from_gamma).

- SABR: a float32 mirror of the redesign's step on the dual stream. x' from
  the up member's product sv z1, the down member's negated: bit for bit the
  plain version's. alpha' = A e^{+-s}, A = vp exp(-nu^2 dt / 2) once a
  (date, path), e^s = 2^(fma(k1, z1, k2 z2)) with the kernel's folded
  constants, e^-s its reciprocal; torch's exact exp2 and division stand in
  for ex2.approx and rcp.approx, and two more runs move both by 2^-22
  relative (more than the two approximations' error) against each other.
  alpha' within chip_smoke.SABR_APRIME_RTOL of the plain version's
  (relative); the redesign's ce (the floor from m = (A sqrt tau) e^{+-s}
  and 1 / m, then vhat_fast's polynomial, gate and clip, each multiply-add
  a multiply and an add) within chip_smoke.DUAL_CE_ATOL of the plain ce, at
  D7's SABR(0.2, 1, -0.4, 0.6) and 40 steps, every date, a put and a call.
- VG's terminal step: a mirror of the redesign's entry map and warp
  schedule. A warp owns terminal_per_warp(half) whole paths and their
  entries q = l half + j (path l, draw j) in chunks of 256, entry e = i 32
  + lane of a chunk; it draws attempt 0 of every entry (the squeeze, as
  ops/cuda_vg.vg_decide_reference decides), queues the rest in (i, lane)
  order for the exact test, retries the exact test's rejections from a
  ring, 32 entries a pass, attempts 1-14 (the last rejection leaves d), and
  boosts each accepted d v from the tag that carries the boost word's top
  23 bits and the attempt. Each attempt's arithmetic comes from full-width
  (half, P) tensors shaped as dual_gamma_draws' (torch's vectorised log on
  the CPU may round a tail element otherwise), so what is tested is the
  schedule. G and attempts bit for bit at date n_dates, for 32, 16 and 5
  draws a path, P not a multiple of 32, gamma shapes 0.0286 (the full-width
  bracket's dt / nu) and 1.5; e_h (log x once a path, the Black step with 1 /
  a, each path's values summed in draw order) within DUAL_CE_ATOL of
  vg_terminal_from_gamma.
- chip_smoke.py's reading of the terminal redesign's SASS: its five inner
  loops by role, a warp's chunks, slots and sum passes, its instructions a
  draw from them.
The card holds the kernels themselves to the same plain versions
(chip_smoke.py R0).
"""

from collections import deque

import numpy as np
import pytest
import torch

from chip_smoke import (DUAL_CE_ATOL, PEAK_ISSUE, SABR_APRIME_RTOL, _terminal_warp_counts,
                        _vg_roles, dual_terminal_floors)
from options_model_tpu_torch.core.config import MCConfig, OptionSpec, SABRParams, VGParams
from options_model_tpu_torch.ops import cuda_dual
from options_model_tpu_torch.ops.cuda_vg import (DECIDE_REJECT, DECIDE_SQUEEZE,
                                                 vg_decide_reference)
from options_model_tpu_torch.ops.philox import (DUAL_GAMMA_STREAM, VG_MAX_ATTEMPTS,
                                                _slot_counters, box_muller, dual_gamma_draws,
                                                dual_inner_draws, gamma_constants, philox4x32,
                                                uniform_from_bits)
from options_model_tpu_torch.pricers import american as pa
from options_model_tpu_torch.pricers import dual as pd
from _torch_threads import one_torch_thread_module  # noqa: F401

SEED = 0x6A09E667F3BCC908
WARP = 32
ATTEMPT_BITS = 0x1FF         # csrc/gamma.cuh kAttemptBits
LOG2E = 1.4426950408889634   # csrc/hopper_fast.cuh kLog2e
U_CLAMP = 4.0
S0, K, T, R = 100.0, 100.0, 0.5, 0.05
D7 = (SABRParams(alpha=0.2, beta=1.0, rho=-0.4, nu=0.6), 40)

pytestmark = pytest.mark.usefixtures("one_torch_thread_module")


def _fma(a, b, c):
    """fmaf in float32: the product exact in float64, one rounding of the sum
    to float64 and one to float32 (a double rounding apart at worst)."""
    return (a.double() * b.double() + c.double()).float()


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _sabr_case(cp: float):
    """x = S / K, alpha, the policy rows and the law of a D7 bracket on the
    port's own SABR paths (1,024 x 40, CPU); a put, or a call on a dividend
    payer (q 0.03)."""
    params, n_steps = D7
    q = 0.03 if cp > 0 else 0.0
    spec = OptionSpec(strike=K, rate=R, cp=cp, sigma=None, div_yield=q)
    S, v = pa.simulate_paths(torch.Generator().manual_seed(23), S0, T,
                             MCConfig(n_paths=1024, n_steps=n_steps), "sabr", rate=R,
                             div_yield=q, return_variance=True, device="cpu", sabr=params)
    policy, _ = pd.fit_lsm_policy(S, spec, T, v_paths=v)
    rows = cuda_dual.policy_rows(policy, torch.from_numpy(pd.date_taus(T, n_steps)))
    law = pd.inner_law("sabr", spec, T, n_steps, sabr=params)
    return (S / K).contiguous(), v.contiguous(), rows, law


def _sabr_states(law, xp, vp, draws, skew: float):
    """x', alpha' and the exponents e of x' = xp e^e (2, half, P), up member
    first, as dual_ce_sabr_kernel forms them in float32, with e^s and e^-s
    (each (half, P)) and A; ``skew`` moves e^s and e^-s by (1 + skew) and
    (1 - skew)."""
    z1, z2 = draws["z1"], draws["z2"]
    sv = vp * law.sqrt_dt
    mu = (law.drift - 0.5 * (vp * vp)) * law.dt
    pr = sv * z1
    e = torch.stack([mu + pr, mu - pr])
    A = vp * torch.exp(_f32(-law.half_nu2_dt))
    ks = _f32(LOG2E) * law.nu_sqrt_dt
    k1, k2 = ks * law.rho, ks * law.rho_bar
    es = torch.exp2(_fma(k1, z1, k2 * z2))
    es, ei = es * (1.0 + skew), (1.0 / es) * (1.0 - skew)
    return xp * torch.exp(e), torch.stack([A * es, A * ei]), e, es, ei, A


def _sabr_ce(law, xp, row, x, alpha, e, es, ei, A):
    """The redesign's ce of one date from its members: the floor from m =
    (A sqrt tau) e^{+-s} and r = 1 / m (g = q r +- s m / 2), Horner's
    polynomial, the branch-free gate and clip, summed over the pairs in the
    kernel's order."""
    s = _f32(-law.cp * 0.70710678118654752)
    tau, b = row[0], row[pd.ROW_HEAD:]
    degree = b.shape[0] - 5
    c1 = _f32(0.5 * law.cp) * law.K * torch.exp(-_f32(law.q) * tau)
    c2 = _f32(0.5 * law.cp) * law.K * torch.exp(-_f32(law.rate) * tau)
    a = s * (torch.log(xp) + _f32(law.drift) * tau)
    m0 = A * torch.sqrt(tau)
    r0 = 1.0 / m0
    m, r = torch.stack([m0 * es, m0 * ei]), torch.stack([r0 * ei, r0 * es])
    q = s * e + a
    g1, g2 = q * r + (0.5 * s) * m, q * r + (-0.5 * s) * m
    floor = (c1 * x) * torch.special.erfc(g1) - c2 * torch.special.erfc(g2)
    u = torch.clamp(x * row[2] + (-row[1] * row[2]), -U_CLAMP, U_CLAMP)
    c = b[degree] * torch.ones_like(u)
    for i in range(degree - 1, -1, -1):
        c = c * u + b[i]
    xm1 = x - 1.0
    c = b[degree + 1] * torch.clamp_min(xm1, 0.0) + c
    w = torch.clamp(alpha * row[4] + (-row[3] * row[4]), -U_CLAMP, U_CLAMP)
    c = w * (b[degree + 3] * w + (b[degree + 4] * u + b[degree + 2])) + c
    h = law.K * torch.clamp_min(xm1 if law.cp > 0 else -xm1, 0.0)
    itm = xm1 >= 0.0 if law.cp > 0 else xm1 <= 0.0
    cap = torch.where(itm, law.K * x if law.cp > 0 else torch.full_like(x, law.K), 0.0)
    vals = torch.maximum(floor, torch.minimum(torch.maximum(c, h), cap))
    acc = torch.zeros_like(xp)
    for k in range(vals.shape[1]):
        acc = acc + (vals[0, k] + vals[1, k])
    return acc / vals.shape[1] * 0.5


@pytest.mark.parametrize("cp", [-1.0, 1.0])
def test_sabr_step_mirror(cp):
    """Every date of a 1,024-path D7 bracket at n_inner 64: the mirror's x'
    equal to the plain version's bit for bit; its alpha' within
    SABR_APRIME_RTOL of the plain version's, relative, with and without the
    2^-22 skew; its ce within DUAL_CE_ATOL of the plain ce
    (dual_ce_reference, date by date)."""
    x, v, rows, law = _sabr_case(cp)
    seed, tile, half = 0x5DEECE66D, 512, 32
    ref = cuda_dual.dual_ce_reference(x, v, rows, law, seed, 0, tile, 2 * half)
    xs_ref, vs_ref = cuda_dual.dual_inner_states_reference(x, v, law, seed, 0, tile, 2 * half, 0,
                                                           rows.shape[0])
    worst_v = worst_ce = 0.0
    for t in range(rows.shape[0]):
        draws = dual_inner_draws(seed, 0, x.shape[1] // tile, tile, half, "sabr", t)
        for skew in (0.0, 2.0 ** -22, -(2.0 ** -22)):
            xm, am, e, es, ei, A = _sabr_states(law, x[t], v[t], draws, skew)
            assert torch.equal(xm, xs_ref[t]), t
            worst_v = max(worst_v, float(((am - vs_ref[t]).abs() / vs_ref[t]).max()))
            got = _sabr_ce(law, x[t], rows[t], xm, am, e, es, ei, A)
            assert bool(torch.isfinite(got).all())
            worst_ce = max(worst_ce, float((got - ref[t]).abs().max()))
    assert worst_v <= SABR_APRIME_RTOL, worst_v
    assert worst_ce <= DUAL_CE_ATOL, worst_ce


class _Attempts:
    """Attempt ``att`` of every (draw, path) of one date of the dual's clock,
    full width as dual_gamma_draws computes it: (the kernel's decision, d
    v, the boost word), each (half, P)."""

    def __init__(self, seed, n_tiles, tile, half, date, a):
        k = gamma_constants(a)
        self.d, self.c, self.inv_a = (torch.tensor(k[key], dtype=torch.float32)
                                      for key in ("d", "c", "inv_a"))
        self.boost = k["boost"]
        self.j, self.g = _slot_counters(0, n_tiles, tile, None)
        self.base = (date * half + torch.arange(half)[:, None]) * VG_MAX_ATTEMPTS
        self.keys = (seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF)
        self.shape = (half, n_tiles * tile)
        self.cache = {}

    def __call__(self, att):
        if att not in self.cache:
            w0, w1, w2, w3 = (w.expand(self.shape) for w in philox4x32(
                self.j, self.base + att, self.g, DUAL_GAMMA_STREAM, *self.keys))
            x = box_muller(uniform_from_bits(w0), uniform_from_bits(w1))[0]
            dec = vg_decide_reference(x, uniform_from_bits(w2), self.d, self.c)
            v1 = 1.0 + self.c * x
            self.cache[att] = (dec, self.d * (v1 * v1 * v1), w3)
        return self.cache[att]


def terminal_schedule(seed, n_tiles, tile, half, date, a):
    """Standard gamma draws and accepting attempts (half, P) of one date as
    the terminal redesign's warps draw them (terminal_per_warp(half) paths a
    warp, chunks of CLOCK_ENTRIES entries); also each warp's passes of its
    exact tests and of its retries, and the most entries a warp's exact
    queue and ring held at once."""
    draws = _Attempts(seed, n_tiles, tile, half, date, a)
    n = n_tiles * tile
    per_warp = cuda_dual.terminal_per_warp(half)
    dec0, dv0, w30 = draws(0)
    g_all = torch.zeros((half, n), dtype=torch.float32)
    tag_all = torch.zeros((half, n), dtype=torch.int64)
    passes, most_exact, most_ring = [], 0, 0
    for p0 in range(0, n, per_warp):
        n_live = min(per_warp, n - p0)
        n_exact = n_retry = 0
        for c0 in range(0, per_warp * half, cuda_dual.CLOCK_ENTRIES):
            cs = -(-min(cuda_dual.CLOCK_ENTRIES, per_warp * half - c0) // WARP)
            q = c0 + torch.arange(cs * WARP)          # e = i 32 + lane, in order
            live = q < n_live * half
            pair, path = q % half, (p0 + q // half).clamp(max=n - 1)
            d0 = dec0[pair, path]
            g, tag = dv0[pair, path].clone(), w30[pair, path] & ~ATTEMPT_BITS
            exact = torch.nonzero((d0 != DECIDE_SQUEEZE) & live).flatten()  # push order
            most_exact = max(most_exact, len(exact))
            n_exact += -(-len(exact) // WARP)
            ring = deque(exact[d0[exact] == DECIDE_REJECT].tolist())
            most_ring = max(most_ring, len(ring))
            while ring:
                n_retry += 1
                taken = [ring.popleft() for _ in range(min(len(ring), WARP))]
                again = []
                for e in taken:
                    att = int(tag[e] & ATTEMPT_BITS) + 1
                    dec, dv, w3 = draws(att)
                    i, p = int(pair[e]), int(path[e])
                    if dec[i, p] != DECIDE_REJECT:
                        g[e], tag[e] = dv[i, p], (int(w3[i, p]) & ~ATTEMPT_BITS) | att
                    elif att + 1 < VG_MAX_ATTEMPTS:
                        tag[e] = att
                        again.append(e)
                    else:
                        g[e], tag[e] = draws.d, VG_MAX_ATTEMPTS
                ring.extend(again)
                most_ring = max(most_ring, len(ring))
            g_all[pair[live], path[live]] = g[live]
            tag_all[pair[live], path[live]] = tag[live]
        passes.append((n_exact, n_retry))
    att = (tag_all & ATTEMPT_BITS).to(torch.int32)
    gam = g_all
    if draws.boost:
        # the walk's boost, full width as dual_gamma_draws'
        boosted = torch.exp(torch.log(g_all) + torch.log(uniform_from_bits(tag_all))
                            * draws.inv_a)
        gam = torch.where(att < VG_MAX_ATTEMPTS, boosted, g_all)
    return gam, att, passes, most_exact, most_ring


def terminal_e_h(law, x_last, gamma):
    """The redesign's e_h (P,): log x once a path, each draw's Black value
    fwd erfc(g1) - erfc(g2) (g2 = (log x + mu) s / a, g1 = s a + g2, 1 / a
    exact where the kernel takes rcp.approx), each path's values summed in
    draw order, times K cp / 2 / half."""
    s = _f32(-law.cp * 0.70710678118654752)
    G = law.nu * gamma
    mu = law.mu + law.vg_theta * G
    a = law.vg_sigma * torch.sqrt(torch.clamp_min(G, 1e-20))
    g2 = (torch.log(x_last) + mu) * (s * (1.0 / a))
    fwd = x_last * torch.exp(_fma(0.5 * a, a, mu))
    vals = _fma(fwd, torch.special.erfc(_fma(s, a, g2)), -torch.special.erfc(g2))
    acc = torch.zeros_like(x_last)
    for j in range(vals.shape[0]):
        acc = acc + vals[j]
    return _f32(0.5 * law.cp * law.K) * acc / float(vals.shape[0])


def _vg_law(a: float, cp: float):
    """A VG law at T = 0.5, 50 steps, whose clock shape dt / nu is ``a``:
    the full-width bracket's VG(0.18, -0.14, 0.35) at 0.0286, a thinner
    clock at 1.5."""
    nu = 0.35 if a < 1 else 0.01 / a
    spec = OptionSpec(strike=K, rate=R, cp=cp, div_yield=0.03 if cp > 0 else 0.0)
    return pd.inner_law("vg", spec, T, 50, vg=VGParams(0.18, -0.14, nu))


@pytest.mark.parametrize("half", [32, 16, 5])
@pytest.mark.parametrize("a", [0.0286, 1.5])
def test_terminal_schedule_draws_dual_gamma_draws(a, half):
    """2 tiles of 100 paths (P = 200, not a multiple of 32, so the last warp
    holds fewer paths than the others), the clock draws of date 49: every
    gamma and accepting attempt equal to dual_gamma_draws', bit for bit;
    the retries ran, the queues stayed within a warp's CLOCK_ENTRIES; a put's
    and a call's e_h from the mirror's Black step within DUAL_CE_ATOL of
    vg_terminal_from_gamma."""
    law = _vg_law(a, -1.0)
    gam, att, passes, most_exact, most_ring = terminal_schedule(SEED, 2, 100, half, 49,
                                                                law.gamma_shape)
    want, want_att = dual_gamma_draws(SEED, 0, 2, 100, half, 49, law.gamma_shape)
    assert torch.equal(att, want_att)
    assert torch.equal(gam.view(torch.int32), want.view(torch.int32))
    assert len(passes) == -(-200 // cuda_dual.terminal_per_warp(half))
    assert sum(r for _, r in passes) > 0 and all(e >= 1 for e, _ in passes)
    assert 0 < most_exact <= cuda_dual.CLOCK_ENTRIES and most_ring <= cuda_dual.CLOCK_ENTRIES
    x_last = torch.from_numpy(np.exp(0.2 * np.random.default_rng(7).standard_normal(200))
                              .astype(np.float32))
    for cp in (-1.0, 1.0):
        law = _vg_law(a, cp)
        got = terminal_e_h(law, x_last, gam)
        assert bool(torch.isfinite(got).all())
        want_e = pd.vg_terminal_from_gamma(law, x_last, want)
        assert float((got - want_e).abs().max()) <= DUAL_CE_ATOL


def test_terminal_per_warp_and_entry_map():
    """terminal_per_warp: as many whole paths as a chunk holds, 1 to 32;
    the kernel's lane of entry q, int((q + 1/2) / half) in float32 with
    1 / half rounded, is q // half for every q < 1024 and every half up to
    MAX_PAIRS (the entries of a warp never pass 1024)."""
    assert [cuda_dual.terminal_per_warp(h) for h in (1, 5, 8, 9, 16, 32, 100, 256, 257, 1024)] \
        == [32, 32, 32, 28, 16, 8, 2, 1, 1, 1]
    for half in range(1, cuda_dual.MAX_PAIRS + 1):
        q = torch.arange(cuda_dual.terminal_per_warp(half) * half)
        assert int(q.max()) < 1024
        inv = torch.tensor(1.0, dtype=torch.float32) / half
        lane = ((q.to(torch.float32) + 0.5) * inv).to(torch.int64).clamp(max=31)
        assert torch.equal(lane, q // half), half


def test_terminal_floor_counts():
    """chip_smoke.py's reading of the terminal redesign's SASS: the five
    loops inside its chunk loop by role (the first attempts, exact tests
    and retries with a ballot, the walk and the sums without), a warp's
    chunks, slots and sum passes (_terminal_warp_counts: the longest run of
    one path's values a chunk), and its instructions a draw
    (dual_terminal_floors) from those counts and the debug instance's
    passes."""
    vote, mufu, lds = "VOTE.ANY R4, PT, P0", "MUFU.EX2 R1, R2", "LDS R1, [R2]"
    kids = [[vote, mufu], [vote], [vote, mufu], [mufu, lds], [lds]]
    assert _vg_roles("dual_vg_terminal", kids) == {
        "first attempts": 0, "exact tests": 1, "retries": 2, "walk": 3, "sums": 4}
    assert _vg_roles("dual_vg_terminal", kids[:4]) == {}
    assert _vg_roles("dual_vg_terminal, first design", [[mufu]]) == {"attempts": 0}
    assert _terminal_warp_counts(8, 32) == (1, 8, 32)
    assert _terminal_warp_counts(3, 32) == (1, 8, 32)   # every warp runs 8 paths' chunk
    assert _terminal_warp_counts(0, 32) == (1, 8, 0)
    assert _terminal_warp_counts(16, 16) == (1, 8, 16)
    assert _terminal_warp_counts(32, 5) == (1, 5, 5)
    assert _terminal_warp_counts(1, 1024) == (4, 32, 1024)
    parts = {"first attempts": 176, "exact tests": 111, "retries": 302, "walk": 227, "sums": 6}
    sass = {"nested": {"dual_vg_terminal": dict(
        parts=parts, mufu=dict.fromkeys(parts, 1), outer=911, outer_mufu=5)}}
    fl = dual_terminal_floors(sass, "dual_vg_terminal", 1 << 17, 32, [1.0, 1.5], 1.8)
    # a warp of 8 paths: 8 slots of first attempts and of the walk, 32 sum
    # passes, 1 exact and 1.5 retry passes, the rest once; 256 draws
    warp = 176 * 8 + 227 * 8 + 6 * 32 + 111 + 302 * 1.5 + (911 - 822)
    assert fl["instructions_per_draw"] == pytest.approx(32 * warp / 256)
    assert fl["issue_floor_ms"] == pytest.approx((1 << 17) * 32 * 32 * warp / 256
                                                 / PEAK_ISSUE * 1e3)
    assert dual_terminal_floors({}, "dual_vg_terminal", 1 << 17, 32, [1.0, 1.5], 1.8) == {}
