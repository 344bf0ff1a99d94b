"""Kernel 18's VG and rough Bergomi redesigns (csrc/dual.cu dual_ce_vg_kernel,
dual_ce_rough_kernel) on the host, where no kernel runs: torch mirrors of
what each does differently from the first design, held against the plain
versions (ops/philox.dual_gamma_draws, ops/cuda_dual.dual_ce_reference).

- VG: a mirror of the warp-dense clock's schedule. A warp is 32
  consecutive paths of one date; for each chunk of CHUNK pairs a lane it
  draws attempt 0 of every entry (e = i 32 + lane: pair c0 + i of path p0 +
  lane), decided by the squeeze (ops/cuda_vg.vg_decide_reference, the
  kernel's decision), queues the rest in (i, lane) order for the exact
  test, retries the exact test's rejections from a ring, 32 entries a pass,
  attempts 1-14 (the last rejection leaves d), and boosts each accepted d v
  from the tag that carries the boost word's top 23 bits and the attempt.
  Each attempt's arithmetic comes from full-width (half, P) tensors shaped
  as dual_gamma_draws' (torch's vectorised log on the CPU may round a tail
  element otherwise), so what is tested is the schedule: the entry map,
  the attempts, the ring, the tail chunk, lanes past the last path, and
  the boost after acceptance. Gammas and attempts bit for bit.
- Rough Bergomi: a float32 mirror of the redesign's step. x' from the up
  member's products, the down member's negated: bit for bit the plain
  version's. v' = A e^{+-s}, A = xi0 exp(fma(eta, h, -comp)) once a (date,
  path), e^s = 2^(fma(k1, z1, k2 z2)) with the kernel's folded constants,
  e^-s its reciprocal; torch's exact exp2 and division stand in for
  ex2.approx and rcp.approx, and a second run moves both by 2^-22 relative
  (more than the two approximations' error) against each other. v' within
  chip_smoke.RB_VPRIME_RTOL of the plain version's (relative), and the
  redesign's ce (vhat_fast's operations in order, each multiply-add a
  multiply and an add) within chip_smoke.DUAL_CE_ATOL of the plain ce, at
  D8's (H 1/2, eta 1, rho -0.5) and D9's (H 0.1, eta 1.5, rho -0.7)
  configurations and step counts, every date, a put and a call.
The card holds the kernels themselves to the same plain versions
(chip_smoke.py R0).
"""

from collections import deque

import pytest
import torch

from chip_smoke import DUAL_CE_ATOL, RB_VPRIME_RTOL
from options_model_tpu_torch.core.config import MCConfig, OptionSpec, RBergomiParams
from options_model_tpu_torch.models.rbergomi import simulate_rbergomi
from options_model_tpu_torch.ops import cuda_dual
from options_model_tpu_torch.ops.cuda_vg import (DECIDE_REJECT, DECIDE_SQUEEZE,
                                                 vg_decide_reference)
from options_model_tpu_torch.ops.philox import (DUAL_GAMMA_STREAM, VG_MAX_ATTEMPTS,
                                                _slot_counters, box_muller, dual_gamma_draws,
                                                dual_inner_draws, gamma_constants, philox4x32,
                                                uniform_from_bits)
from options_model_tpu_torch.pricers import dual as pd
from _torch_threads import one_torch_thread_module  # noqa: F401

SEED = 0x510E527FADE682D1
WARP = 32
CHUNK = 8                    # csrc/dual.cu kClockChunk
ENTRIES = WARP * CHUNK       # kClockEntries: a warp's clock and its ring
ATTEMPT_BITS = 0x1FF         # csrc/gamma.cuh kAttemptBits
LOG2E = 1.4426950408889634   # csrc/hopper_fast.cuh kLog2e
U_CLAMP = 4.0
S0, K, T, R = 100.0, 100.0, 0.5, 0.05
# D8's and D9's configurations (chip_smoke.py phase_rough).
D8 = (RBergomiParams(H=0.5, eta=1.0, rho=-0.5, xi0=0.04), 40)
D9 = (RBergomiParams(H=0.1, eta=1.5, rho=-0.7, xi0=0.04), 30)

pytestmark = pytest.mark.usefixtures("one_torch_thread_module")


class _Attempts:
    """Attempt ``att`` of every (pair, path) of one date of the dual's clock,
    full width as dual_gamma_draws computes it: (the kernel's decision, d
    v, the boost word), each (half, P)."""

    def __init__(self, seed, first_tile, n_tiles, tile, half, date, a):
        k = gamma_constants(a)
        self.d, self.c, self.inv_a = (torch.tensor(k[key], dtype=torch.float32)
                                      for key in ("d", "c", "inv_a"))
        self.boost = k["boost"]
        self.j, self.g = _slot_counters(first_tile, n_tiles, tile, None)
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


def clock_schedule(seed, first_tile, n_tiles, tile, half, date, a):
    """Standard gamma draws and accepting attempts (half, P) of one date as
    the redesign's warps draw them; also the squeeze's share of attempt 0,
    each warp's passes of its exact tests and of its retries, and the most
    entries a warp's exact queue and ring held at once."""
    draws = _Attempts(seed, first_tile, n_tiles, tile, half, date, a)
    n = n_tiles * tile
    dec0, dv0, w30 = draws(0)
    g_all = torch.zeros((half, n), dtype=torch.float32)
    tag_all = torch.zeros((half, n), dtype=torch.int64)
    passes, most_exact, most_ring = [], 0, 0
    for p0 in range(0, n, WARP):
        n_exact = n_retry = 0
        for c0 in range(0, half, CHUNK):
            cs = min(CHUNK, half - c0)
            e = torch.arange(cs * WARP)
            pair, path = c0 + e // WARP, p0 + e % WARP
            live = path < n
            at = path.clamp(max=n - 1)
            d0 = dec0[pair, at]
            g, tag = dv0[pair, at].clone(), w30[pair, at] & ~ATTEMPT_BITS
            exact = e[(d0 != DECIDE_SQUEEZE) & live]       # pushed in (i, lane) order
            most_exact = max(most_exact, len(exact))
            n_exact += -(-len(exact) // WARP)
            ring = deque(exact[d0[exact] == DECIDE_REJECT].tolist())
            most_ring = max(most_ring, len(ring))
            while ring:
                n_retry += 1
                taken = [ring.popleft() for _ in range(min(len(ring), WARP))]
                again = []
                for q in taken:
                    att = int(tag[q] & ATTEMPT_BITS) + 1
                    dec, dv, w3 = draws(att)
                    i, p = int(pair[q]), int(path[q])
                    if dec[i, p] != DECIDE_REJECT:
                        g[q], tag[q] = dv[i, p], (int(w3[i, p]) & ~ATTEMPT_BITS) | att
                    elif att + 1 < VG_MAX_ATTEMPTS:
                        tag[q] = att
                        again.append(q)
                    else:
                        g[q], tag[q] = draws.d, VG_MAX_ATTEMPTS
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
    share = float((dec0 == DECIDE_SQUEEZE).double().mean())
    return gam, att, share, passes, most_exact, most_ring


@pytest.mark.parametrize("a", [0.0286, 0.2, 1.5])
def test_the_clock_schedule_draws_dual_gamma_draws(a):
    """2 tiles of 1,024 paths at first_tile 3, date 5, 18 pairs (chunks of
    8, 8 and a tail of 2): every gamma and accepting attempt equal to
    dual_gamma_draws', bit for bit, at the full-width bracket's shape (dt /
    nu = 0.0286), a boosted 0.2 and 1.5; the retries ran, the squeeze
    decided most of attempt 0, and the queues stayed within a warp's
    ENTRIES."""
    gam, att, share, passes, most_exact, most_ring = clock_schedule(SEED, 3, 2, 1024, 18, 5, a)
    want, want_att = dual_gamma_draws(SEED, 3, 2, 1024, 18, 5, a)
    assert torch.equal(att, want_att)
    assert torch.equal(gam.view(torch.int32), want.view(torch.int32))
    assert int(att.max()) >= 1 and 0.8 < share < 1.0
    assert 0 < most_exact <= ENTRIES and most_ring <= ENTRIES
    # a warp's chunks take an exact-test pass each at least where the squeeze left a draw
    assert all(e >= 1 for e, _ in passes) and sum(r for _, r in passes) > 0
    if a == 0.0286:
        assert bool((gam < 2.0 ** -126).any())   # subnormal clocks, kept (no flush to zero)


def test_lanes_past_the_last_path():
    """48 paths (a warp and a half): the second warp's 16 lanes past the
    last path draw nothing, and the 48 paths' clocks are dual_gamma_draws'
    bit for bit; a chunk longer than the pairs (5)."""
    gam, att, *_ = clock_schedule(SEED + 1, 0, 1, 48, 5, 2, 0.0286)
    want, want_att = dual_gamma_draws(SEED + 1, 0, 1, 48, 5, 2, 0.0286)
    assert torch.equal(att, want_att) and torch.equal(gam.view(torch.int32),
                                                      want.view(torch.int32))


def test_the_ring_never_overwrites_an_unread_entry():
    """The queues' worst case in a warp's chunk: every draw fails the
    squeeze (the exact queue holds all ENTRIES, each at its push position)
    and the exact test rejects each, so all enter the ring; then every retry
    is rejected, so every entry reaches VG_MAX_ATTEMPTS. Positions count
    from the chunk's start, modulo ENTRIES, as in the kernel; a pass reads
    up to 32 entries, then (after __syncwarp) pushes its rejects after the
    tail. A ring of ENTRIES slots holds every unread entry; the entries fit
    the queues' uint16, and a block's four clocks its static shared memory."""
    owner = [None] * ENTRIES
    head = tail = 0
    for e in range(ENTRIES):             # the exact tests' rejections, positions 0..
        owner[tail % ENTRIES] = e
        tail += 1
    tries = [0] * ENTRIES                # retries taken (attempts 1, 2, ..)
    while head != tail:
        n = min(tail - head, WARP)
        taken = [owner[(head + i) % ENTRIES] for i in range(n)]
        unread = {(head + i) % ENTRIES for i in range(n, tail - head)}
        again = []
        for e in taken:
            tries[e] += 1
            if tries[e] + 1 < VG_MAX_ATTEMPTS:
                again.append(e)
        for e in again:
            assert tail % ENTRIES not in unread
            owner[tail % ENTRIES] = e
            tail += 1
        head += n
    assert all(t == VG_MAX_ATTEMPTS - 1 for t in tries)
    assert ENTRIES < 1 << 16
    assert 4 * ENTRIES * (4 + 4 + 4 + 4 + 2 + 2) <= 48 * 1024


def _rough_case(params: RBergomiParams, n_steps: int, cp: float):
    """x = S / K, v, the frozen histories, the compensators, the policy
    rows and the law of a bracket on the port's own rough paths (1,024 x
    n_steps, CPU); a put, or a call on a dividend payer (q 0.03)."""
    q = 0.03 if cp > 0 else 0.0
    spec = OptionSpec(strike=K, rate=R, cp=cp, sigma=None, div_yield=q)
    S, v, hist = simulate_rbergomi(21, S0, T, params, MCConfig(n_paths=1024, n_steps=n_steps),
                                   R - q, return_paths=True, return_variance=True,
                                   return_dual_state=True, device="cpu")
    policy, _ = pd.fit_lsm_policy(S, spec, T, v_paths=v)
    rows = cuda_dual.policy_rows(policy, torch.from_numpy(pd.date_taus(T, n_steps)))
    law = pd.inner_law("rbergomi", spec, T, n_steps, rbergomi=params)
    comp = torch.from_numpy(pd.rbergomi_comp(params, T, n_steps))
    return (S / K).contiguous(), v, hist, comp, rows, law


def _fma(a, b, c):
    """fmaf in float32: the product exact in float64, one rounding of the sum
    to float64 and one to float32 (a double rounding apart at worst)."""
    return (a.double() * b.double() + c.double()).float()


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _rough_states(law, xp, vp, h, comp_t, draws, skew: float):
    """x', v' and the exponents e of x' = xp e^e (2, half, P), up member
    first, as dual_ce_rough_kernel forms them in float32; ``skew`` moves
    e^s and e^-s by (1 + skew) and (1 - skew)."""
    z1, z2, zp = draws["z1"], draws["z2"], draws["zp"]
    sv = torch.sqrt(torch.clamp_min(vp, 0.0))
    mu = (law.drift - 0.5 * vp) * law.dt
    pr = sv * (law.rho * (law.sqrt_dt * z1) + law.rbsd * zp)
    e = torch.stack([mu + pr, mu - pr])
    A = law.xi0 * torch.exp(_fma(_f32(law.eta), h, -comp_t))
    ks = (_f32(LOG2E) * law.eta) * law.sqrt2H
    k1, k2 = (ks * law.c1) * law.sqrt_dt, ks * law.c2
    es = torch.exp2(_fma(k1, z1, k2 * z2))
    v = torch.stack([A * (es * (1.0 + skew)), A * ((1.0 / es) * (1.0 - skew))])
    return xp * torch.exp(e), v, e


def _rough_ce(law, xp, row, x, v, e):
    """The redesign's ce of one date from its members: vhat_fast's floor at
    variance (v' + xi0) / 2, Horner polynomial, branch-free gate and clip,
    summed over the pairs in the kernel's order."""
    s = _f32(-law.cp * 0.70710678118654752)
    tau, b = row[0], row[pd.ROW_HEAD:]
    degree = b.shape[0] - 5
    c1 = _f32(0.5 * law.cp) * law.K * torch.exp(-_f32(law.q) * tau)
    c2 = _f32(0.5 * law.cp) * law.K * torch.exp(-_f32(law.rate) * tau)
    a = s * (torch.log(xp) + _f32(law.drift) * tau)
    w = (v * 0.5 + _f32(0.5 * law.xi0)) * tau
    r = torch.rsqrt(w)
    q = s * e + a
    g1, g2 = r * ((0.5 * s) * w + q), r * ((-0.5 * s) * w + q)
    floor = (c1 * x) * torch.special.erfc(g1) - c2 * torch.special.erfc(g2)
    u = torch.clamp(x * row[2] + (-row[1] * row[2]), -U_CLAMP, U_CLAMP)
    c = b[degree] * torch.ones_like(u)
    for i in range(degree - 1, -1, -1):
        c = c * u + b[i]
    xm1 = x - 1.0
    c = b[degree + 1] * torch.clamp_min(xm1, 0.0) + c
    wv = torch.clamp(v * row[4] + (-row[3] * row[4]), -U_CLAMP, U_CLAMP)
    c = wv * (b[degree + 3] * wv + (b[degree + 4] * u + b[degree + 2])) + c
    h = law.K * torch.clamp_min(xm1 if law.cp > 0 else -xm1, 0.0)
    itm = xm1 >= 0.0 if law.cp > 0 else xm1 <= 0.0
    cap = torch.where(itm, law.K * x if law.cp > 0 else torch.full_like(x, law.K), 0.0)
    vals = torch.maximum(floor, torch.minimum(torch.maximum(c, h), cap))
    acc = torch.zeros_like(xp)
    for k in range(vals.shape[1]):
        acc = acc + (vals[0, k] + vals[1, k])
    return acc / vals.shape[1] * 0.5


@pytest.mark.parametrize("cp", [-1.0, 1.0])
@pytest.mark.parametrize("config", [D8, D9], ids=["D8", "D9"])
def test_rough_step_mirror(config, cp):
    """Every date of a 1,024-path bracket at n_inner 64: the mirror's x'
    equal to the plain version's bit for bit; its v' within RB_VPRIME_RTOL
    of the plain version's, relative, with and without the 2^-22 skew; its
    ce within DUAL_CE_ATOL of the plain ce (dual_ce_reference, date by
    date)."""
    params, n_steps = config
    x, v, hist, comp, rows, law = _rough_case(params, n_steps, cp)
    seed, tile, half = 0x5DEECE66D, 512, 32
    ref = cuda_dual.dual_ce_reference(x, v, rows, law, seed, 0, tile, 2 * half, hist, comp)
    worst_v = worst_ce = 0.0
    for t in range(rows.shape[0]):
        draws = dual_inner_draws(seed, 0, x.shape[1] // tile, tile, half, "rbergomi", t)
        xs, vs = pd.inner_states_from_draws(law, x[t], v[t], draws, hist[t], comp[t])
        for skew in (0.0, 2.0 ** -22, -(2.0 ** -22)):
            xm, vm, e = _rough_states(law, x[t], v[t], hist[t], comp[t], draws, skew)
            assert torch.equal(xm, xs), t
            worst_v = max(worst_v, float(((vm - vs).abs() / vs).max()))
            got = _rough_ce(law, x[t], rows[t], xm, vm, e)
            assert bool(torch.isfinite(got).all())
            worst_ce = max(worst_ce, float((got - ref[t]).abs().max()))
    assert worst_v <= RB_VPRIME_RTOL, worst_v
    assert worst_ce <= DUAL_CE_ATOL, worst_ce
