"""Kernel 22's redesign (csrc/vg.cu vg_terminal_kernel) on the host: the
squeeze that decides attempt 0 of most gamma draws, its margin, and the
schedule of the block's queues, held against the plain sampler
(ops/philox.gamma_from_stream) bit for bit.

The redesign accepts a draw where Marsaglia and Tsang's squeeze,
u < (1 - m(d)) - 0.0331 x^4, holds, and otherwise runs the plain version's
exact test, log(u) < x^2/2 + d - d v + d log(v). The margin m(d) = 2^-18
(1 + d) is derived beside kSqueezeMargin: with it the squeeze accepts only
draws the float32 exact test accepts, so the two designs and the plain
version decide alike. Here:
- the derivation's terms and the squeeze's slack evaluated in float64 on a
  grid of its whole range (|y| = |c x| up to 0.9572, d from the least the
  sampler makes to 10^4), against the totals the comment states;
- ops/cuda_vg.vg_decide_reference (the kernel's decision, one float32
  operation at a time in its order) on an adversarial grid at each shape:
  the band x -> 0, u -> 1, where the exact test's rhs cancels to a few ulps
  of d, and the squeeze's edge u ~ T across the range of x. Without a
  margin the squeeze accepts draws the exact test rejects somewhere in the
  grid (the grid bites); with it, never;
- a torch mirror of a warp's schedule (attempt 0 and the squeeze, the
  warp's exact queue, its ring of retries, the walk's boost) == gamma_from_stream's
  gammas and attempts bit for bit on the stream's own draws; the queue's
  worst case. Each attempt's arithmetic comes from full-width tensors shaped
  as gamma_from_stream's, as tests/test_torch_vg_clock.py takes it for
  kernel 21 (torch's vectorised log on the CPU may round a tail element
  otherwise). The card runs the kernel's own decision on a grid of 2^24
  pairs and holds both designs against the plain version (chip_smoke.py
  F0).
"""

from collections import deque

import numpy as np
import pytest
import torch

from options_model_tpu_torch.ops import cuda_vg
from options_model_tpu_torch.ops.cuda_heston import TERMINAL_TILE
from options_model_tpu_torch.ops.cuda_vg import (DECIDE_EXACT, DECIDE_REJECT, DECIDE_SQUEEZE,
                                                 SQUEEZE_KAPPA, SQUEEZE_MARGIN,
                                                 vg_decide_reference)
from options_model_tpu_torch.ops.philox import (VG_MAX_ATTEMPTS, _vg_words, box_muller,
                                                gamma_constants, gamma_from_stream,
                                                uniform_from_bits)
from _torch_threads import one_torch_thread_module  # noqa: F401

SEED = 0x3C6EF372FE94F82B
BLOCK = 128                  # csrc/vg.cu kTermBlock
WARP = 32
SLOTS = 4                    # csrc/vg.cu kTermSlots
ATTEMPT_BITS = 0x1FF         # csrc/gamma.cuh kAttemptBits
SHAPES = (0.01, 0.2, 1.0, 2.857, 5.0, 20.0)
U0 = 2.0 ** -24
# The least d gamma_constants makes (a = 1, and a < 1 at a + 1 >= 1).
D0 = float(np.float32(1.0) - np.float32(1.0 / 3.0))
X_MAX = 2.3445               # kappa x^4 < 1 + 6 u0
Y_MAX = 0.9572               # X_MAX c at d0

pytestmark = pytest.mark.usefixtures("one_torch_thread_module")


def _h(y):
    """h(y) = -3 y + 3 y^2 / 2 - y^3 + 3 ln(1 + y), from its series near 0
    (the closed form cancels there)."""
    y = np.asarray(y, np.float64)
    out = -3.0 * y + 1.5 * y * y - y ** 3 + 3.0 * np.log1p(y)
    small = np.abs(y) < 0.1
    ys, acc = y[small], 0.0
    for n in range(23, 3, -1):                  # -3 sum_n>=4 (-y)^n / n, Horner
        acc = acc * -ys + 1.0 / n
    out[small] = -3.0 * ys ** 4 * acc
    return out


def _range(d, n=20001):
    """y = x / (3 sqrt d) over the squeeze's range |x| <= X_MAX at d."""
    y_max = X_MAX / (3.0 * np.sqrt(d)) * (1 + 3 * U0)
    return np.linspace(-y_max, y_max, n)


def _terms(y, d):
    """The derivation's error terms at (y, d), in units of u0: R's roundings
    and logf(v) (at the local v), the float v's rho, the host c's delta,
    the squeeze's rounding and the loss of ln S near S ~ 1."""
    v = (1.0 + y) ** 3
    x2h = 4.5 * d * y * y * (1 + 6 * U0)           # x^2 / 2, x = 3 sqrt(d) y
    lnv = np.abs(np.log(v))
    r1 = d + x2h
    r2 = d * np.abs(1.0 - v) + x2h
    rounding = x2h + r1 + d * v + r2 + 2 * d * lnv + d * lnv + (r2 + d * lnv)
    rho = (5.0 + 3.0 * np.abs(y) / (1.0 + y)) * np.abs(1.0 - v) * d
    kprime = 3.0 * np.abs(1.0 - v) / (1.0 + y)
    delta = kprime * np.abs(y) * 2.5 * d
    return rounding + rho + delta + 6.0 + 8.0


def _sigma(y, d):
    """The squeeze's slack at the exact c: d h(y) - ln(1 - kappa x^4)."""
    t = float(SQUEEZE_KAPPA) * 81.0 * d * d * y ** 4
    return d * _h(y) - np.log1p(-np.minimum(t, 1.0 - 1e-16))


def test_margin_covers_the_derived_bound_over_the_whole_range():
    """Every d on a log grid from d0 to 10^4 and the whole range of y: the
    squeeze's slack is >= 0; where |y| <= 1/2 the terms stay within u0 (25 +
    38.3 d) <= m(d) (1 - u0); where |y| > 1/2 (d < 2.45 only) within u0 (25
    + 300 d) < 4.6e-5 and far below the slack, >= 2.0e-3 there. d h >=
    -2.89 on the range (the step that bounds 2 u0 |ln S|)."""
    ds = np.concatenate([np.linspace(D0, 2.5, 120), np.geomspace(2.5, 1e4, 80)])
    least_edge_sigma = np.inf
    for d in ds:
        y = _range(d)
        t = float(SQUEEZE_KAPPA) * 81.0 * d * d * y ** 4
        y = y[t < 1.0]
        sigma, e = _sigma(y, d), _terms(y, d) * U0
        assert sigma.min() >= 0.0, d
        assert (d * _h(y)).min() >= -2.89, d
        core = np.abs(y) <= 0.5
        assert e[core].max() <= U0 * (25 + 38.3 * d), d
        assert e[core].max() <= SQUEEZE_MARGIN * (1 + d) * (1 - U0), d
        if (~core).any():
            assert d < 2.45
            assert e[~core].max() <= U0 * (25 + 300 * d) < 4.6e-5, d
            least_edge_sigma = min(least_edge_sigma, sigma[~core].min())
            assert (sigma[~core] >= e[~core] - SQUEEZE_MARGIN * (1 + d)).all(), d
    assert 2.0e-3 <= least_edge_sigma < 2.1e-3
    # the range's corners as the comment states them
    c0 = float(gamma_constants(1.0)["c"])
    assert np.float32(D0) == gamma_constants(1.0)["d"] and c0 <= 0.4083
    assert X_MAX * c0 <= Y_MAX and float(SQUEEZE_KAPPA) * X_MAX ** 4 > 1 + 6 * U0


def _squeeze(x, u, d, c, margin):
    """The squeeze at ``margin`` in the kernel's float32 order (v1 > 0 and u
    < (1 - m) - kappa (x x)(x x))."""
    v1 = 1.0 + c * x
    one_m = 1.0 - margin * (1.0 + d)
    x2 = x * x
    return (v1 > 0) & (u < one_m - SQUEEZE_KAPPA * (x2 * x2))


def _grid(d, c):
    """(x, u) float32 pairs: the band |x| <= 0.06 (and tiny |x|) against u =
    1 - j 2^-24, j = 1..16, and the squeeze's edge: x across its range
    against the floats within 4 ulps of T at margin 0 and at m(d)."""
    f = torch.float32
    xb = torch.cat([torch.linspace(-0.06, 0.06, 1 << 17, dtype=torch.float64),
                    2.0 ** -torch.arange(10, 130, dtype=torch.float64)]).to(f)
    ub = torch.tensor([1.0 - j * U0 for j in range(1, 17)], dtype=f)
    xs = [xb.repeat(len(ub))]
    us = [ub.repeat_interleave(len(xb))]
    xe = torch.linspace(-X_MAX, X_MAX, 1 << 15, dtype=torch.float64).to(f)
    x2 = xe * xe
    for margin in (0.0, SQUEEZE_MARGIN):
        T = (1.0 - margin * (1.0 + d)) - SQUEEZE_KAPPA * (x2 * x2)
        for k in range(-4, 5):
            u = T
            step = torch.full_like(T, 2.0 if k > 0 else -1.0)
            for _ in range(abs(k)):
                u = torch.nextafter(u, step)
            keep = (u >= 0) & (u < 1)
            xs.append(xe[keep])
            us.append(u[keep])
    return torch.cat(xs), torch.cat(us)


@pytest.mark.parametrize("a", SHAPES)
def test_the_grid_catches_the_squeeze_without_a_margin_and_not_with_it(a):
    """At each shape: the squeeze without a margin accepts draws of the grid
    that the exact test rejects; with m(d), vg_decide_reference's squeeze
    accepts none of them, and its decision is the exact test's everywhere
    (a squeeze acceptance is an exact acceptance)."""
    k = gamma_constants(a)
    d, c = (torch.tensor(k[key], dtype=torch.float32) for key in ("d", "c"))
    x, u = _grid(d, c)
    dec = vg_decide_reference(x, u, d, c)
    v1 = 1.0 + c * x
    v = v1 * v1 * v1
    rhs = 0.5 * x * x + d - d * v + d * torch.log(v)
    exact = (v1 > 0) & (torch.log(u) < rhs)
    bare = _squeeze(x, u, d, c, 0.0)
    assert int((bare & ~exact).sum()) > 0
    squeezed = dec == DECIDE_SQUEEZE
    assert torch.equal(squeezed, _squeeze(x, u, d, c, SQUEEZE_MARGIN))
    assert int((squeezed & ~exact).sum()) == 0
    assert int(squeezed.sum()) > 0
    assert torch.equal(dec != DECIDE_REJECT, exact)


def test_vg_decide_on_cpu_tensors_is_the_plain_version():
    """vg_decide on CPU tensors takes vg_decide_reference, no launch."""
    k = gamma_constants(2.857)
    x = torch.linspace(-3.0, 3.0, 4097)
    u = torch.linspace(0.0, 1.0 - 2.0 ** -23, 4097)
    d = torch.full_like(x, float(k["d"]))
    c = torch.full_like(x, float(k["c"]))
    before = dict(cuda_vg.launches)
    out = cuda_vg.vg_decide(x, u, d, c)
    assert torch.equal(out, vg_decide_reference(x, u, float(k["d"]), float(k["c"])))
    assert set(out.unique().tolist()) == {DECIDE_REJECT, DECIDE_SQUEEZE, DECIDE_EXACT}
    assert cuda_vg.launches == before


class _Draws:
    """Attempt ``att`` of every slot of the launch at step 0, full width as
    gamma_from_stream computes it: (the decision, d v, the boost word). With
    ``no_squeeze`` the squeeze accepts nothing (the exact test decides all);
    ``refuse`` lists slots whose every attempt is rejected."""

    def __init__(self, seed, first_tile, n_tiles, a, no_squeeze=False, refuse=()):
        k = gamma_constants(a)
        self.d, self.c, self.inv_a = (torch.tensor(k[key], dtype=torch.float32)
                                      for key in ("d", "c", "inv_a"))
        self.boost = k["boost"]
        self.args = (seed, first_tile, n_tiles, TERMINAL_TILE)
        self.no_squeeze, self.refuse = no_squeeze, list(refuse)
        self.cache = {}

    def __call__(self, att):
        if att not in self.cache:
            w0, w1, w2, w3 = _vg_words(*self.args, 1 + att, None)
            x = box_muller(uniform_from_bits(w0), uniform_from_bits(w1))[0]
            dec = vg_decide_reference(x, uniform_from_bits(w2), self.d, self.c)
            if self.no_squeeze:
                dec = torch.where(dec == DECIDE_SQUEEZE, DECIDE_EXACT, dec)
            dec[self.refuse] = DECIDE_REJECT
            v1 = 1.0 + self.c * x
            self.cache[att] = (dec, self.d * (v1 * v1 * v1), w3)
        return self.cache[att]


def terminal_schedule(draws, n_tiles, antithetic=True):
    """Standard gamma draws and accepting attempts (n_tiles TERMINAL_TILE,)
    in path order, as the redesign's warps draw them; also the squeeze's
    share of attempt 0, and per warp the most entries its exact queue and
    its ring held against their sizes (the ring's unread entries counted
    when a pass pushes, after its reads)."""
    n_p = 2 if antithetic else 1
    width = TERMINAL_TILE // n_p
    n_e = n_p * SLOTS * WARP                # a warp's entries, and its ring's size
    g_all = torch.zeros(n_tiles * TERMINAL_TILE, dtype=torch.float32)
    tag_all = torch.zeros(n_tiles * TERMINAL_TILE, dtype=torch.int64)
    dec0, dv0, w30 = draws(0)
    most_exact = most_ring = 0
    e = torch.arange(n_e)
    r = e // WARP
    for b in range(n_tiles * width // (SLOTS * BLOCK)):
        local_tile, j0 = divmod(b * SLOTS * BLOCK, width)
        for w in range(BLOCK // WARP):
            # entry e = (i kP + p) 32 + lane: slot j0 + i kBlock + 32 w + lane,
            # its mirror at p = 1; pushed in (i, p, lane) order
            col = (local_tile * TERMINAL_TILE + j0 + (r // n_p) * BLOCK + w * WARP + e % WARP
                   + (r % n_p) * width)
            g, tag = dv0[col].clone(), w30[col] & ~ATTEMPT_BITS
            exact = e[dec0[col] != DECIDE_SQUEEZE]
            most_exact = max(most_exact, len(exact))
            ring = deque(exact[dec0[col[exact]] == DECIDE_REJECT].tolist())
            most_ring = max(most_ring, len(ring))
            while ring:
                taken = [ring.popleft() for _ in range(min(len(ring), WARP))]
                again = []
                for q in taken:
                    att = int(tag[q] & ATTEMPT_BITS) + 1
                    dec, dv, w3 = draws(att)
                    cq = int(col[q])
                    if dec[cq] != DECIDE_REJECT:
                        g[q], tag[q] = dv[cq], (int(w3[cq]) & ~ATTEMPT_BITS) | att
                    elif att + 1 < VG_MAX_ATTEMPTS:
                        tag[q] = att
                        again.append(q)
                    else:
                        g[q], tag[q] = draws.d, VG_MAX_ATTEMPTS
                ring.extend(again)
                most_ring = max(most_ring, len(ring))
            g_all[col], tag_all[col] = g, tag
    att = (tag_all & ATTEMPT_BITS).to(torch.int32)
    gam = g_all
    if draws.boost:
        # the walk's boost, full width as gamma_from_stream's
        boosted = torch.exp(torch.log(g_all) + torch.log(uniform_from_bits(tag_all))
                            * draws.inv_a)
        gam = torch.where(att < VG_MAX_ATTEMPTS, boosted, g_all)
    share = float((dec0 == DECIDE_SQUEEZE).double().mean())
    return gam, att, share, (most_exact, n_e), (most_ring, n_e)


def _squeeze_law(a):
    """P(u < 1 - m(d) - 0.0331 x^4, 1 + c x > 0), x ~ N(0, 1), u ~ U(0, 1):
    the squeeze's share of attempt 0 in law (a Riemann sum in float64)."""
    k = gamma_constants(a)
    x = np.linspace(-X_MAX, X_MAX, 200001)
    p = np.clip(1.0 - SQUEEZE_MARGIN * (1.0 + float(k["d"])) - float(SQUEEZE_KAPPA) * x ** 4,
                0.0, 1.0) * (1.0 + float(k["c"]) * x > 0)
    return float(np.sum(p * np.exp(-0.5 * x * x)) * (x[1] - x[0]) / np.sqrt(2 * np.pi))


@pytest.mark.parametrize("a", SHAPES)
def test_the_redesigns_schedule_draws_the_plain_samplers_gammas(a):
    """2 tiles at first_tile 3, antithetic: every gamma and accepting
    attempt equal to gamma_from_stream's, bit for bit; the squeeze's share
    of attempt 0 within 0.01 of its law's (6 stderr at 32,768 draws); the
    queues within their sizes."""
    n_tiles, first_tile = 2, 3
    gam, att, share, (most_exact, n_e), (most_ring, cap) = terminal_schedule(
        _Draws(SEED, first_tile, n_tiles, a), n_tiles)
    want, want_att = gamma_from_stream(SEED, first_tile, n_tiles, TERMINAL_TILE, 0, a,
                                       return_attempts=True)
    assert torch.equal(att, want_att)
    assert torch.equal(gam.view(torch.int32), want.view(torch.int32))
    assert int(att.max()) >= 1                   # the retries ran
    assert abs(share - _squeeze_law(a)) < 0.01, (share, _squeeze_law(a))
    assert 0 < most_exact <= n_e and most_ring <= cap
    if a == 0.01:
        assert bool((gam == 0).any())            # float32 zeros of the boost, kept


def test_the_schedule_without_antithetics():
    """A thread a path (kP = 1): 16,384 slots, 32 blocks a tile."""
    gam, att, *_ = terminal_schedule(_Draws(SEED + 1, 0, 1, 0.2), 1, antithetic=False)
    want, want_att = gamma_from_stream(SEED + 1, 0, 1, TERMINAL_TILE, 0, 0.2,
                                       return_attempts=True)
    assert torch.equal(att, want_att) and torch.equal(gam, want)


def test_a_block_whose_every_draw_fails_the_squeeze():
    """The squeeze accepts nothing: every entry of every warp goes through
    the exact queue (full), and the gammas are still gamma_from_stream's bit
    for bit."""
    gam, att, share, (most_exact, n_e), (most_ring, cap) = terminal_schedule(
        _Draws(SEED + 2, 0, 1, 2.857, no_squeeze=True), 1)
    want, want_att = gamma_from_stream(SEED + 2, 0, 1, TERMINAL_TILE, 0, 2.857,
                                       return_attempts=True)
    assert share == 0.0 and most_exact == n_e
    assert torch.equal(att, want_att) and torch.equal(gam, want)


def test_an_entry_that_runs_out_of_attempts_is_left_at_d():
    """Slots 5 (a path) and 8192 + 7 (a mirror) rejected at every attempt:
    each is left at d with attempt VG_MAX_ATTEMPTS, not boosted; every other
    draw as gamma_from_stream draws it."""
    refuse = [5, TERMINAL_TILE // 2 + 7]
    draws = _Draws(SEED + 3, 0, 1, 0.2, refuse=refuse)
    gam, att, *_ = terminal_schedule(draws, 1)
    want, want_att = gamma_from_stream(SEED + 3, 0, 1, TERMINAL_TILE, 0, 0.2,
                                       return_attempts=True)
    other = torch.ones_like(att, dtype=torch.bool)
    other[refuse] = False
    assert torch.equal(att[other], want_att[other]) and torch.equal(gam[other], want[other])
    assert att[refuse].tolist() == [VG_MAX_ATTEMPTS] * 2
    assert gam[refuse].tolist() == [float(draws.d)] * 2


def test_the_ring_never_overwrites_an_unread_entry():
    """The queues' worst case in a warp: every draw fails the squeeze (the
    exact queue holds all 2 kTermSlots 32 entries, each at its push
    position) and the exact test rejects each, so all enter the ring; then
    every retry is rejected, so every entry, not one only, reaches
    VG_MAX_ATTEMPTS. Positions count from the start, as in the kernel; a
    pass reads up to 32 entries, then (after __syncwarp) pushes its rejects
    after the tail. A ring of as many slots as entries holds every unread
    entry."""
    n_entries = 2 * SLOTS * WARP
    cap = n_entries
    owner = [None] * cap
    head = tail = 0
    for e in range(n_entries):           # the exact tests' rejections, positions 0..
        owner[tail % cap] = e
        tail += 1
    tries = [0] * n_entries              # retries taken (attempts 1, 2, ..)
    while head != tail:
        n = min(tail - head, WARP)
        taken = [owner[(head + i) % cap] for i in range(n)]
        unread = {(head + i) % cap for i in range(n, tail - head)}
        again = []
        for e in taken:
            tries[e] += 1
            if tries[e] + 1 < VG_MAX_ATTEMPTS:
                again.append(e)
        for e in again:
            assert tail % cap not in unread
            owner[tail % cap] = e
            tail += 1
        head += n
    # attempts 1..14 taken by every entry: each reached VG_MAX_ATTEMPTS
    assert all(t == VG_MAX_ATTEMPTS - 1 for t in tries)
    assert BLOCK * SLOTS * 2 < 1 << 16   # a block's entries fit the queues' uint16
