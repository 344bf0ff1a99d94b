"""The schedule of kernel 21's redesign (csrc/vg.cu vg_paths_kernel) on the
host: a torch mirror of how its blocks draw the gamma clock, held against
the plain sampler (ops/philox.gamma_from_stream) bit for bit.

A block of BLOCK threads owns BLOCK antithetic pairs of one tile and draws
the clock of a chunk of steps at a time: attempt 0 of every draw of the
chunk (entry e = s kPaths + q, q the block's path), the rejected entries
into a ring in push order, the ring drained BLOCK entries a pass through
attempts 1, 2, .. (a rejected entry pushed again, the last attempt's
rejection leaving d), and the walk, which boosts each accepted d v once
from the tag that carries the boost word's top 23 bits and the attempt.
The mirror takes each attempt's arithmetic from full-width tensors shaped
as gamma_from_stream's (torch's vectorised log on the CPU may round a tail
element otherwise), so what it tests is the schedule: the entry-to-path
map, the attempt counts, the ring, the tail chunk and the boost after
acceptance. The card holds the kernel's draws against the first design's
and the plain version's (chip_smoke.py F0).
"""

from collections import deque

import pytest
import torch

from options_model_tpu_torch.ops.cuda_heston import PATH_TILE
from options_model_tpu_torch.ops.philox import (VG_DRAWS_A_STEP, VG_MAX_ATTEMPTS, _vg_words,
                                                box_muller, gamma_constants, gamma_from_stream,
                                                uniform_from_bits)
from _torch_threads import one_torch_thread_module  # noqa: F401

SEED = 0x243F6A8885A308D3
BLOCK = 128                  # csrc/vg.cu kBlock
ATTEMPT_BITS = 0x1FF         # csrc/vg.cu kAttemptBits

pytestmark = pytest.mark.usefixtures("one_torch_thread_module")


class _Attempts:
    """Attempt ``att`` of step ``t`` for every path of the launch, computed
    once, as gamma_from_stream computes it: (d v, accepted, boost word)."""

    def __init__(self, seed, first_tile, n_tiles, tile, a):
        k = gamma_constants(a)
        self.d, self.c, self.inv_a = (torch.tensor(k[key], dtype=torch.float32)
                                      for key in ("d", "c", "inv_a"))
        self.boost = k["boost"]
        self.args = (seed, first_tile, n_tiles, tile)
        self.cache = {}

    def __call__(self, t, att):
        if (t, att) not in self.cache:
            w0, w1, w2, w3 = _vg_words(*self.args, t * VG_DRAWS_A_STEP + 1 + att, None)
            x = box_muller(uniform_from_bits(w0), uniform_from_bits(w1))[0]
            v1 = 1.0 + self.c * x
            v = v1 * v1 * v1
            rhs = 0.5 * x * x + self.d - self.d * v + self.d * torch.log(v)
            ok = (v1 > 0) & (torch.log(uniform_from_bits(w2)) < rhs)
            self.cache[t, att] = (self.d * v, ok, w3)
        return self.cache[t, att]


def clock_schedule(seed, first_tile, n_tiles, tile, n_steps, a, chunk, antithetic=True):
    """Standard gamma draws and accepting attempts (n_steps, n_tiles * tile),
    in path order, as the redesign's blocks draw them. Also returns the
    most entries the ring held and the ring's size."""
    attempt = _Attempts(seed, first_tile, n_tiles, tile, a)
    n_p = 2 if antithetic else 1
    width = tile // n_p
    k_paths = n_p * BLOCK
    cap = chunk * k_paths + BLOCK
    g_rows = torch.zeros((n_steps, n_tiles * tile), dtype=torch.float32)
    tag_rows = torch.zeros((n_steps, n_tiles * tile), dtype=torch.int64)
    most = 0
    for b in range(n_tiles * width // BLOCK):
        local_tile, j0 = divmod(b * BLOCK, width)
        q = torch.arange(k_paths)
        col = local_tile * tile + j0 + q % BLOCK + (q // BLOCK) * width
        for t0 in range(0, n_steps, chunk):
            cs = min(chunk, n_steps - t0)
            g = torch.empty(cs * k_paths, dtype=torch.float32)
            tag = torch.empty(cs * k_paths, dtype=torch.int64)
            ring = deque()
            for s in range(cs):
                d_v, ok, w3 = attempt(t0 + s, 0)
                e = s * k_paths + q
                g[e], tag[e] = d_v[col], w3[col] & ~ATTEMPT_BITS
                ring.extend((s * k_paths + q[~ok[col]]).tolist())
            most = max(most, len(ring))
            while ring:
                taken = [ring.popleft() for _ in range(min(len(ring), BLOCK))]
                for e in taken:
                    s, qq = divmod(e, k_paths)
                    att = int(tag[e] & ATTEMPT_BITS) + 1
                    d_v, ok, w3 = attempt(t0 + s, att)
                    c = int(col[qq])
                    if ok[c]:
                        g[e], tag[e] = d_v[c], (int(w3[c]) & ~ATTEMPT_BITS) | att
                    elif att + 1 < VG_MAX_ATTEMPTS:
                        tag[e] = att
                        ring.append(e)
                    else:
                        g[e], tag[e] = attempt.d, VG_MAX_ATTEMPTS
                most = max(most, len(ring) + len(taken))
            for s in range(cs):
                g_rows[t0 + s, col] = g[s * k_paths + q]
                tag_rows[t0 + s, col] = tag[s * k_paths + q]
    att = (tag_rows & ATTEMPT_BITS).to(torch.int32)
    gam = g_rows
    if attempt.boost:
        # the walk's boost, full rows as gamma_from_stream's
        boosted = torch.exp(torch.log(g_rows)
                            + torch.log(uniform_from_bits(tag_rows)) * attempt.inv_a)
        gam = torch.where(att < VG_MAX_ATTEMPTS, boosted, g_rows)
    return gam, att, most, cap


@pytest.mark.parametrize("a", [0.01, 0.05, 1.0, 2.5])
def test_the_redesigns_schedule_draws_the_plain_samplers_gammas(a):
    """2 tiles x 8 steps in chunks of 3 (a tail of 2): every gamma and
    accepting attempt equal to gamma_from_stream's, bit for bit."""
    n_tiles, n_steps, first_tile = 2, 8, 5
    gam, att, most, cap = clock_schedule(SEED, first_tile, n_tiles, PATH_TILE, n_steps, a, 3)
    for t in range(n_steps):
        want, want_att = gamma_from_stream(SEED, first_tile, n_tiles, PATH_TILE, t, a,
                                           return_attempts=True)
        assert torch.equal(att[t], want_att), t
        assert torch.equal(gam[t].view(torch.int32), want.view(torch.int32)), t
    assert int(att.max()) >= 1               # the retries ran
    assert most <= cap
    if a == 0.01:
        assert bool((gam == 0).any())        # float32 zeros of the boost, kept


def test_the_schedule_without_antithetics_and_with_one_chunk():
    """A thread a path (no mirror), and a chunk longer than the steps."""
    gam, att, _, _ = clock_schedule(SEED + 1, 0, 1, PATH_TILE, 3, 0.05, 8, antithetic=False)
    for t in range(3):
        want, want_att = gamma_from_stream(SEED + 1, 0, 1, PATH_TILE, t, 0.05,
                                           return_attempts=True)
        assert torch.equal(att[t], want_att) and torch.equal(gam[t], want)


def test_the_ring_never_overwrites_an_unread_entry():
    """The ring's worst case: every entry of a chunk rejected at every
    attempt. Positions count from the launch's start, as in the kernel; a
    pass reads up to BLOCK entries, then pushes its rejects after the tail.
    kEntries + BLOCK slots hold every unread entry through 15 attempts."""
    n_entries = 8 * 2 * BLOCK            # kChunk steps of a block's two paths a pair
    cap = n_entries + BLOCK
    owner = [None] * cap                 # the entry each slot holds until read
    head = tail = 0
    for e in range(n_entries):
        owner[tail % cap] = e
        tail += 1
    tries = [0] * n_entries
    while head != tail:
        n = min(tail - head, BLOCK)
        taken = [owner[(head + i) % cap] for i in range(n)]
        # a slow warp may read its slot after a fast one pushed: a push may
        # only land on a slot read in an earlier pass
        unread = {(head + i) % cap for i in range(tail - head)}
        for i, e in enumerate(taken):
            tries[e] += 1
            if tries[e] + 1 < VG_MAX_ATTEMPTS:
                assert tail % cap not in unread
                owner[tail % cap] = e
                tail += 1
        head += n
    assert all(t == VG_MAX_ATTEMPTS - 1 for t in tries)
