"""The pass engine of the odd and Bluestein kernels (csrc/stft_psd.cu::
conv_plan, conv_pass, conv_transform, conv_forward and the turn-around
conv_turn_r2/conv_turn_odd; the kernels stft_odd_fft_psd_kernel<RADER,
RMAX, PACKED>, whose PACKED form runs the mixed route's Rader plans, and
stft_bluestein_psd_kernel<RANKS>), held on the CPU through a
numpy transcription of its geometry: how the plan's stages group into
passes, which butterflies each pass runs in time and in frequency, with
which twiddle rows, at which slots of the buffer (the XOR swizzle of a
power-of-two transform), the turn-around in registers, the product, and
the block each plan takes.

The transcription (``ConvRegisters``, below) is checked against the numpy
models of the two routes, ``tools/torch_precision.py::psd_bluestein`` and
``psd_odd_fft`` (their transforms ``_bluestein_transform`` and
``_transform``), which ``tests/test_torch_bluestein.py`` and
``tests/test_torch_odd_fft.py`` hold to the plain version, the JAX
package and scipy:

- every butterfly of every stage of the plan runs exactly once in each
  direction, on the plan's slots and with its twiddle rows, the stages in
  the plan's order in time and in reverse in frequency;
- every pass's reads and writes, the turn-around's, the product's, the
  loads', the epilogue's and the cluster's crossing are a bijection onto
  the buffer's slots; their bank conflicts (the most lanes of an 8-lane
  phase in one bank group, 16-byte values) are counted, and none at all
  on a power-of-two transform, where the swizzle puts them;
- the fused turn-around gives the separate passes and product bit for
  bit;
- the transform equals the models' bit for bit on every one of the
  Bluestein route's 235 distinct convolution lengths M (the cluster's
  halves as its ranks index them), on 70 Rader plans of the odd route, P
  = 8190 among them, and on 48 of the mixed route's 405 (every tenth, the
  few-butterfly plans and 8186), with each of the odd kernel's twelve
  instantiations and the Bluestein kernel's two; and the PSD equals
  ``psd_bluestein``, ``psd_odd_fft`` and ``psd_mixed_fft`` (the packed
  load and the split epilogue) bit for bit under every detrend, on frames
  that the pairing's guard keeps apart too;
- the plans fit the launchers: the source's constants and planner lines
  are the ones the transcription uses, every odd and Bluestein value takes
  a block of whole warps that holds its generic groups.

All of it is exact integer or bitwise arithmetic: no tolerance.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

from spectral_tpu_torch import SpecConfig  # noqa: E402
from spectral_tpu_torch.core import stft as tstft  # noqa: E402
from spectral_tpu_torch.ops import stft_cuda  # noqa: E402
import torch_precision  # noqa: E402
from test_torch_mixed_registers import (FLAT, R2_BITS, SRC,  # noqa: E402
                                        _constant, _phase_worst,
                                        fastdiv_apply, group_passes, rm_of,
                                        rmax_of)

FS = 16000.0
MAX_THREADS = _constant(SRC, "FFT_MAX_THREADS")
BLOCK_POINTS = _constant(SRC, "BLUE_MAX_BLOCK_POINTS")
SMALL_ROOTS = _constant(SRC, "SMALL_ROOTS")
NARROW_POINTS = _constant(SRC, "ODD_NARROW_POINTS")
RADER_NARROW_POINTS = _constant(SRC, "RADER_NARROW_POINTS")
PACKED_R2_BITS = _constant(SRC, "PACKED_R2_BITS")


def _routes():
    """nperseg 32-8192 by route, for the odd and Bluestein routes."""
    out = {"odd": [], "bluestein": []}
    for k in range(32, 8193):
        r = stft_cuda.route(SpecConfig(nperseg=k, hop=k // 4))
        if r in out:
            out[r].append(k)
    return out


ROUTES = _routes()
# one nperseg for each distinct Bluestein convolution length M
BLUE_BY_M = {}
for _k in ROUTES["bluestein"]:
    BLUE_BY_M.setdefault(
        tstft.bluestein_length(tstft.transform_length(_k)), _k)
RADER = [k for k in ROUTES["odd"] if tstft.rader_prime(k)]
# 70 Rader plans: every tenth, and 8191 (P = 8190 = 2 3^2 5 7 13)
RADER_SAMPLE = sorted(set(RADER[::10]) | {8191})
# the mixed route's 405 Rader plans (even K, M = K/2 a prime past 255,
# PACKED), and 48 of them: every tenth, plans whose generic pass has few
# butterflies (526: P = 262 = 2 131; 934, 233 2; 958, 239 2; 1006, 251 2;
# 1018, 127 2^2; 2894, 241 3 2) and 8186 (P = 4092 = 2^2 3 11 31)
MIXED_RADER = [k for k in range(32, 8193, 2)
               if stft_cuda.route(SpecConfig(nperseg=k, hop=k // 4))
               == "mixed" and tstft.rader_prime(k // 2)]
MIXED_RADER_SAMPLE = sorted(set(MIXED_RADER[::10])
                            | {526, 934, 958, 1006, 1018, 2894, 8186})


def fft_threads(n):
    """fft_threads: n/4 threads rounded up to a warp, 32 to 512."""
    return min(MAX_THREADS, max(32, (n // 4 + 31) // 32 * 32))


class ConvRegisters:
    """conv_plan's geometry for the N-point transform a block holds, from
    the host plan's (p, L, twiddle row, root row) stages: turn, a Rader or
    Bluestein convolution (passes both ways); width, the length that sets
    the block (K for the odd kernel, the block's M / RANKS for Bluestein).
    rmax is the kernel's instantiation: 0 (no generic pass), 4 or 8 output
    pairs a lane, or 1 where the generic passes run narrow, a thread an
    output pair. packed: the mixed route's Rader plans (PACKED), whose
    radix-2 passes hold up to 2^PACKED_R2_BITS values and whose generic
    passes all run narrow."""

    def __init__(self, stages, N, turn, width, packed=False):
        self.N = N
        self.packed = packed
        self.passes = group_passes(stages, N,
                                   PACKED_R2_BITS if packed else None)
        p_max = max([p for p, _, _, _ in stages if p % 2] + [2])
        self.rmax = rmax_of(p_max)
        for ps in self.passes:                  # k fastest in every pass
            ps.inner = ps.span
        r0 = self.passes[0].radix
        self.turn = turn
        self.fuse = turn and (r0 % 2 == 0 or r0 <= 7)
        pow2 = N & (N - 1) == 0
        self.mask = 7 if pow2 else 0
        self.shift = (r0.bit_length() - 1) if pow2 else 0
        self.threads = max(fft_threads(2 * width),
                           ((p_max + 1) // 2 + 31) // 32 * 32)
        warps = self.threads // 32

        def crowded(ps):        # more groups of output pairs than warps
            rm = rm_of(ps.radix, self.rmax)
            return ((ps.radix - 1) // 2 + rm) // rm > warps

        small = (width if packed else
                 RADER_NARROW_POINTS if turn else NARROW_POINTS)
        narrow = width <= small or any(
            ps.radix % 2 and ps.radix > 7 and (ps.nb <= 16 or crowded(ps))
            for ps in self.passes)
        if self.rmax and narrow:
            self.rmax = 1

    def slot(self, s):
        """SlotMap: where logical slot s lives."""
        s = np.asarray(s)
        return s ^ ((s >> self.shift) & self.mask)

    def base(self, ps, b):
        """mix_base with one frame a block and kfast: butterfly b's first
        slot and its k, k = j mod L fastest."""
        b = np.asarray(b)
        j = b - fastdiv_apply(b, ps.nb) * ps.nb
        g = fastdiv_apply(j, ps.inner)
        k = j - g * ps.span
        return g * ps.span * ps.radix + k, k

    def rounds(self, ps):
        """mix_generic_pass's rounds: (thread, butterfly, m0) that are on,
        each thread's outputs m0 ... m0 + rm - 1; narrow, a thread's output
        pair m (rm 1): per butterflies a round, and where per is a power of
        two the round's nr butterflies fastest across the lanes (m = t div
        nr), else the output pairs (m = t mod (h + 1))."""
        h = (ps.radix - 1) // 2
        tid = np.arange(self.threads)
        if self.rmax == 1:
            per = self.threads // (h + 1)
            jfast = per > 1 and per & (per - 1) == 0
            out = []
            m = tid // per if jfast else tid % (h + 1)
            j = tid - m * per if jfast else tid // (h + 1)
            for b0 in range(0, ps.nb, per):
                if jfast and ps.nb - b0 < per:       # a short last round
                    m = tid // (ps.nb - b0)
                    j = tid - m * (ps.nb - b0)
                on = (m <= h) & (j < per) & (b0 + j < ps.nb)
                out.append((tid[on], (b0 + j)[on], m[on]))
            return out, h + 1, per
        rm = rm_of(ps.radix, self.rmax)
        groups = (h + rm) // rm
        per_round = (self.threads // 32) // groups
        warp, lane = tid // 32, tid % 32
        chunks = (ps.nb + 31) // 32
        out = []
        for c0 in range(0, chunks, per_round):
            b = (c0 + warp // groups) * 32 + lane
            on = (warp // groups < per_round) & (b < ps.nb)
            out.append((tid[on], b[on], (warp % groups)[on] * rm))
        return out, groups, per_round


def _cmul(wr, wi, yr, yi):
    return wr * yr - wi * yi, wr * yi + wi * yr


def _r2_stages(vr, vi, tw, ps, k, L, dif):
    """mix_r2_stages: the pass's radix-2 stages on its values, S ascending
    in time, descending and transposed in frequency (r2_dif_butterfly)."""
    R = ps.radix
    B = R.bit_length() - 1
    for S in (reversed(range(B)) if dif else range(B)):
        for t in range(1 << S):
            w = tw[ps.rows[S] + k + L * t]
            for hi in range(R >> (S + 1)):
                i = t | (hi << (S + 1))
                j = i | (1 << S)
                ar, ai, br, bi = vr[i], vi[i], vr[j], vi[j]
                if dif:
                    vr[i], vi[i] = ar + br, ai + bi
                    vr[j], vi[j] = _cmul(w[..., 0], w[..., 1], ar - br,
                                         ai - bi)
                else:
                    tr, ti = _cmul(w[..., 0], w[..., 1], br, bi)
                    vr[i], vi[i] = ar + tr, ai + ti
                    vr[j], vi[j] = ar - tr, ai - ti


def _odd_dft(yr, yi, roots, p):
    """The p-point DFT by stage_odd's sums (q ascending), every output."""
    h = (p - 1) // 2
    zr, zi = [None] * p, [None] * p
    for m in range(h + 1):
        ar, ai = yr[0].copy(), yi[0].copy()
        br = np.zeros_like(ar)
        bi = np.zeros_like(ar)
        for q in range(1, h + 1):
            cr, ci = roots[(q * m) % p]
            ar = ar + (yr[q] + yr[p - q]) * cr
            ai = ai + (yi[q] + yi[p - q]) * cr
            br = br + (yr[q] - yr[p - q]) * ci
            bi = bi + (yi[q] - yi[p - q]) * ci
        zr[m], zi[m] = ar - bi, ai + br
        if m:
            zr[p - m], zi[p - m] = ar + bi, ai - br
    return zr, zi


def run_pass(cr, re, im, tw, ps, dif):
    """conv_pass on the (T, N) buffer re + i im, in place: mix_r2_pass,
    mix_odd_pass or mix_generic_pass, in time or in frequency."""
    L, R = ps.span, ps.radix
    base, k = cr.base(ps, np.arange(ps.nb))
    at = [cr.slot(base + q * L) for q in range(R)]
    vr = [re[:, a].copy() for a in at]
    vi = [im[:, a].copy() for a in at]
    if R % 2 == 0:
        _r2_stages(vr, vi, tw, ps, k, L, dif)
    else:
        rows = [tw[ps.rows[0] + (q - 1) * L + k] for q in range(1, R)]
        if not dif and L > 1:
            for q in range(1, R):
                vr[q], vi[q] = _cmul(rows[q - 1][:, 0], rows[q - 1][:, 1],
                                     vr[q], vi[q])
        vr, vi = _odd_dft(vr, vi, tw[ps.root:ps.root + R], R)
        if dif and L > 1:
            for q in range(1, R):
                vr[q], vi[q] = _cmul(rows[q - 1][:, 0], rows[q - 1][:, 1],
                                     vr[q], vi[q])
    for q, a in enumerate(at):
        re[:, a], im[:, a] = vr[q], vi[q]


def run_turn(cr, re, im, tw, product):
    """conv_turn_r2 / conv_turn_odd: pass 0 at span 1 in frequency, each
    slot's product, pass 0 in time, on a thread's contiguous slots."""
    ps = cr.passes[0]
    R = ps.radix
    b = np.arange(ps.nb)
    at = [cr.slot(b * R + q) for q in range(R)]
    vr = [re[:, a].copy() for a in at]
    vi = [im[:, a].copy() for a in at]
    zero = np.zeros(ps.nb, np.int64)
    roots = tw[ps.root:ps.root + R] if R % 2 else None
    if R % 2 == 0:
        _r2_stages(vr, vi, tw, ps, zero, 1, dif=True)
    else:
        vr, vi = _odd_dft(vr, vi, roots, R)
    for q in range(R):
        vr[q], vi[q] = product(b * R + q, vr[q], vi[q])
    if R % 2 == 0:
        _r2_stages(vr, vi, tw, ps, zero, 1, dif=False)
    else:
        vr, vi = _odd_dft(vr, vi, roots, R)
    for q, a in enumerate(at):
        re[:, a], im[:, a] = vr[q], vi[q]


def conv_transform(cr, re, im, tw, product, fuse=None):
    """conv_transform: the passes in frequency, the product (the turn-around
    where fused), the passes in time; product(s, yr, yi) of logical slots
    s."""
    fuse = cr.fuse if fuse is None else fuse
    for ps in reversed(cr.passes[int(fuse):]):
        run_pass(cr, re, im, tw, ps, dif=True)
    if fuse:
        run_turn(cr, re, im, tw, product)
    else:
        s = np.arange(cr.N)
        a = cr.slot(s)
        re[:, a], im[:, a] = product(s, re[:, a], im[:, a])
    for ps in cr.passes[int(fuse):]:
        run_pass(cr, re, im, tw, ps, dif=False)


def bluestein_conv(plan, ar, ai, fuse=None):
    """bluestein_transform on the (T, N) chirped values a = x w, in the
    kernel's buffers (one block, or the cluster's two ranks of M/2 slots,
    rank 1 taking W^j a_j, rank 0 adding W^j (rank 1's slot j) at the end):
    the conjugated convolution's slots 0..N-1 in natural order."""
    T, N = ar.shape
    tw = plan.twiddles
    stages = plan.stages.tolist()
    H = plan.m // plan.ranks
    cr = ConvRegisters(stages[:len(stages) - (plan.ranks - 1)], H, True, H)
    bhat = tw[plan.bhat:plan.bhat + plan.m]

    def product_of(rank):
        def product(s, yr, yi):
            pr, pi = _cmul(bhat[rank * H + s, 0], bhat[rank * H + s, 1], yr,
                           yi)
            return pr, -pi
        return product

    bufs = []
    for rank in range(plan.ranks):
        re, im = np.zeros((T, H)), np.zeros((T, H))
        a = cr.slot(np.arange(N))
        if rank == 0:
            re[:, a], im[:, a] = ar, ai
        else:                                   # W^j (rank 0's slot j)
            row = stages[-1][2]
            w = tw[row:row + H]
            h0r, h0i = bufs[0]
            re[:, cr.slot(np.arange(H))], im[:, cr.slot(np.arange(H))] = (
                _cmul(w[:, 0], w[:, 1], h0r[:, cr.slot(np.arange(H))],
                      h0i[:, cr.slot(np.arange(H))]))
        bufs.append((re, im))
    for rank, (re, im) in enumerate(bufs):
        conv_transform(cr, re, im, tw, product_of(rank), fuse)
    re, im = bufs[0]
    a = cr.slot(np.arange(N))
    or_, oi = re[:, a], im[:, a]
    if plan.ranks == 2:
        row = stages[-1][2]
        w = tw[row:row + N]
        h1r, h1i = bufs[1]
        tr, ti = _cmul(w[:, 0], w[:, 1], h1r[:, a], h1i[:, a])
        or_, oi = or_ + tr, oi + ti
    return or_, oi, cr


def bluestein_transform(plan, re, im, fuse=None):
    """The N-point DFT as the Bluestein kernel computes it, through the
    pass engine: X[k] = w_k conj(slot k) (BluesteinRead)."""
    n = plan.n
    tw = plan.twiddles
    cr_, ci_ = tw[plan.chirp:plan.chirp + n, 0], tw[plan.chirp:plan.chirp + n,
                                                    1]
    ar, ai = _cmul(cr_, ci_, re, im)
    o_r, o_i, _ = bluestein_conv(plan, ar, ai, fuse)
    return _cmul(cr_, ci_, o_r, -o_i)


def odd_transform(plan, re, im, fuse=None, packed=False):
    """The K-point transform as the odd kernel computes it on values in
    natural order: loaded at slot perm[i], the passes in time, or the Rader
    convolution over P = K - 1 slots (X[0] = x[0] + slot 0, each slot times
    its row of b^) read back as x[0] + slot perm[i] (ConvRaderRead). With
    K the packed length M = nperseg/2 and plan ``fft_plan(nperseg)`` it is
    the PACKED form's transform (conv_plan's width M either way)."""
    T, K = re.shape
    tw = plan.twiddles
    rader = plan.rader >= 0
    n = K - 1 if rader else K
    cr = ConvRegisters(plan.stages.tolist(), n, rader, K, packed)
    br, bi = np.zeros((T, K)), np.zeros((T, K))
    a = cr.slot(plan.perm)
    br[:, a], bi[:, a] = re, im
    if not rader:
        for ps in cr.passes:
            run_pass(cr, br, bi, tw, ps, dif=False)
        return br[:, cr.slot(np.arange(K))], bi[:, cr.slot(np.arange(K))]
    x0 = cr.slot(K - 1)
    sums = {}
    bh = tw[plan.rader:plan.rader + n]

    def product(s, yr, yi):
        s = np.asarray(s)
        if np.any(s == 0):
            j = int(np.flatnonzero(s == 0)[0])
            sums["r"] = br[:, x0] + yr[:, j]
            sums["i"] = bi[:, x0] + yi[:, j]
        return _cmul(bh[s, 0], bh[s, 1], yr, yi)

    pr, pi = br[:, :n], bi[:, :n]
    conv_transform(cr, pr, pi, tw, product, fuse)
    br[:, :n], bi[:, :n] = pr, pi
    zr, zi = np.empty((T, K)), np.empty((T, K))
    zr[:, 0], zi[:, 0] = sums["r"], sums["i"]
    at = cr.slot(plan.perm[1:])
    zr[:, 1:] = br[:, x0][:, None] + br[:, at]
    zi[:, 1:] = bi[:, x0][:, None] + bi[:, at]
    return zr, zi


def packed_psd(frames, window, wts, K, detrend):
    """(T, F) PSD of even-K frames as the PACKED form computes it: the
    frame's line, even samples in .x and odd in .y of slot perm[i / 2], the
    M-point transform through the pass engine (odd_transform, width M), the
    split step and epilogue (split_psd_epilogue, ``_split_psd``)."""
    v = torch_precision.detrended(frames.astype(np.float64),
                                  detrend) * window
    plan = tstft.fft_plan(K)
    re, im = odd_transform(plan, v[:, 0::2], v[:, 1::2], packed=True)
    return torch_precision._split_psd(re, im, plan.twiddles[plan.split:], K,
                                      wts, True)


def psd_engine(frames, window, wts, K, detrend, pack=True):
    """(T, F) PSD of float frames by the pass engine, with the models'
    load, pairing and epilogue (psd_bluestein, psd_odd_fft)."""
    v = torch_precision.detrended(frames.astype(np.float64),
                                  detrend) * window
    if stft_cuda.route(SpecConfig(nperseg=K, hop=K // 4)) == "odd":
        plan = tstft.fft_plan(K)
        return torch_precision._pair_psd(
            v, lambda re, im: odd_transform(plan, re, im), wts, True, pack)
    plan = tstft.bluestein_plan(K)
    if K % 2:
        return torch_precision._pair_psd(
            v, lambda re, im: bluestein_transform(plan, re, im), wts, True,
            pack)
    re, im = bluestein_transform(plan, v[:, 0::2], v[:, 1::2])
    return torch_precision._split_psd(re, im, plan.twiddles[plan.split:], K,
                                      wts, True)


# ---------------------------------------------------------------------------
# bit for bit against the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", sorted(BLUE_BY_M))
def test_bluestein_transform_equals_the_model_at_every_length(m):
    """Each of the 235 distinct M (one nperseg each; the cluster's halves
    from 14,580), random complex inputs: the pass engine's transform (fused
    turn-around) equals _bluestein_transform bit for bit, and so does it
    with the turn-around unfused."""
    k = BLUE_BY_M[m]
    plan = tstft.bluestein_plan(k)
    rs = np.random.RandomState(m)
    re, im = rs.randn(2, plan.n) + 3.0, rs.randn(2, plan.n)
    want = torch_precision._bluestein_transform(re, im, plan)
    got = bluestein_transform(plan, re, im)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    cr = ConvRegisters(plan.stages.tolist()[:len(plan.stages)
                                            - (plan.ranks - 1)],
                       m // plan.ranks, True, m // plan.ranks)
    if cr.fuse:
        apart = bluestein_transform(plan, re, im, fuse=False)
        assert all(np.array_equal(g, w) for g, w in zip(apart, got))


@pytest.mark.parametrize("k", RADER_SAMPLE)
def test_rader_transform_equals_the_model(k):
    """70 Rader plans of the odd route, P = 8190 among them: the pass
    engine's transform equals _transform bit for bit, fused and not."""
    plan = tstft.fft_plan(k)
    rs = np.random.RandomState(k)
    re, im = rs.randn(2, k) + 3.0, rs.randn(2, k)
    zr, zi = np.empty_like(re), np.empty_like(im)
    zr[:, plan.perm], zi[:, plan.perm] = re, im
    want = torch_precision._transform(zr, zi, plan, k)
    got = odd_transform(plan, re, im)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    got_apart = odd_transform(plan, re, im, fuse=False)
    assert all(np.array_equal(g, w) for g, w in zip(got_apart, got))


@pytest.mark.parametrize("k", MIXED_RADER_SAMPLE)
def test_mixed_rader_transform_equals_the_model(k):
    """48 of the mixed route's Rader plans (PACKED, M = k/2 points, P = M -
    1): the pass engine's transform equals _transform bit for bit, fused
    and not."""
    plan = tstft.fft_plan(k)
    M = k // 2
    rs = np.random.RandomState(k)
    re, im = rs.randn(2, M) + 3.0, rs.randn(2, M)
    zr, zi = np.empty_like(re), np.empty_like(im)
    zr[:, plan.perm], zi[:, plan.perm] = re, im
    want = torch_precision._transform(zr, zi, plan, M)
    got = odd_transform(plan, re, im, packed=True)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    got_apart = odd_transform(plan, re, im, fuse=False, packed=True)
    assert all(np.array_equal(g, w) for g, w in zip(got_apart, got))


MIXED_RADER_PSD = [514, 526, 1006, 2894, 4106, 4934, 8186]


@pytest.mark.parametrize("detrend", ["none", "constant", "linear"])
@pytest.mark.parametrize("k", MIXED_RADER_PSD)
def test_packed_psd_equals_the_model_bitwise(k, detrend):
    """Seven frames of noise + 3 (a ramp under linear detrend) at Rader
    plans of both instantiations the PACKED form takes (514 <0>, P = 256
    swizzled; 526, 1006, 2894, 4106, 4934, 8186 <1>, generic passes of 2
    to 88 butterflies): the packed load, the transform and the split
    epilogue give psd_mixed_fft's PSD bit for bit."""
    cfg = (SpecConfig.north_star(k, k // 4) if detrend == "none"
           else SpecConfig(nperseg=k, hop=k // 4, detrend=detrend))
    window = tstft._window_f64(cfg)
    wts = tstft.onesided_weights(cfg, FS)
    assert stft_cuda.route(cfg) == "mixed"
    frames = _frames(k, detrend, 7, k + len(detrend))
    want = torch_precision.psd_mixed_fft(frames, window, tstft.fft_plan(k),
                                         wts, detrend=detrend)
    got = packed_psd(frames, window, wts, k, detrend)
    assert np.array_equal(got, want)


def _mixed_rader_rmax(k):
    """The PACKED instantiation (conv_plan's rmax) of the mixed route's
    Rader plan at nperseg k: width M = k/2, P = M - 1 points."""
    M = k // 2
    return ConvRegisters(tstft.fft_plan(k).stages.tolist(), M - 1, True,
                         M, True).rmax


def test_mixed_rader_samples_cover_every_instantiation():
    """The mixed route's 405 Rader plans take the PACKED form's two
    instantiations (rmax 0, no generic pass, 52 of them; 1, narrow generic
    passes, 353); the transform sample, the PSD values and chip_smoke.py's
    MIXED_RADER_CASES (which it holds to 1 float32 ulp of the plain version
    on the card) each cover both, and the sample and the cases hold
    few-butterfly plans (a generic pass of at most 16 butterflies: 84 of the
    405), of 2 butterflies a round (the lanes' butterflies fastest) and of
    a count that is no power of two (the output pairs fastest: 4934, 7)."""
    import ast
    tree = ast.parse(open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")).read())
    cases = {t.id: ast.literal_eval(node.value) for node in tree.body
             if isinstance(node, ast.Assign) for t in node.targets
             if isinstance(t, ast.Name) and t.id == "MIXED_RADER_CASES"}
    chip = cases["MIXED_RADER_CASES"]
    assert len(MIXED_RADER) == 405 and set(chip) <= set(MIXED_RADER)
    counts = {}
    for k in MIXED_RADER:
        r = _mixed_rader_rmax(k)
        counts[r] = counts.get(r, 0) + 1
    assert counts == {0: 52, 1: 353}

    def few(k):
        P = k // 2 - 1
        return any(p % 2 and p > 7 and P // p <= 16
                   for p, _, _, _ in tstft.fft_plan(k).stages.tolist())
    assert sum(few(k) for k in MIXED_RADER) == 84
    for sample in (MIXED_RADER_SAMPLE, MIXED_RADER_PSD, chip):
        assert {_mixed_rader_rmax(k) for k in sample} == {0, 1}
    assert {526, 934, 1006} <= set(chip) and 8186 in chip

    def per(k):
        M = k // 2
        cr = ConvRegisters(tstft.fft_plan(k).stages.tolist(), M - 1, True,
                           M, True)
        return {cr.rounds(ps)[2] for ps in cr.passes
                if ps.radix % 2 and ps.radix > 7}
    pers = set().union(*(per(k) for k in chip))
    assert 2 in pers and any(p & (p - 1) for p in pers)
    assert sum(few(k) for k in MIXED_RADER_SAMPLE) >= 6


def test_samples_cover_every_instantiation():
    """The Rader sample and the odd values of the PSD test hold each of the
    odd kernel's eight instantiations (with and without a Rader stage; no
    generic pass, narrow ones, or 4 or 8 output pairs a lane); the
    Bluestein lengths both ranks."""
    inst = set()
    for k in RADER_SAMPLE + ODD_PSD:
        cr = ConvRegisters(tstft.fft_plan(k).stages.tolist(),
                           k - tstft.rader_prime(k), tstft.rader_prime(k), k)
        inst.add((tstft.rader_prime(k), cr.rmax))
    assert inst == {(r, x) for r in (False, True) for x in (0, 1, 4, 8)}
    assert {tstft.bluestein_plan(k).ranks for k in BLUE_BY_M.values()} == {
        1, 2}
    assert 8191 in RADER_SAMPLE and len(RADER_SAMPLE) >= 64
    assert len(BLUE_BY_M) == 235


def test_chip_smoke_cases_cover_every_instantiation():
    """chip_smoke.py holds the odd route's cases (ODD_CASES) to 1 float32
    ulp of the plain version on the card: among them each of the odd
    kernel's eight instantiations runs, and the Bluestein cases
    (BLUESTEIN_CASES) run both ranks."""
    import ast
    tree = ast.parse(open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")).read())
    cases = {t.id: ast.literal_eval(node.value) for node in tree.body
             if isinstance(node, ast.Assign) for t in node.targets
             if isinstance(t, ast.Name)
             and t.id in ("ODD_CASES", "BLUESTEIN_CASES")}
    inst = set()
    for k in cases["ODD_CASES"]:
        if stft_cuda.route(SpecConfig.scipy_default(k)) != "odd":
            continue
        cr = ConvRegisters(tstft.fft_plan(k).stages.tolist(),
                           k - tstft.rader_prime(k), tstft.rader_prime(k), k)
        inst.add((tstft.rader_prime(k), cr.rmax))
    assert inst == {(r, x) for r in (False, True) for x in (0, 1, 4, 8)}
    assert {tstft.bluestein_plan(k).ranks
            for k in cases["BLUESTEIN_CASES"]} == {1, 2}


ODD_PSD = [33, 45, 131, 257, 263, 271, 1021, 1023, 4093, 8181, 8183, 8191]
BLUE_PSD = [563, 1126, 2049, 2050, 7201, 7207, 8182, 8185]


def _frames(k, detrend, rows, seed, apart=False):
    """Noise + 3 frames (a ramp under linear detrend); with apart, frame 1
    all zero beside frame 0, a NaN in frame 3, frame 5 at 1e-6."""
    rs = np.random.RandomState(seed)
    f = rs.randn(rows, k) + 3.0
    if detrend == "linear":
        f += torch_precision.trend(k)
    if apart:
        f[1] = 0.0
        f[3, k // 3] = np.nan
        f[5] *= 1e-6
    return f.astype(np.float32)


@pytest.mark.parametrize("detrend", ["none", "constant", "linear"])
@pytest.mark.parametrize("k", ODD_PSD + BLUE_PSD)
def test_psd_equals_the_models_bitwise(k, detrend):
    """Seven frames (an odd T: a lone last frame), and seven with frames
    the pairing's guard keeps apart: the pass engine's PSD equals
    psd_odd_fft's or psd_bluestein's bit for bit, NaN where they have it."""
    cfg = (SpecConfig.north_star(k, k // 4) if detrend == "none"
           else SpecConfig(nperseg=k, hop=k // 4, detrend=detrend))
    window = tstft._window_f64(cfg)
    wts = tstft.onesided_weights(cfg, FS)
    odd = stft_cuda.route(cfg) == "odd"
    model = torch_precision.psd_odd_fft if odd else \
        torch_precision.psd_bluestein
    plan = tstft.fft_plan(k) if odd else tstft.bluestein_plan(k)
    for apart in (False, True):
        if apart and k % 2 == 0:
            continue
        frames = _frames(k, detrend, 7, k + len(detrend), apart)
        want = model(frames, window, plan, wts, detrend=detrend)
        got = psd_engine(frames, window, wts, k, detrend)
        assert np.array_equal(got, want, equal_nan=True)


# ---------------------------------------------------------------------------
# geometry: every butterfly once, bijections and bank conflicts
# ---------------------------------------------------------------------------

def _plans():
    """(label, stages, N, turn, width) of every distinct Bluestein block
    plan, every Rader plan of the sample and the odd PSD values."""
    out = []
    for m, k in sorted(BLUE_BY_M.items()):
        plan = tstft.bluestein_plan(k)
        st = plan.stages.tolist()[:len(plan.stages) - (plan.ranks - 1)]
        out.append((f"M {m}", st, m // plan.ranks, True, m // plan.ranks,
                    False))
    for k in sorted(set(RADER_SAMPLE) | set(ODD_PSD)):
        r = tstft.rader_prime(k)
        out.append((f"odd {k}", tstft.fft_plan(k).stages.tolist(), k - r, r,
                    k, False))
    for k in MIXED_RADER_SAMPLE:
        out.append((f"mixed {k}", tstft.fft_plan(k).stages.tolist(),
                    k // 2 - 1, True, k // 2, True))
    return out


PLANS = _plans()


def _butterflies(cr, ps, dif):
    """The (stage span, sorted first slots, rows) each stage of pass ps
    runs, in run order (the turn-around's pass 0 as run_turn runs it)."""
    L, R = ps.span, ps.radix
    base, k = cr.base(ps, np.arange(ps.nb))
    out = []
    if R % 2:
        rows = np.stack([ps.rows[0] + (q - 1) * L + k for q in range(1, R)])
        return [(R, L, np.sort(base), rows[:, np.argsort(base)])]
    B = R.bit_length() - 1
    for S in (reversed(range(B)) if dif else range(B)):
        firsts, rows = [], []
        for t in range(1 << S):
            for hi in range(R >> (S + 1)):
                i = t | (hi << (S + 1))
                firsts.append(base + i * L)
                rows.append(ps.rows[S] + k + L * t)
        f, r = np.concatenate(firsts), np.concatenate(rows)
        o = np.argsort(f)
        out.append((2, L << S, f[o], r[o]))
    return out


@pytest.mark.parametrize("label,stages,N,turn,width,packed", PLANS,
                         ids=[p[0] for p in PLANS])
def test_every_butterfly_runs_once_each_way_with_its_rows(label, stages, N,
                                                          turn, width,
                                                          packed):
    """In time the passes run the plan's stages in order, in frequency (a
    Rader or Bluestein convolution) in reverse: each stage (p, L) once,
    every butterfly (g, k) of it once, its first slot g L p + k and its
    rows (q - 1) L + k of the stage's twiddles; every pass's slots a
    bijection of the buffer."""
    cr = ConvRegisters(stages, N, turn, width, packed)
    plan_rows = {(p, L): row for p, L, row, _ in stages}
    for dif in ((False, True) if turn else (False,)):
        order = []
        for ps in (reversed(cr.passes) if dif else cr.passes):
            slots = np.concatenate([cr.base(ps, np.arange(ps.nb))[0]
                                    + q * ps.span for q in range(ps.radix)])
            assert np.array_equal(np.sort(cr.slot(slots)), np.arange(N))
            for p, L, firsts, rows in _butterflies(cr, ps, dif):
                j = np.arange(N // p)
                kk = j % L
                want = (j - kk) * p + kk
                assert np.array_equal(firsts, want), (label, p, L)
                q = np.arange(1, p)[:, None] if p % 2 else 1
                assert np.array_equal(rows, plan_rows[p, L]
                                      + (q - 1) * L + kk), (label, p, L)
                order.append((p, L))
        want = [(p, L) for p, L, _, _ in stages]
        assert order == (want[::-1] if dif else want), label


def _accesses(cr):
    """(kind, slots, ok) of each warp-wide access of the engine's passes,
    turn-around and product (per value q, per iteration of the block's
    threads), slots physical."""
    T = cr.threads
    for i, ps in enumerate(cr.passes):
        kind = ("r2" if ps.radix % 2 == 0 else
                "odd" if ps.radix <= 7 else "generic")
        if kind == "generic" and cr.rmax == 1:
            kind = "narrow"                     # a thread an output pair
            for tid, b, m in cr.rounds(ps)[0]:
                base, _ = cr.base(ps, b)
                lanes = np.full(T, -1)
                ok = np.zeros(T, bool)
                ok[tid] = True
                for q in range(ps.radix):       # reads: a butterfly's
                    lanes[tid] = cr.slot(base + q * ps.span)   # threads
                    yield "narrow read", lanes.copy(), ok.copy()  # share
                for mm in (m, np.where(m > 0, ps.radix - m, m)):
                    lanes[tid] = cr.slot(base + mm * ps.span)
                    live = ok.copy()
                    live[tid] = (mm == m) | (m > 0)
                    yield kind, lanes.copy(), live
            continue
        if kind == "generic":
            for tid, b, _ in cr.rounds(ps)[0]:
                lanes = np.full(T, -1)
                ok = np.zeros(T, bool)
                base, _ = cr.base(ps, b)
                for q in range(ps.radix):
                    lanes[tid] = cr.slot(base + q * ps.span)
                    ok[tid] = True
                    yield kind, lanes.copy(), ok.copy()
            continue
        for it in range(-(-ps.nb // T)):
            b = np.arange(T) + it * T
            ok = b < ps.nb
            bb = np.minimum(b, ps.nb - 1)
            if i == 0 and cr.fuse:              # the turn-around's slots
                for q in range(ps.radix):
                    yield "turn", cr.slot(bb * ps.radix + q), ok
                continue
            base, _ = cr.base(ps, bb)
            for q in range(ps.radix):
                yield kind, cr.slot(base + q * ps.span), ok
    if cr.turn and not cr.fuse:                 # the product's own loop
        for it in range(-(-cr.N // T)):
            s = np.arange(T) + it * T
            yield "product", cr.slot(np.minimum(s, cr.N - 1)), s < cr.N


def _worst(cr):
    worst = {}
    for kind, slots, ok in _accesses(cr):
        scope = 32 if kind == "generic" else slots.size
        for w in range(0, slots.size, scope):
            live = slots[w:w + scope][ok[w:w + scope]]
            assert kind == "narrow read" or (
                np.unique(live).size == live.size), kind
        worst[kind] = max(worst.get(kind, 0), _phase_worst(slots, ok))
    return worst


def test_bank_conflicts_counted_and_none_at_powers_of_two():
    """Every access of every plan a bijection within its warp's lanes
    (a generic pass's warps of one chunk read the same butterflies, each
    its own outputs); the most lanes of a phase in one bank group, counted
    by access kind over all plans: none anywhere on a power-of-two
    transform (the swizzle; without it the span-1 pass puts all eight lanes
    of a phase on one group; 2 on the PACKED plan of 514, P = 256 in passes
    of 4, 8 and 8 values). Elsewhere every pass takes k fastest across
    the lanes, and the census is pinned as it stands: a radix-2 or odd pass
    at a span no multiple of 8 straddles phases with its rows of
    butterflies (3 lanes a group at most: a radix-2 pass at M = 1536, 3072,
    6144 and 12288, an odd one at M = 1728, 2187, 3456 and others), a wide
    generic pass 2 (19 Rader plans, 859 among them), a narrow one (a thread
    an output pair) writes its pairs 3 lanes a group at most (263, 1023)
    and reads its butterflies' slots 2 lanes a group at most (a broadcast
    where the output pairs run fastest, a round's butterflies side by side
    where they do); the turn-around and the product never."""
    counts = {}
    for label, stages, N, turn, width, packed in PLANS:
        cr = ConvRegisters(stages, N, turn, width, packed)
        worst = _worst(cr)
        if N & (N - 1) == 0:
            # the PACKED plan at P = 256 (514) runs passes of 4, 8 and 8
            # values: the swizzle at pass 0's radix leaves a later pass 2
            # lanes a group
            assert max(worst.values()) == (2 if packed else 1), (label,
                                                                 worst)
            plain = ConvRegisters(stages, N, turn, width, packed)
            plain.mask = 0
            assert _worst(plain)["turn" if plain.fuse else "r2"] == (
                4 if packed else 8)          # 514's pass 0 holds 4 values
        for kind, w in worst.items():
            counts[kind] = max(counts.get(kind, 0), w)
    assert counts == COUNTS, counts


# the census of test_bank_conflicts_counted_and_none_at_powers_of_two
COUNTS = {"r2": 3, "odd": 3, "generic": 2, "narrow": 3, "narrow read": 2,
          "turn": 1, "product": 1}


def test_loads_and_reads_are_bijections():
    """The Bluestein load and epilogue (slot i, i < N, in natural order) and
    the cluster's crossing (slot j of both ranks) are conflict-free at
    every plan; the odd kernel's load scatters through perm onto every
    slot once (the swizzle of P = 256 keeps slot P, x[0], in place)."""
    for m, k in sorted(BLUE_BY_M.items()):
        plan = tstft.bluestein_plan(k)
        H = m // plan.ranks
        cr = ConvRegisters(plan.stages.tolist()[:len(plan.stages)
                                                - (plan.ranks - 1)],
                           H, True, H)
        i = np.arange(H)
        assert np.array_equal(np.sort(cr.slot(i)), i)
        for it in range(-(-H // cr.threads)):
            s = np.arange(cr.threads) + it * cr.threads
            assert _phase_worst(cr.slot(np.minimum(s, H - 1)), s < H) == 1
    for k in sorted(set(RADER_SAMPLE) | set(ODD_PSD)):
        plan = tstft.fft_plan(k)
        r = plan.rader >= 0
        cr = ConvRegisters(plan.stages.tolist(), k - r, r, k)
        at = cr.slot(plan.perm)
        assert np.array_equal(np.sort(at), np.arange(k)), k
        if cr.mask:
            assert cr.slot(k - 1) == k - 1
    # the PACKED load: sample i to double i & 1 of slot perm[i / 2], every
    # double of the M slots once (514: P = 256 swizzled, slot P in place)
    for k in MIXED_RADER_SAMPLE:
        plan = tstft.fft_plan(k)
        M = k // 2
        cr = ConvRegisters(plan.stages.tolist(), M - 1, True, M, True)
        i = np.arange(k)
        at = 2 * cr.slot(plan.perm[i >> 1]) + (i & 1)
        assert np.array_equal(np.sort(at), np.arange(k)), k
        if cr.mask:
            assert k == 514 and cr.slot(M - 1) == M - 1


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_every_value_fits_its_block():
    """Each of the odd route's 2,698 values, the mixed route's 405 Rader
    plans (PACKED) and the Bluestein route's 2,389: a block of whole warps
    up to FFT_MAX_THREADS that holds each generic pass's groups of warps
    (one round at least), at most MIX_MAX_PASSES passes, each radix-2 pass
    of 2 to 16 values; the odd kernel's eight instantiations and the
    PACKED form's four, and the Bluestein kernel's radices up to 7 (no
    generic code)."""
    max_passes = _constant(SRC, "MIX_MAX_PASSES")
    seen = set()
    for k in ROUTES["odd"]:
        plan = tstft.fft_plan(k)
        r = plan.rader >= 0
        cr = ConvRegisters(plan.stages.tolist(), k - r, r, k)
        seen.add((r, cr.rmax))
        assert cr.threads % 32 == 0 and cr.threads <= MAX_THREADS
        assert len(cr.passes) <= max_passes
        for ps in cr.passes:
            assert ps.radix % 2 or ps.radix <= 2 ** R2_BITS
            if ps.radix % 2 and ps.radix > 7:
                assert cr.rounds(ps)[2] >= 1
    assert seen == {(r, x) for r in (False, True) for x in (0, 1, 4, 8)}
    packed = set()
    for k in MIXED_RADER:
        plan = tstft.fft_plan(k)
        M = k // 2
        cr = ConvRegisters(plan.stages.tolist(), M - 1, True, M, True)
        packed.add(cr.rmax)
        assert cr.threads % 32 == 0 and cr.threads <= MAX_THREADS
        assert len(cr.passes) <= max_passes
        for ps in cr.passes:
            assert ps.radix % 2 or ps.radix <= 2 ** R2_BITS
            if ps.radix % 2 and ps.radix > 7:
                assert cr.rounds(ps)[2] >= 1
    assert packed == {0, 1}
    for m, k in BLUE_BY_M.items():
        plan = tstft.bluestein_plan(k)
        H = m // plan.ranks
        cr = ConvRegisters(plan.stages.tolist()[:len(plan.stages)
                                                - (plan.ranks - 1)],
                           H, True, H)
        assert cr.rmax == 0 and cr.threads == fft_threads(2 * H)
        assert H <= BLOCK_POINTS and len(cr.passes) <= max_passes


def test_geometry_constants_are_the_sources():
    """The transcription's constants and formulas are the CUDA source's:
    the planner's grouping (smaller first), the turn-around's condition,
    the swizzle, the block's widening, the roots' places, the products and
    the reads."""
    assert (MAX_THREADS, SMALL_ROOTS, R2_BITS) == (512, 16, 4)
    for line in (
            "const int i = n2 - 1 - pn;",
            "const int bits = twos / n2 + (i < twos % n2 ? 1 : 0);",
            "if (!group_passes(stages, n_stages, N, bits_max, plan->pass,",
            "plan->fuse = turn && (r0 % 2 == 0 || r0 <= 7) ? 1 : 0;",
            "ps.inner = make_fastdiv(ps.span);           // k fastest (KFAST)",
            "if (KFAST || ps.radix % 2 == 0) {",
            "mix_odd_pass<3, DIF, true>(buf, small + small_root_at(3), tw, ps, N,",
            "mix_generic_pass<0, RMAX, DIF, false, true>(buf, roots, tw, ps,",
            "mix_generic_pass<0, 1, DIF, true, true>(buf, roots, tw, ps, N, 1,",
            "plan->swz_mask = pow2 ? 7 : 0;",
            "plan->swz_shift = pow2 ? b0 : 0;",
            "const int pairs = ((p_max + 1) / 2 + 31) / 32 * 32;",
            "*threads = fft_threads(2 * width) > pairs ? fft_threads(2 * "
            "width) : pairs;",
            "if (N / ps.radix <= 16 || (pairs + rm - 1) / rm > *threads / 32)",
            "if (*rmax > 0 && narrow) *rmax = 1;",
            "const int per = static_cast<int>(blockDim.x) / (h + 1);",
            "const bool jfast = per > 1 && (per & (per - 1)) == 0;",
            "int m = jfast ? tid / per : tid % (h + 1);",
            "int j = jfast ? tid - m * per : tid / (h + 1);",
            "if (jfast && nbt - b0 < per) {",
            "m = tid / (nbt - b0);",
            "j = tid - m * (nbt - b0);",
            "const bool on = m <= h && j < per && b < nbt;",
            "return rmax == 1 || (rmax == 0 && (!rader || packed)) ? "
            "ODD_SMALL_BLOCKS : 1;",
            "odd_min_blocks(RADER, RMAX, PACKED))",
            "K / 2, PACKED_R2_BITS, &plan, &rmax, &threads) ||",
            "rader >= 0 ? RADER_NARROW_POINTS : ODD_NARROW_POINTS,",
            "bool narrow = width <= narrow_points;",
            "return s ^ ((s >> shift) & mask);",
            "return p == 3 ? 0 : (p == 5 ? 3 : 8);",
            "for (int q = plan.n_passes - 1; q >= plan.fuse; --q) {",
            "for (int b = threadIdx.x; b < N / R; b += blockDim.x) {",
            "for (int q = 0; q < R; ++q) v[q] = buf[map(b * R + q)];",
            "mix_r2_stages<B, true>(v, tw, ps, 0, 1);",
            "mix_r2_stages<B, false>(v, tw, ps, 0, 1);",
            "for (int q = 0; q < P; ++q) y[q] = buf[b * P + q];",
            "buf[map(s)] = product(s, buf[map(s)]);",
            "return make_double2(p.x, -p.y);",
            "if (s == 0) *sum = make_double2(x0->x + y.x, x0->y + y.y);",
            "b = cmul(w, make_double2(a0.x - b.x, a0.y - b.y));",
            "r2_dif_butterfly(v[i], v[i | (1 << S)], w);",
            "if (DIF && L > 1 && m > 0) {",
            "lo = cmul(tw[ps.tw[0] + (m - 1) * L + k], lo);",
            "hi = cmul(tw[ps.tw[0] + (p - m - 1) * L + k], hi);",
            "if (!DIF && L > 1) {",
            "const int variant = 4 * (rader >= 0) + (rmax == 1 ? 1 : rmax / 4 "
            "+ (rmax > 0));",
            "buf[map(j)] = cmul(tw[half_row + j], half0[map(j)]);",
            "const double2 t = cmul(tw[half_row + j], half1[map(j)]);",
            "BluesteinProduct{tw + bhat + rank * H});",
            "RaderProduct{tw + plan.rader, buf + map(P),",
            "const double2 v = buf[map(perm[i])];",
            "buf[map(perm[i])] = make_double2(va, vb);",
            "bufd[2 * map(perm[i >> 1]) + (i & 1)] =",
            "const int P = (K >> 1) - 1;",
            "split_psd_epilogue(ConvRaderRead{buf, perm, &x_sum, P, map},",
            "if (!conv_plan(stages, n_stages, K / 2 - 1, rader, split, true, "
            "K / 2,",
            "const int err = raise_smem(kernel, smem, odd_smem_set[8 + "
            "rmax]);"):
        assert " ".join(line.split()) in FLAT, line
    # the grouping at the driven configs: path 9 (M = 8192) and path 8's
    # ranks (8192 each) 8, 8, 8, 16 with the turn-around at radix 8 and
    # the swizzle; path 7 (P = 8190) 13, 7, 5, 3, 3, 2 with pass 0 generic
    # (no turn-around); 2049 (M = 4116 = 7^3 3 2^2) fused at radix 7
    got = {}
    for name, (stages, N, turn, width) in {
            "path 9": (tstft.bluestein_plan(8182).stages.tolist(), 8192,
                       True, 8192),
            "path 8": (tstft.bluestein_plan(8185).stages.tolist()[:-1], 8192,
                       True, 8192),
            "path 7": (tstft.fft_plan(8191).stages.tolist(), 8190, True,
                       8191),
            "2049": (tstft.bluestein_plan(2049).stages.tolist(), 4116, True,
                     4116)}.items():
        cr = ConvRegisters(stages, N, turn, width)
        got[name] = ([ps.radix for ps in cr.passes], cr.fuse, cr.mask,
                     cr.shift, cr.rmax, cr.threads)
    assert got == {"path 9": ([8, 8, 8, 16], True, 7, 3, 0, 512),
                   "path 8": ([8, 8, 8, 16], True, 7, 3, 0, 512),
                   "path 7": ([13, 7, 5, 3, 3, 2], False, 0, 0, 4, 512),
                   "2049": ([7, 7, 7, 3, 4], True, 0, 0, 0, 512)}
