"""The radix-2 FFT kernel's register design (csrc/stft_psd.cu::
stft_fft_psd_kernel<LOG2M>), held on the CPU through a numpy transcription
of its index arithmetic: which slots thread u holds in register i during
each pass, which table row each butterfly reads, where each value lives in
shared memory between passes, and how the threads load the frame.

The transcription (``Radix2``, below) is checked against the FFT route's
numpy model ``tools/torch_precision.py::psd_fft``, which the kernel's
arithmetic follows and which ``tests/test_torch_fft.py`` holds to the plain
version, the Pallas kernel and scipy:

- every butterfly of every stage of ``psd_fft`` runs exactly once, on the
  same two slots and with the same table row, and the stages run in
  ``psd_fft``'s order;
- on random frames, under every detrend and at every power of two from 32
  to 8192, the transcription's PSD equals ``psd_fft``'s bit for bit when
  both take the detrend line from the same sums, and within 1e-12 of each
  clip's largest bin when the transcription sums in the kernel's order (a
  thread's 16 samples, then a tree over the frame's threads);
- for every register, the threads of a frame load consecutive float2
  samples, a warp 32 of them where the frame spans one;
- every exchange's writes and reads, and the last pass's write of Z, are a
  bijection onto the frame's slots free of bank conflicts (16-byte values:
  a warp's access runs as four phases of eight lanes, each of which must
  hit eight different groups of four banks);
- the geometry constants of the CUDA source, parsed from it, are the ones
  the transcription uses, and every power of two fits a block's shared
  memory and register budget.

All of it is exact integer or bitwise arithmetic: no tolerance but the
one stated for the kernel's summation order.
"""

import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

from spectral_tpu_torch import SpecConfig  # noqa: E402
from spectral_tpu_torch.ops import stft_cuda  # noqa: E402
import torch_precision  # noqa: E402

FS = 16000.0
POWERS = [2 ** b for b in range(5, 14)]          # nperseg 32-8192
# (nperseg, log2 of the values a thread): 8 values at every size, 16 where
# a frame still takes two threads; the launcher picks one a size (R2_LR)
DESIGNS = [(K, 3) for K in POWERS] + [(K, 4) for K in POWERS if K >= 64]
BLOCK_SMEM = 232448          # shared memory a block may use (H100)
SM_SMEM = 233472             # an SM's shared memory (228 KB)
SM_REGISTERS = 65536
RESERVED_SMEM = 1024         # the runtime's share of each resident block


def _source():
    path = os.path.join(os.path.dirname(stft_cuda.__file__), "csrc",
                        "stft_psd.cu")
    with open(path) as fh:
        return fh.read()


def _constant(src, name):
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    assert m, name
    return int(m.group(1))


def _brev(x, bits):
    x = np.asarray(x)
    r = np.zeros_like(x)
    for b in range(bits):
        r |= ((x >> b) & 1) << (bits - 1 - b)
    return r


def _values_table():
    """The launcher's R2_LR: log2 of the values a thread, per log2 M."""
    m = re.search(r"constexpr int R2_LR\[13\] = \{([\d, ]+)\};", _source())
    assert m
    return [int(v) for v in m.group(1).split(",")]


class Radix2:
    """The kernel's index arithmetic at nperseg K with 2^LR values a thread
    (by default the launcher's R2_LR), transcribed from the CUDA source
    (R2Geometry, r2_base, r2_index, r2_slot, r2_stage, r2_pass,
    r2_epilogue)."""

    BLOCK = 256

    def __init__(self, K, LR=None):
        self.K = K
        self.M = K // 2
        self.m = self.M.bit_length() - 1
        self.LR = _values_table()[self.m] if LR is None else LR
        self.VALUES = 1 << self.LR
        self.P = self.M // self.VALUES
        self.frames = self.BLOCK // self.P if self.P <= 32 else 1
        self.threads = self.P * self.frames
        self.passes = (self.m + self.LR - 1) // self.LR
        self.smem = self.M * self.frames * 16
        self.min_blocks = 2 if self.LR == 3 else 1

    def base(self, q):
        """The register base bit s_q of pass q."""
        return min(self.LR * q, self.m - self.LR)

    def stages(self, q):
        """The stage bits pass q runs."""
        return range(self.LR * q, min(self.LR * (q + 1), self.m))

    def index(self, q, u, i):
        """The slot thread u holds in register i during pass q."""
        u = np.asarray(u)
        lr = self.LR
        if q == 0:
            return (_brev(u, self.m - lr) << lr) | i
        sb = self.base(q)
        return (u & ((1 << sb) - 1)) | (i << sb) | ((u >> sb) << (sb + lr))

    def slot(self, fl, p):
        """Where slot p of the block's frame fl lives in shared memory."""
        shift = max(self.LR, self.m - 3)
        mask = min(self.P, 8) - 1
        fl, p = np.asarray(fl), np.asarray(p)
        return fl * self.M + (p ^ (((fl * self.P) & 7) ^ ((p >> shift) & mask)))

    def butterflies(self, q):
        """Pass q's butterflies in the kernel's order: (stage bit s,
        register bit j, t, register pair (i, i + 2^j)) for each table-row
        group t, each thread running them all; ``row(u)`` below gives the
        row's index per thread."""
        sb = self.base(q)
        for s in self.stages(q):
            j = s - sb
            for t in range(1 << j):
                for hi in range(self.VALUES >> (j + 1)):
                    i = t | (hi << (j + 1))
                    yield s, j, t, i, i | (1 << j)

    def row(self, q, s, t, u):
        """The table row of stage s's butterflies with register bits t
        below the stage's bit, in thread u."""
        sb = self.base(q)
        return (1 << s) - 1 + ((np.asarray(u) & ((1 << sb) - 1)) | (t << sb))

    def load_index(self, i, u):
        """The packed value z[j] register i of thread u loads in pass 0."""
        return int(_brev(i, self.LR)) * self.P + np.asarray(u)


def _split(ar, ai, br, bi, wr, wi):
    """The split step: bin q's (re, im) from a = Z[q], b = Z[M - q] and w =
    W_K^q, as r2_epilogue computes it."""
    er, ei = 0.5 * (ar + br), 0.5 * (ai - bi)
    o_r, o_i = 0.5 * (ai + bi), 0.5 * (br - ar)
    return er + (wr * o_r - wi * o_i), ei + (wr * o_i + wi * o_r)


def _kernel_line(f, detrend, r2):
    """(mean, slope) per frame (Tn, 1) summed in the kernel's order: each
    thread its 8 registers' two samples in register order, then the
    frame's threads by an XOR tree (over 32 at most; past a warp each
    warp's sum added in warp order, block_sum)."""
    K = r2.K
    c = 0.5 * (K - 1)
    u = np.arange(r2.P)
    s0 = np.zeros((f.shape[0], r2.P))
    s1 = np.zeros((f.shape[0], r2.P))
    for i in range(r2.VALUES):
        i0 = 2 * r2.load_index(i, u)
        s0 = s0 + f[:, i0]
        s0 = s0 + f[:, i0 + 1]
        if detrend == "linear":
            s1 = s1 + (i0 - c) * f[:, i0]
            s1 = s1 + (i0 + 1 - c) * f[:, i0 + 1]

    def tree(s):
        lanes = min(r2.P, 32)
        off = lanes // 2
        while off:
            s = s + s[:, u ^ off]
            off //= 2
        if r2.P <= 32:
            return s[:, :1]
        total = np.zeros((s.shape[0], 1))
        for w in range(r2.P // 32):
            total = total + s[:, 32 * w:32 * w + 1]
        return total

    d = K * (float(K) * K - 1.0) / 12.0
    mean = tree(s0) / K
    slope = tree(s1) / d if detrend == "linear" else np.zeros_like(mean)
    return mean, slope


def psd_registers(frames, window, twiddles, wts, detrend="none",
                  kernel_sums=False, round_f32=True, LR=None):
    """(T, F) PSD of float frames by the kernel's passes, exchanges and
    epilogue with 2^LR values a thread (by default the launcher's), rounded
    to float32 unless round_f32 is False. The detrend
    line comes from ``torch_precision.detrended``'s sums, or with
    ``kernel_sums`` from the kernel's order (:func:`_kernel_line`)."""
    f = frames.astype(np.float64)
    Tn, K = f.shape
    r2 = Radix2(K, LR)
    M, P = r2.M, r2.P
    c = 0.5 * (K - 1)
    u = np.arange(P)
    if detrend == "none":
        mean = slope = np.zeros((Tn, 1))
    elif kernel_sums:
        mean, slope = _kernel_line(f, detrend, r2)
    else:
        mean = f.sum(axis=-1, keepdims=True) / K
        d = np.arange(K) - (K - 1) / 2.0
        slope = ((f * d).sum(axis=-1, keepdims=True)
                 / (K * (K * K - 1.0) / 12.0) if detrend == "linear"
                 else np.zeros_like(mean))
    # pass 0's loads, (Tn, P, 16): register i of thread u holds z[j]
    re = np.empty((Tn, P, r2.VALUES))
    im = np.empty((Tn, P, r2.VALUES))
    for i in range(r2.VALUES):
        i0 = 2 * r2.load_index(i, u)
        re[:, :, i] = (f[:, i0] - mean - slope * (i0 - c)) * window[i0]
        im[:, :, i] = (f[:, i0 + 1] - mean - slope * (i0 + 1 - c)) \
            * window[i0 + 1]
    fl = np.arange(Tn) % r2.frames       # each row's frame in its block
    buf_re = np.full((Tn, r2.frames * M), np.nan)
    buf_im = np.full((Tn, r2.frames * M), np.nan)
    rows = np.arange(Tn)[:, None, None]

    def where(q):
        p = np.stack([r2.index(q, u, i) for i in range(r2.VALUES)], axis=-1)
        return r2.slot(fl[:, None, None], p[None])

    for q in range(r2.passes):
        if q > 0:                        # write pass q - 1's, read pass q's
            buf_re[rows, where(q - 1)] = re
            buf_im[rows, where(q - 1)] = im
            re = buf_re[rows, where(q)]
            im = buf_im[rows, where(q)]
        for s, j, t, i, k in r2.butterflies(q):
            w = twiddles[r2.row(q, s, t, u)]
            wr, wi = w[:, 0], w[:, 1]
            ar, ai = re[:, :, i].copy(), im[:, :, i].copy()
            br, bi = re[:, :, k], im[:, :, k]
            tr = wr * br - wi * bi
            ti = wr * bi + wi * br
            re[:, :, i], im[:, :, i] = ar + tr, ai + ti
            re[:, :, k], im[:, :, k] = ar - tr, ai - ti
    # the last pass writes the natural-order Z; X[q] for q = 0 .. M from it
    buf_re[rows, where(r2.passes - 1)] = re
    buf_im[rows, where(r2.passes - 1)] = im
    g = np.arange(M + 1)
    za = r2.slot(fl[:, None], np.where(g == M, 0, g)[None])
    zb = r2.slot(fl[:, None], np.where(g == 0, 0, M - g)[None])
    t = np.arange(Tn)[:, None]
    last = np.minimum(g, M - 1)
    wr = np.where(g < M, twiddles[M - 1 + last, 0], -1.0)
    wi = np.where(g < M, twiddles[M - 1 + last, 1], 0.0)
    x_re, x_im = _split(buf_re[t, za], buf_im[t, za], buf_re[t, zb],
                        buf_im[t, zb], wr, wi)
    # bin f's power from X[min(f, K - f)] and its own weight
    F = wts.shape[0]
    fb = np.arange(F)
    g = np.minimum(fb, K - fb)
    xr, xi = x_re[:, g], x_im[:, g]
    p = xr * xr + xi * xi
    p = np.where(p > torch_precision.F32_MAX, np.inf, p * wts)
    return p.astype(np.float32) if round_f32 else p


def _cfg(K, detrend):
    if detrend == "none":
        return SpecConfig.north_star(K, K // 4)
    return SpecConfig(nperseg=K, hop=K // 4, detrend=detrend)


def _operands(cfg):
    return [t.numpy() for t in stft_cuda.fft_constants(cfg, FS, "cpu")]


@pytest.mark.parametrize("K, LR", DESIGNS)
def test_every_butterfly_of_psd_fft_runs_once_with_its_row(K, LR):
    """psd_fft's stage h (bit s) combines i0 and i0 + h, i0 = 2h (j div h)
    + j mod h, with row h - 1 + (i0 mod h): the passes run each such
    butterfly once, in a thread that holds both slots, with that row, and
    the stages in ascending order."""
    r2 = Radix2(K, LR)
    u = np.arange(r2.P)
    order = []
    for q in range(r2.passes):
        held = np.stack([r2.index(q, u, i) for i in range(r2.VALUES)],
                        axis=1)
        # the frame's threads hold every slot once in every pass
        assert np.array_equal(np.sort(held.ravel()), np.arange(r2.M))
        seen = {}
        for s, j, t, i, k in r2.butterflies(q):
            h = 1 << s
            i0, i1 = held[:, i], held[:, k]
            assert np.all((i0 & h) == 0) and np.array_equal(i1, i0 + h)
            assert np.array_equal(r2.row(q, s, t, u), h - 1 + (i0 % h))
            for a in i0.tolist():
                seen.setdefault(s, []).append(a)
            if not order or order[-1] != s:
                order.append(s)
        for s, got in seen.items():
            h = 1 << s
            jj = np.arange(r2.M // 2)
            want = 2 * h * (jj // h) + jj % h
            assert sorted(got) == sorted(want.tolist()), (K, s)
    assert order == list(range(r2.m))


@pytest.mark.parametrize("K, LR", DESIGNS)
def test_pass0_loads_are_the_bit_reversed_order_and_coalesce(K, LR):
    """Register i of thread u loads z[bitrev3(i) P + u], the value psd_fft
    stores at slot bitrev(j), which is the slot the thread holds; for each
    register the frame's threads read consecutive float2 samples (a warp's
    32 lanes 256 consecutive bytes where the frame spans a warp or more)
    and consecutive double2 window values."""
    r2 = Radix2(K, LR)
    u = np.arange(r2.P)
    rev = torch_precision.bit_reverse(r2.M)
    for i in range(r2.VALUES):
        j = r2.load_index(i, u)
        assert np.array_equal(r2.index(0, u, i), rev[j])
        assert np.array_equal(np.diff(j), np.ones(r2.P - 1, dtype=int))
        lanes = min(r2.P, 32)
        for w in range(0, r2.P, lanes):
            byte = 8 * j[w:w + lanes]
            assert np.array_equal(byte, 8 * j[w] + 8 * np.arange(lanes))


@pytest.mark.parametrize("K, LR", DESIGNS)
def test_exchanges_are_bijections_free_of_bank_conflicts(K, LR):
    """Every write and read between passes, and the last pass's write of
    Z: for each register, the block's threads address distinct slots of
    their own frame's M, and each eight neighbouring lanes of a warp land
    in eight different bank groups (slot mod 8). The epilogue's reads of
    Z[g] and Z[M - g] are at most two lanes to a group."""
    r2 = Radix2(K, LR)
    tid = np.arange(r2.threads)
    fl, u = tid // r2.P, tid % r2.P
    accesses = [(q, "write") for q in range(r2.passes)]
    accesses += [(q, "read") for q in range(1, r2.passes)]
    for q, kind in accesses:
        slots = np.stack([r2.slot(fl, r2.index(q, u, i))
                          for i in range(r2.VALUES)], axis=1)
        assert np.array_equal(np.sort(slots.ravel()),
                              np.arange(r2.frames * r2.M)), (q, kind)
        assert np.all(slots // r2.M == fl[:, None])
        for i in range(r2.VALUES):
            groups = (slots[:, i] % 8).reshape(-1, 8)
            assert all(len(set(g)) == 8 for g in groups.tolist()), (q, kind, i)
    F = r2.M + 1
    worst = 0
    for it in range(-(-F // r2.P)):
        f = u + r2.P * it
        ok = f < F
        g = np.where(f <= r2.M, f, r2.K - f)
        for p in (np.where(g == r2.M, 0, g), np.where(g == 0, 0, r2.M - g)):
            groups = np.where(ok, r2.slot(fl, p) % 8, -1 - tid).reshape(-1, 8)
            for grp in groups.tolist():
                live = [b for b in grp if b >= 0]
                if live:
                    worst = max(worst, max(live.count(b) for b in live))
    assert worst <= 2


@pytest.mark.parametrize("detrend", ["none", "constant", "linear"])
@pytest.mark.parametrize("K, LR", DESIGNS)
def test_transcription_equals_psd_fft_bitwise(K, LR, detrend):
    """Random frames (noise + 3; under linear detrend a ramp), one more row
    than a block's frames where a block holds several, so a second block
    starts: the passes, exchanges and epilogue give psd_fft's float32 PSD
    bit for bit from the same detrend sums, and within 1e-12 of each
    frame's largest bin in float64 from the kernel's own summation order;
    NaN and inf propagate as in psd_fft."""
    rs = np.random.RandomState(K + len(detrend))
    cfg = _cfg(K, detrend)
    r2 = Radix2(K, LR)
    rows = max(r2.frames + 1, 4)
    frames = rs.randn(rows, K) + 3.0
    if detrend == "linear":
        frames += torch_precision.trend(K)
    frames[1, K // 3] = np.nan
    frames[2] *= 1e19
    frames = frames.astype(np.float32)
    ops = _operands(cfg)
    want = torch_precision.psd_fft(frames, *ops, detrend=detrend)
    got = psd_registers(frames, *ops, detrend=detrend, LR=LR)
    assert np.isnan(got[1]).all() and np.isinf(got[2]).any()
    assert np.array_equal(got, want, equal_nan=True)
    if detrend != "none":
        fine = np.isfinite(want).all(axis=1)
        want64 = torch_precision.psd_fft(frames[fine], *ops, detrend=detrend,
                                         round_f32=False)
        own = psd_registers(frames[fine], *ops, detrend=detrend,
                            kernel_sums=True, round_f32=False, LR=LR)
        scale = want64.max(axis=1, keepdims=True)
        err = np.abs(own - want64) / scale
        assert np.all(err <= 1e-12), err.max()


def test_geometry_constants_are_the_sources():
    """The transcription's constants and formulas are the CUDA source's
    (R2Geometry, r2_base, r2_index, r2_slot, r2_stage, the kernel's frame
    and row, the launcher's table and cases), and in both designs at every
    power of two a block fits: whole warps up to R2_MAX_THREADS, its
    buffers beside the static reduction arrays within a block's 232,448
    bytes, and as many resident blocks as the launch bounds' registers (64
    a thread with 8 values, 128 with 16) allow within an SM's shared
    memory, so registers, not shared memory, set the warps an SM holds."""
    src = _source()
    assert _constant(src, "R2_BLOCK") == Radix2.BLOCK
    max_threads = _constant(src, "R2_MAX_THREADS")
    assert _constant(src, "BLOCK_SMEM") == BLOCK_SMEM
    assert ("__launch_bounds__(R2_MAX_THREADS,\n"
            "                                  R2Geometry<LOG2M, LR>::"
            "MIN_BLOCKS)\nstft_fft_psd_kernel(") in src
    for line in ("static constexpr int VALUES = 1 << LR;",
                 "static constexpr int P = M >> LR;",
                 "static constexpr int FRAMES = P <= 32 ? R2_BLOCK / P : 1;",
                 "static constexpr int THREADS = P * FRAMES;",
                 "static constexpr int PASSES = (LOG2M + LR - 1) / LR;",
                 "static constexpr int SMEM = M * FRAMES * 16;",
                 "static constexpr int MIN_BLOCKS = LR == 3 ? 2 : 1;",
                 "constexpr int R2_WARPS = R2_MAX_THREADS / 32;",
                 "return LR * Q < LOG2M - LR ? LR * Q : LOG2M - LR;",
                 "return (t << LR) | i;",
                 "return (u & ((1 << SB) - 1)) | (i << SB) | "
                 "((u >> SB) << (SB + LR));",
                 "constexpr int SHIFT = LOG2M - 3 > LR ? LOG2M - 3 : LR;",
                 "constexpr int MASK = (G::P < 8 ? G::P : 8) - 1;",
                 "return fl * G::M + (p ^ (((fl * G::P) & 7) ^ "
                 "((p >> SHIFT) & MASK)));",
                 "constexpr int R2_STATIC_SMEM = R2_WARPS * (16 + 4 + 4);",
                 "const double2 w = row[t << SB];",
                 "const int j = brev_low(i, LR) * P + u;",
                 "const int fl = ALONE ? 0 : "
                 "static_cast<int>(threadIdx.x) / P;",
                 "const bool valid = ALONE || r < R;",
                 "constexpr int LR = R2_LR[LOG2M];"):
        assert line in src, line
    static = (max_threads // 32) * (16 + 4 + 4)
    cases = [int(c) for c, _ in re.findall(
        r"case (\d+):\n\s+return r2_launch<(\1)>", src)]
    assert cases == list(range(4, 13))
    for K, LR in DESIGNS:
        r2 = Radix2(K, LR)
        regs = SM_REGISTERS // (max_threads * r2.min_blocks)
        assert regs == {3: 64, 4: 128}[LR]
        assert r2.P >= 2 and r2.threads % 32 == 0
        assert r2.threads <= max_threads
        assert r2.frames * r2.P == r2.threads and r2.P * r2.VALUES == r2.M
        assert r2.smem + static <= BLOCK_SMEM
        resident = min(32, SM_REGISTERS // (regs * r2.threads))
        assert resident * (r2.smem + static + RESERVED_SMEM) <= SM_SMEM
    # the launched design: two threads a frame at 32, a warp at 512, a
    # block of 2 warps at the display spine's 1024 and of 8 at 8192
    seen = {K: (Radix2(K).LR, Radix2(K).P, Radix2(K).frames,
                Radix2(K).passes) for K in POWERS}
    assert seen[32] == (3, 2, 128, 2)
    assert seen[512] == (3, 32, 8, 3)
    assert seen[1024] == (3, 64, 1, 3)
    assert seen[2048] == (4, 64, 1, 3)
    assert seen[8192] == (4, 256, 1, 3)


def test_values_a_thread_cross_over_at_2048():
    """The launcher's table: 8 values a thread up to nperseg 1024, 16 from
    2048, where the card measured each the faster (PERF.md; on
    path 1, 1024, 8 values; on path 2, 8192, 16)."""
    table = _values_table()
    assert table[4:] == [3, 3, 3, 3, 3, 3, 4, 4, 4]
    assert [Radix2(K).VALUES for K in POWERS] == [8] * 6 + [16] * 3
