"""The mixed-radix kernel's pass design (csrc/stft_psd.cu::
stft_mixed_fft_psd_kernel<THREADS>, its planner mixed_register_plan), held
on the CPU through a numpy transcription of its geometry: which frames a
block holds and how many threads each frame takes, how the plan's stages
group into passes, which butterfly each thread runs in each pass (and in a
generic pass which output pairs), which slots and twiddle rows those
butterflies touch, and how the threads load the frame.

The transcription (``MixedRegisters``, below) is checked against the
mixed-radix route's numpy model ``tools/torch_precision.py::psd_mixed_fft``,
which the kernel's arithmetic follows and which
``tests/test_torch_mixed_fft.py`` holds to the plain version, the Pallas
kernel and scipy:

- every butterfly of every stage of the plan runs exactly once, on the
  same slots and with the same twiddle rows, and the stages in the plan's
  order, for each of the GUI's 247 values that take the route;
- on random frames, under every detrend, the transcription's PSD equals
  ``psd_mixed_fft``'s bit for bit when both take the detrend line from the
  same sums, and within 1e-12 of each frame's largest bin in float64 from
  the kernel's own summation order (a thread's pairs, then a tree over the
  frame's threads);
- every pass's reads and writes are a bijection onto the block's slots; in
  every pass but a radix-2 one at a span that is no multiple of 8 each
  eight neighbouring lanes of a warp hit eight bank groups (16-byte values:
  a warp's access runs as four phases of eight lanes), at most three lanes
  a group there; a generic pass's warp reads one root at a time (a
  broadcast);
- the frame loads are consecutive float2 samples across a frame's threads,
  every sample once;
- the host-made divisions by multiplication are exact wherever the kernel
  divides, and the geometry constants of the CUDA source, parsed from it,
  are the ones the transcription uses; every one of the route's 2,660
  values without a Rader stage is a plan the launcher takes and fits a
  block.

All of it is exact integer or bitwise arithmetic: no tolerance but the one
stated for the kernel's summation order.
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
from spectral_tpu_torch.core import stft as tstft  # noqa: E402
from spectral_tpu_torch.ops import stft_cuda  # noqa: E402
import torch_precision  # noqa: E402

FS = 16000.0
GUI = range(32, 8193, 32)
MIXED_GUI = [k for k in GUI if k & (k - 1)]
BLOCK_SMEM = 232448          # shared memory a block may use (H100)
SAMPLES = [96, 100, 120, 160, 192, 224, 240, 386, 992, 4192, 4576, 6068,
           6144, 8032, 8160]


def _source():
    path = os.path.join(os.path.dirname(stft_cuda.__file__), "csrc",
                        "stft_psd.cu")
    with open(path) as fh:
        return fh.read()


def _constant(src, name):
    m = re.search(rf"constexpr int {name} = (\w+);", src)
    assert m, name
    v = m.group(1)
    return int(v) if v.isdigit() else _constant(src, v)


SRC = _source()
FLAT = " ".join(SRC.split())            # the source, whitespace collapsed
THREADS = _constant(SRC, "MIX_THREADS")
LOAD = _constant(SRC, "MIX_LOAD")
R2_BITS = _constant(SRC, "MIX_R2_BITS")
NARROW_RADIX = _constant(SRC, "MIX_NARROW_RADIX")
MAX_PASSES = _constant(SRC, "MIX_MAX_PASSES")


def rmax_of(p_max):
    """mix_rmax: the output pairs a generic lane holds, by the plan's
    largest radix (none: no generic pass)."""
    return 0 if p_max <= 7 else (4 if p_max <= NARROW_RADIX else 8)


COMPILE_TIME_PRIMES = (11, 13, 17, 19, 23, 29, 31)


def rm_of(p, rmax):
    """mix_rm: a generic lane's output pairs, rmax at run time, as even
    groups of at most rmax for a prime instantiated at compile time."""
    if p not in COMPILE_TIME_PRIMES:
        return rmax
    pairs = (p + 1) // 2
    groups = -(-pairs // rmax)
    return -(-pairs // groups)


def fastdiv(d):
    """make_fastdiv: (mul, shift) of the division by d."""
    shift = 0
    while (1 << shift) < d:
        shift += 1
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift


def fastdiv_apply(x, d):
    """FastDiv::div: (umulhi(x, mul) + x) >> shift, 32-bit."""
    mul, shift = fastdiv(d)
    x = np.asarray(x, np.uint64)
    return ((((x * np.uint64(mul)) >> np.uint64(32)) + x)
            >> np.uint64(shift)).astype(np.int64)


class Pass:
    def __init__(self, radix, span, rows, root, M):
        self.radix, self.span, self.rows, self.root = radix, span, rows, root
        self.nb = M // radix                   # butterflies a frame
        # radix 2: k = j mod L fastest; odd: group j mod G fastest
        self.inner = span if radix % 2 == 0 else M // (span * radix)
        self.lp = span * radix


def group_passes(stages, M, bits_max=None):
    """group_passes: each odd stage of the plan's (p, L, row, root) rows a
    pass, then the twos, a of them, in ceil(a / bits_max) passes of as even
    a number of stages each (bits_max R2_BITS unless given: the PACKED
    plans' PACKED_R2_BITS), the smaller first."""
    bits_max = bits_max or R2_BITS
    passes, twos = [], []
    for p, L, row, root in stages:
        if p % 2:
            assert not twos
            passes.append(Pass(p, L, [row], root, M))
        else:
            twos.append((L, row))
    a = len(twos)
    n2 = -(-a // bits_max)
    s = 0
    for pn in range(n2):
        i = n2 - 1 - pn                         # smaller first
        bits = a // n2 + (i < a % n2)
        passes.append(Pass(2 ** bits, twos[s][0],
                           [r for _, r in twos[s:s + bits]], -1, M))
        s += bits
    return passes


class MixedRegisters:
    """The kernel's geometry at even nperseg K (no Rader stage),
    transcribed from the CUDA source (mixed_register_plan, mix_base,
    mix_r2_pass, mix_odd_pass, mix_generic_pass, the kernel's load and
    epilogue)."""

    def __init__(self, K):
        self.K = K
        self.M = M = K // 2
        self.plan = plan = tstft.fft_plan(K)
        assert plan.rader < 0
        stages = plan.stages.tolist()
        self.passes = group_passes(stages, M)
        p_max = max([p for p, _, _, _ in stages if p % 2] + [2])
        self.rmax = rmax_of(p_max)
        self.threads = THREADS
        self.load = LOAD
        pf = 1
        while pf * self.load < M:
            pf *= 2
        self.pf = pf
        self.frames = self.threads // pf

    def base(self, ps, b):
        """mix_base: butterfly b's first slot in the block's buffer and its
        k, through the kernel's divisions by multiplication."""
        b = np.asarray(b)
        f = fastdiv_apply(b, ps.nb)
        j = b - f * ps.nb
        L = ps.span
        if ps.radix % 2 == 0:
            g = fastdiv_apply(j, ps.inner)
            k = j - g * L
        else:
            k = fastdiv_apply(j, ps.inner)
            g = j - k * ps.inner
        return f * self.M + g * L * ps.radix + k, k

    def butterflies(self, ps):
        """The block's butterflies of pass ps in the order the threads take
        them: iteration it, thread t runs b = t + it * threads."""
        nbt = self.frames * ps.nb
        return np.arange(nbt)

    def generic_rounds(self, ps):
        """mix_generic_pass's assignment: for each round, (thread, b, m0)
        of the threads that are on."""
        p = ps.radix
        h = (p - 1) // 2
        rm = rm_of(p, self.rmax)
        groups = (h + rm) // rm
        nwarps = self.threads // 32
        per_round = nwarps // groups
        nbt = self.frames * ps.nb
        chunks = (nbt + 31) // 32
        tid = np.arange(self.threads)
        warp, lane = tid // 32, tid % 32
        m0 = (warp % groups) * rm
        chunk = warp // groups
        rounds = []
        for c0 in range(0, chunks, per_round):
            b = (c0 + chunk) * 32 + lane
            on = (chunk < per_round) & (b < nbt)
            rounds.append((tid[on], b[on], m0[on]))
        return rounds, groups, per_round

    def load_index(self, u, i):
        """The sample pair j thread u of a frame loads into register i."""
        return np.asarray(u) + i * self.pf


def _cmul(wr, wi, yr, yi):
    return wr * yr - wi * yi, wr * yi + wi * yr


def _kernel_line(v, mr):
    """(mean, slope) sums in the kernel's order per frame (T, K) of float
    samples: thread u its pairs j = u + i pf in ascending i, x[2j] then
    x[2j + 1]; then xor shuffles over min(pf, 32) lanes, then the frame's
    warps in order (mix_frame_sum)."""
    T, K = v.shape
    M, pf = mr.M, mr.pf
    c = 0.5 * (K - 1)
    u = np.arange(pf)
    s0 = np.zeros((T, pf))
    s1 = np.zeros((T, pf))
    for i in range(mr.load):
        j = mr.load_index(u, i)
        ok = j < M
        jj = np.minimum(j, M - 1)
        a, b = v[:, 2 * jj], v[:, 2 * jj + 1]
        s0 = np.where(ok, s0 + a, s0)
        s0 = np.where(ok, s0 + b, s0)
        s1 = np.where(ok, s1 + (2 * jj - c) * a, s1)
        s1 = np.where(ok, s1 + (2 * jj + 1 - c) * b, s1)

    def tree(s):
        lanes = min(pf, 32)
        off = lanes // 2
        while off:
            s = s + s[:, u ^ off]
            off //= 2
        if pf <= 32:
            return s[:, :1]
        t = s[:, :1]
        for w in range(1, pf // 32):
            t = t + s[:, 32 * w:32 * w + 1]
        return t

    return tree(s0), tree(s1)


def psd_registers(frames, window, wts, detrend="none", kernel_sums=False,
                  round_f32=True):
    """(T, F) PSD of float frames by the kernel's passes: the frames
    grouped into blocks of ``frames``, each pass's butterflies at the
    slots mix_base gives, radix-2 passes as mix_r2_pass's sub-stages,
    odd passes as mix_odd_pass, generic passes as mix_generic_pass (the
    twiddle pass at L > 1, then each output's sums with its root index
    stepped as the kernel steps it), then the split step and the PSD
    epilogue. The detrend line from ``torch_precision.detrended``'s sums,
    or with ``kernel_sums`` from the kernel's order (:func:`_kernel_line`)."""
    f = frames.astype(np.float64)
    Tn, K = f.shape
    mr = MixedRegisters(K)
    M, plan = mr.M, mr.plan
    tw = plan.twiddles
    c = 0.5 * (K - 1)
    d = np.arange(K) - c
    if detrend == "none":
        mean = slope = np.zeros((Tn, 1))
    elif kernel_sums:
        s0, s1 = _kernel_line(f, mr)
        mean = s0 / K
        slope = (s1 / (K * (K * K - 1.0) / 12.0) if detrend == "linear"
                 else np.zeros_like(mean))
    else:
        mean = f.sum(axis=-1, keepdims=True) / K
        slope = ((f * d).sum(axis=-1, keepdims=True)
                 / (K * (K * K - 1.0) / 12.0) if detrend == "linear"
                 else np.zeros_like(mean))
    v = (f - mean - slope * d) * window
    blocks = -(-Tn // mr.frames)
    rows = blocks * mr.frames
    re = np.zeros((rows, M))
    im = np.zeros((rows, M))
    re[:Tn, plan.perm] = v[:, 0::2]
    im[:Tn, plan.perm] = v[:, 1::2]
    re = re.reshape(blocks, mr.frames * M)
    im = im.reshape(blocks, mr.frames * M)
    for ps in mr.passes:
        L, R = ps.span, ps.radix
        base, k = mr.base(ps, mr.butterflies(ps))
        if R % 2 == 0:
            B = R.bit_length() - 1
            vr = [re[:, base + q * L].copy() for q in range(R)]
            vi = [im[:, base + q * L].copy() for q in range(R)]
            for s in range(B):
                for t in range(1 << s):
                    w = tw[ps.rows[s] + k + L * t]
                    for hi in range(R >> (s + 1)):
                        i = t | (hi << (s + 1))
                        j = i | (1 << s)
                        tr, ti = _cmul(w[:, 0], w[:, 1], vr[j], vi[j])
                        ar, ai = vr[i], vi[i]
                        vr[i], vi[i] = ar + tr, ai + ti
                        vr[j], vi[j] = ar - tr, ai - ti
            for q in range(R):
                re[:, base + q * L], im[:, base + q * L] = vr[q], vi[q]
            continue
        p, h = R, (R - 1) // 2
        roots = tw[ps.root:ps.root + p]
        if p > 7 and L > 1:                      # the generic twiddle pass
            s = np.arange(mr.frames * M)
            r = s - fastdiv_apply(s, ps.lp) * ps.lp
            on = r >= L
            w = tw[ps.rows[0] + r[on] - L]
            re[:, s[on]], im[:, s[on]] = _cmul(w[:, 0], w[:, 1], re[:, s[on]],
                                               im[:, s[on]])
        yr = [re[:, base + q * L].copy() for q in range(p)]
        yi = [im[:, base + q * L].copy() for q in range(p)]
        if p <= 7 and L > 1:
            for q in range(1, p):
                w = tw[ps.rows[0] + (q - 1) * L + k]
                yr[q], yi[q] = _cmul(w[:, 0], w[:, 1], yr[q], yi[q])
        for m in range(h + 1):
            ar, ai = yr[0].copy(), yi[0].copy()
            br = np.zeros_like(ar)
            bi = np.zeros_like(ar)
            if p > 31:
                rm = rm_of(p, mr.rmax)
                m0, i = m - m % rm, m % rm
            idx = 0
            for q in range(1, h + 1):
                if p > 31:                       # the kernel's stepped index:
                    idx += m0                    # q m0, then q steps of q
                    idx -= p if idx >= p else 0
                    t = idx
                    for _ in range(i):
                        t += q
                        t -= p if t >= p else 0
                    assert t == (q * m) % p
                else:
                    t = (q * m) % p
                cr, ci = roots[t]
                ar = ar + (yr[q] + yr[p - q]) * cr
                ai = ai + (yi[q] + yi[p - q]) * cr
                br = br + (yr[q] - yr[p - q]) * ci
                bi = bi + (yi[q] - yi[p - q]) * ci
            re[:, base + m * L], im[:, base + m * L] = ar - bi, ai + br
            if m:
                re[:, base + (p - m) * L] = ar + bi
                im[:, base + (p - m) * L] = ai - br
    re = re.reshape(rows, M)[:Tn]
    im = im.reshape(rows, M)[:Tn]
    return torch_precision._split_psd(re, im, tw[plan.split:], K, wts,
                                      round_f32)


def _phase_worst(addr, ok=None):
    """The most lanes of one 8-lane phase whose distinct 16-byte slots fall
    in one bank group (slot mod 8), over a (lanes,) address array."""
    addr = np.asarray(addr, np.int64)
    if ok is None:
        ok = np.ones(addr.shape, bool)
    pad = (-addr.size) % 8
    a = np.concatenate([addr, np.full(pad, -1)]).reshape(-1, 8)
    o = np.concatenate([ok, np.zeros(pad, bool)]).reshape(-1, 8)
    a = np.where(o, a, -1 - np.arange(a.size).reshape(a.shape) - 2 ** 40)
    a.sort(axis=1)
    dup = np.zeros(a.shape, bool)
    dup[:, 1:] = a[:, 1:] == a[:, :-1]
    live = (a >= 0) & ~dup
    counts = np.zeros((a.shape[0], 8), np.int64)
    for g in range(8):
        counts[:, g] = (live & (a % 8 == g)).sum(axis=1)
    return int(counts.max()) if counts.size else 0


def _pass_accesses(mr, ps):
    """(slots, ok) per access of pass ps over the block's lanes, and the
    kind of pass: each iteration's threads, for each value q."""
    if ps.radix % 2 == 0 or ps.radix <= 7:
        nbt = mr.frames * ps.nb
        for it in range(-(-nbt // mr.threads)):
            b = np.arange(mr.threads) + it * mr.threads
            ok = b < nbt
            base, _ = mr.base(ps, np.minimum(b, nbt - 1))
            for q in range(ps.radix):
                yield base + q * ps.span, ok
        return
    rounds, _, _ = mr.generic_rounds(ps)
    for tid, b, m0 in rounds:
        lanes = np.full(mr.threads, -1)
        ok = np.zeros(mr.threads, bool)
        base, _ = mr.base(ps, b)
        for q in range(ps.radix):
            lanes[tid] = base + q * ps.span
            ok[tid] = True
            yield lanes.copy(), ok.copy()


@pytest.mark.parametrize("nperseg", MIXED_GUI)
def test_every_butterfly_of_the_plan_runs_once_with_its_rows(nperseg):
    """The plan's stage (p, L) combines, for group g and k < L, the slots
    g L p + k + q L with rows (q - 1) L + k of its twiddles: the passes run
    each such butterfly once, radix-2 sub-stages on the values the thread
    holds with the row the stage gives that pair, odd passes on the whole
    butterfly, and the stages in the plan's order."""
    mr = MixedRegisters(nperseg)
    M = mr.M
    order = []
    for ps in mr.passes:
        base, k = mr.base(ps, mr.butterflies(ps))
        L, R = ps.span, ps.radix
        # each frame's butterflies cover its slots once
        slots = np.concatenate([base + q * L for q in range(R)])
        assert np.array_equal(np.sort(slots), np.arange(mr.frames * M))
        if R % 2:
            order.append((R, L))
            local = base % M
            assert np.array_equal(local % L, k)
            continue
        for s in range(R.bit_length() - 1):
            Ls = L << s
            seen = []
            for t in range(1 << s):
                for hi in range(R >> (s + 1)):
                    i = t | (hi << (s + 1))
                    i0 = base % M + i * L
                    i1 = base % M + (i | (1 << s)) * L
                    assert np.array_equal(i1 - i0, np.full(i0.size, Ls))
                    kk = i0 % (2 * Ls)
                    assert np.all(kk < Ls)
                    # the stage's row for butterfly k' = i0 mod 2L'
                    assert np.array_equal(ps.rows[s] + k + L * t,
                                          ps.rows[s] + kk)
                    seen.append(i0)
            got = np.sort(np.concatenate(seen))
            jj = np.arange(M // 2)
            want = np.sort(np.tile(2 * Ls * (jj // Ls) + jj % Ls, mr.frames))
            assert np.array_equal(got, want)
            order.append((2, Ls))
    assert order == [(p, L) for p, L, _, _ in mr.plan.stages.tolist()]
    # the radix-2 rows the passes read are the plan's, stage by stage
    rows = [r for ps in mr.passes if ps.radix % 2 == 0 for r in ps.rows]
    assert rows == [row for p, _, row, _ in mr.plan.stages.tolist()
                    if p == 2]


@pytest.mark.parametrize("nperseg", MIXED_GUI)
def test_exchanges_are_bijections_free_of_bank_conflicts(nperseg):
    """Every pass's accesses, for each value q of its butterflies: distinct
    slots of the block (of each warp in a generic pass); each eight
    neighbouring lanes in eight bank groups, but in a radix-2 pass whose
    span is no multiple of 8 (the first, at the odd part m', and a second
    after a first of fewer than three stages), whose rows of butterflies
    straddle the phases: at most three lanes a group there. A generic
    pass's warp has one output group (one root a step: a broadcast), and
    its rounds hold whole butterflies."""
    mr = MixedRegisters(nperseg)
    for ps in mr.passes:
        worst = 0
        for slots, ok in _pass_accesses(mr, ps):
            # a generic pass's warps of one chunk read the same butterflies
            # (each its own outputs): distinct slots within each warp
            scope = 32 if ps.radix % 2 and ps.radix > 7 else slots.size
            for w in range(0, slots.size, scope):
                live = slots[w:w + scope][ok[w:w + scope]]
                assert np.unique(live).size == live.size
            worst = max(worst, _phase_worst(slots, ok))
        # a radix-2 pass whose span is no multiple of 8 (the first, at the
        # odd part m', and after a first one of fewer than 3 stages)
        straddles = ps.radix % 2 == 0 and ps.span % 8
        assert worst <= (3 if straddles else 1), (ps.radix, ps.span, worst)
        if ps.radix % 2 and ps.radix > 7:
            rounds, groups, per_round = mr.generic_rounds(ps)
            assert groups <= mr.threads // 32 and per_round >= 1
            outputs = {}
            for r, (tid, b, m0) in enumerate(rounds):
                warp = tid // 32
                for w in np.unique(warp):
                    assert np.unique(m0[warp == w]).size == 1
                for bb, mm in zip(b.tolist(), m0.tolist()):
                    outputs.setdefault(bb, []).append((r, mm))
            h = (ps.radix - 1) // 2
            rm = rm_of(ps.radix, mr.rmax)
            assert sorted(outputs) == list(range(mr.frames * ps.nb))
            for got in outputs.values():
                assert len({r for r, _ in got}) == 1        # one round
                ms = sorted(m for _, m0 in got
                            for m in range(m0, m0 + rm) if m <= h)
                assert ms == list(range(h + 1))


@pytest.mark.parametrize("nperseg", MIXED_GUI)
def test_loads_are_consecutive_and_read_every_sample_once(nperseg):
    """Register i of a frame's thread u holds pair j = u + i pf: for each
    register the frame's threads read consecutive float2 samples, every
    pair of the frame once over the registers, none past M; and the
    scatter into the plan's slots is a bijection of the block."""
    mr = MixedRegisters(nperseg)
    u = np.arange(mr.pf)
    js = []
    for i in range(mr.load):
        j = mr.load_index(u, i)
        assert np.array_equal(np.diff(j), np.ones(mr.pf - 1, int))
        js.append(j[j < mr.M])
    assert np.array_equal(np.sort(np.concatenate(js)), np.arange(mr.M))
    assert mr.pf * mr.load >= mr.M and (mr.pf == 1
                                        or mr.pf * mr.load < 2 * mr.M)
    slots = (np.arange(mr.frames)[:, None] * mr.M
             + mr.plan.perm[None, :]).ravel()
    assert np.array_equal(np.sort(slots), np.arange(mr.frames * mr.M))


def _cfg(K, detrend):
    if detrend == "none":
        return SpecConfig.north_star(K, K // 4)
    return SpecConfig(nperseg=K, hop=K // 4, detrend=detrend)


@pytest.mark.parametrize("detrend", ["none", "constant", "linear"])
@pytest.mark.parametrize("nperseg", SAMPLES)
def test_transcription_equals_psd_mixed_fft_bitwise(nperseg, detrend):
    """Random frames (noise + 3; under linear detrend a ramp), one more row
    than a block's frames so a second, ragged block starts: the passes
    give psd_mixed_fft's float32 PSD bit for bit from the same detrend
    sums, and within 1e-12 of each frame's largest bin in float64 from the
    kernel's own summation order; NaN and inf propagate as there."""
    rs = np.random.RandomState(nperseg + len(detrend))
    cfg = _cfg(nperseg, detrend)
    mr = MixedRegisters(nperseg)
    rows = min(mr.frames + 1, 40) if mr.frames > 1 else 4
    frames = rs.randn(rows, nperseg) + 3.0
    if detrend == "linear":
        frames += torch_precision.trend(nperseg)
    frames[1, nperseg // 3] = np.nan
    frames[2] *= 1e19
    frames = frames.astype(np.float32)
    mc = stft_cuda.mixed_constants(cfg, FS, "cpu")
    window, wts = mc.window.numpy(), mc.wts.numpy()
    want = torch_precision.psd_mixed_fft(frames, window, mr.plan, wts,
                                         detrend=detrend)
    got = psd_registers(frames, window, wts, detrend=detrend)
    assert np.isnan(got[1]).all() and np.isinf(got[2]).any()
    assert np.array_equal(got, want, equal_nan=True)
    if detrend != "none":
        fine = np.isfinite(want).all(axis=1)
        want64 = torch_precision.psd_mixed_fft(frames[fine], window, mr.plan,
                                               wts, detrend=detrend,
                                               round_f32=False)
        own = psd_registers(frames[fine], window, wts, detrend=detrend,
                            kernel_sums=True, round_f32=False)
        scale = want64.max(axis=1, keepdims=True)
        err = np.abs(own - want64) / scale
        assert np.all(err <= 1e-12), err.max()


def _mixed_values():
    """Every nperseg 32-8192 that route() sends to the mixed kernel
    without a Rader stage."""
    out = []
    for k in range(32, 8193, 2):
        if k & (k - 1) == 0:
            continue
        cfg = SpecConfig(nperseg=k, hop=k // 4, detrend="constant")
        if (stft_cuda.route(cfg) == "mixed"
                and not tstft.rader_prime(k // 2)):
            out.append(k)
    return out


def test_divisions_by_multiplication_are_exact():
    """FastDiv (make_fastdiv's multiplier and shift) gives x div d for
    every divisor the planner makes on the route's 2,660 values (each
    pass's butterflies a frame, its span or groups, and span times radix)
    and every x the kernel divides: butterflies and slots of a block."""
    divisors = {}
    for k in _mixed_values():
        mr = MixedRegisters(k)
        top = mr.frames * mr.M
        for ps in mr.passes:
            for d in (ps.nb, ps.inner, ps.lp):
                divisors[d] = max(divisors.get(d, 0), top)
    for d, top in divisors.items():
        x = np.arange(top + 1)
        assert np.array_equal(fastdiv_apply(x, d), x // d), d


def test_every_mixed_value_fits_the_launcher_and_a_block():
    """Each of the 2,660 values: stages odd then twos (the planner refuses
    others), at most MIX_MAX_PASSES passes, a radix-2 pass of 2 to 16
    values, whole warps, a frame's threads a power of two within the
    block, and the block's frames within a block's shared memory beside
    the static arrays; the generic passes' output groups within the
    block's warps."""
    static = ((_constant(SRC, "MIX_MAX_RADIX") + 1) * 16
              + MAX_PASSES * 8 * 16 + (THREADS // 32) * 24)
    values = _mixed_values()
    assert len(values) == 2660 and set(MIXED_GUI) <= set(values)
    widest = 0
    for k in values:
        mr = MixedRegisters(k)
        assert len(mr.passes) <= MAX_PASSES
        assert mr.threads == THREADS and mr.threads % 32 == 0
        assert mr.pf <= mr.threads and mr.threads % mr.pf == 0
        assert mr.frames * mr.M * 16 + static <= BLOCK_SMEM
        widest = max(widest, mr.frames * mr.M)
        for ps in mr.passes:
            assert ps.radix % 2 or ps.radix <= 2 ** R2_BITS
            if ps.radix % 2 and ps.radix > 7:
                rm = rm_of(ps.radix, mr.rmax)
                groups = ((ps.radix - 1) // 2 + rm) // rm
                assert groups <= mr.threads // 32 and 0 < rm <= mr.rmax
    assert widest <= THREADS * LOAD


def test_geometry_constants_are_the_sources():
    """The transcription's constants and formulas are the CUDA source's:
    the planner's grouping, block and frame sizes, mix_base, the passes'
    rows and rounds, the load and the launch bounds."""
    assert (THREADS, LOAD, R2_BITS, NARROW_RADIX) == (512, 16, 4, 127)
    assert [rmax_of(p) for p in (3, 7, 11, 127, 131, 251)] == [0, 0, 4, 4, 8,
                                                                8]
    assert 65536 // THREADS == 128          # one block an SM: 128 registers
    assert MAX_PASSES == _constant(SRC, "MIX_MAX_STAGES")
    cases = [int(a) for a, b in re.findall(
        r"case (\d+):\s+mix_generic_pass<(\d+), RMAX>", SRC) if a == b]
    assert tuple(cases) == COMPILE_TIME_PRIMES
    assert [rm_of(p, 4) for p in COMPILE_TIME_PRIMES] == [3, 4, 3, 4, 4, 4,
                                                          4]
    assert [rm_of(p, 8) for p in COMPILE_TIME_PRIMES] == [6, 7, 5, 5, 6, 8,
                                                          8]
    # the compile-time primes' roots staged in the lanes' order: entry e =
    # ((g H) + q - 1) RM + i, every (group, step, pair) once, within the
    # kernel's roots array
    for p, rmax in zip(COMPILE_TIME_PRIMES * 2, [4] * 7 + [8] * 7):
        rm, h = rm_of(p, rmax), (p - 1) // 2
        groups = (h + rm) // rm
        e = np.arange(groups * h * rm)
        i, q, g = e % rm, (e // rm) % h + 1, e // (rm * h)
        assert np.array_equal(((g * h) + q - 1) * rm + i, e)
        assert e.size <= _constant(SRC, "MIX_MAX_RADIX") + 1
    for line in (
            "const int i = n2 - 1 - pn;",
            "const int bits = twos / n2 + (i < twos % n2 ? 1 : 0);",
            "const int n2 = (twos + bits_max - 1) / bits_max;",
            "!group_passes(stages, n_stages, N, MIX_R2_BITS, plan->pass,",
            "*rmax = mix_rmax(p_max);",
            "return p_max <= 7 ? 0 : (p_max <= MIX_NARROW_RADIX ? 4 : 8);",
            "while (pf * MIX_LOAD < N) pf *= 2;",
            "plan->frames = MIX_THREADS / pf;",
            "ps.inner = make_fastdiv(ps.radix % 2 ? N / lp : ps.span);",
            "ps.nb = make_fastdiv(N / ps.radix);",
            "ps.lp = make_fastdiv(lp);",
            "return (hi + v) >> shift;",
            "const unsigned long long num = (1ull << 32) * ((1ull << shift)"
            " - d);",
            "return FastDiv{d, static_cast<unsigned>(num / d + 1), shift};",
            "return f * M + g * L * ps.radix + k;",
            "const double2 w = tw[row + k + L * t];",
            "const int i = t | (hi << (S + 1));",
            "r2_butterfly(v[i], v[i | (1 << S)], w);",
            "if constexpr (B > 3) mix_r2_stage<R, 3>(v, tw, ps.tw[3], k, L);",
            "y[q] = cmul(tw[ps.tw[0] + (q - 1) * L + k], y[q]);",
            "const double2 c = roots[(q * m) % P];",
            "if (r >= L) buf[s] = cmul(tw[ps.tw[0] + r - L], buf[s]);",
            "const int groups = (h + RM) / RM;",
            "constexpr int RM = mix_rm<P, RMAX>();",
            "return P == 0 ? RMAX\n"
            "                : ((P + 1) / 2 + ((P + 1) / 2 + RMAX - 1) / "
            "RMAX - 1) /\n"
            "                      (((P + 1) / 2 + RMAX - 1) / RMAX);",
            "roots[e] = tw[ps.root + (q * (g * RM + i)) % P];",
            "const double2* rq = roots + (m0 / RM) * H * RM;",
            "for (int q = 1; q <= H; ++q, rq += RM) {",
            "const double2 c = rq[i];",
            "const int q = (e / RM) % H + 1;",
            "const int g = e / (RM * H);",
            "const int per_round = static_cast<int>(blockDim.x >> 5) / "
            "groups;",
            "const int m0 = (warp % groups) * RM;",
            "const int b = (c0 + chunk) * 32 + (tid & 31);",
            "const bool on = chunk < per_round && b < nbt;",
            "int t = idx;                           // q (m0 + i) mod p",
            "idx += m0;",
            "t += q;",
            "const int j = u + i * pf;",
            "fbuf[perm[j]] = make_double2(",
            "const int r = blockIdx.x * plan.frames + fl;",
            "__global__ void __launch_bounds__(MIX_THREADS, 1)"):
        assert " ".join(line.split()) in FLAT, line
    # MixedRegisters' grouping at the driven configs: 8160 (M = 2^4 17 5
    # 3) four passes on two frames a block, 8032 (2^4 251) two with 8
    # output pairs a generic lane, 992 two on sixteen frames, 6144 (2^10
    # 3) the twos' passes smaller first
    got = {k: ([ps.radix for ps in MixedRegisters(k).passes],
               MixedRegisters(k).rmax, MixedRegisters(k).frames)
           for k in (8160, 8032, 992, 96, 6144)}
    assert got == {8160: ([17, 5, 3, 16], 4, 2),
                   8032: ([251, 16], 8, 2),
                   992: ([31, 16], 4, 16),
                   96: ([3, 16], 0, 128),
                   6144: ([3, 8, 8, 16], 0, 2)}
