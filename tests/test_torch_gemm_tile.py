"""The GEMM route's small-K tile (csrc/stft_psd.cu::stft_psd_small_kernel,
launched by stft_psd_launch where F <= SK_MAX_F: nperseg 2-31), held on
the CPU through a numpy transcription of its index arithmetic
(``SmallTile``, below): which rows a block takes, where each row's frame
lies in the block's staged span (rows of one clip overlapping as their
frames do, a new span past a clip's edge, each sample copied once), the
depth padded to a multiple of SK_K_STEP, which bins each thread sums, the
output staged at an odd row stride and stored as one contiguous run, and
the per-row (min, max) partials combined over the threads' bin groups.

The transcription is held to the plain version (``stft_psd_reference``,
float64 matmuls rounded once to float32): its sums run k ascending as the
kernel's DFMA chains do, but numpy rounds each product where the card
fuses it, so the float32 PSD is held to 1e-6 of each clip's largest bin
(float64 rounding, far below float32's) and NaN to the same bins. Every
staged sample is checked against the signal where a row reads it, and a
sample no row staged is NaN in the transcription's buffer, so a row that
read one would show. Then the port against the JAX package end to end at
scipy_default 24 (path 10's config) and 7 on the CPU.
"""

import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spectral_tpu_torch import SpecConfig  # noqa: E402
from spectral_tpu_torch.core.stft import num_frames  # noqa: E402
from spectral_tpu_torch.ops import stft_cuda  # noqa: E402
from test_torch_pipeline import (_assert_same_display,  # noqa: E402
                                 batched_spectrogram_fn, jax_pipeline)

FS = 16000.0
TOL = 1e-6              # of each clip's largest bin: float64 roundings
SRC = os.path.join(os.path.dirname(stft_cuda.__file__), "csrc",
                   "stft_psd.cu")
with open(SRC) as _fh:
    _TEXT = _fh.read()
FLAT = " ".join(_TEXT.split())


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _TEXT).group(1))


THREADS = _constant("SK_THREADS")
MAX_F = _constant("SK_MAX_F")
BINS = _constant("SK_BINS")
K_STEP = _constant("SK_K_STEP")


class SmallTile:
    """stft_psd_small_kernel's geometry for (R rows of T a clip, F bins,
    nperseg K, hop), as the launcher sizes it."""

    def __init__(self, R, T, F, K, hop):
        assert F <= MAX_F and T >= 1
        self.R, self.T, self.F, self.K, self.hop = R, T, F, K, hop
        self.groups = 2 if F > BINS else 1
        self.tpg = THREADS // self.groups
        self.rb = 2 * self.tpg
        self.kp = -(-K // K_STEP) * K_STEP
        self.fs = F | 1
        self.stage = self.rb * max(K, self.fs)
        self.s = min(hop, K)
        self.blocks = -(-R // self.rb)

    def rows(self, r0):
        """off, first and src of the block's rows (the row table)."""
        i = np.arange(self.rb)
        r = r0 + i
        b, t = r // self.T, r % self.T
        off = i * self.s + (b - r0 // self.T) * (self.K - self.s)
        first = np.where((i == 0) | (t == 0), 0, self.K - self.s)
        return off, first, b, t

    def staged(self, x, r0):
        """The block's staged span: the element loop's cp.async copies,
        e < RB K, row e div K, sample e mod K; NaN where nothing lands."""
        off, first, b, t = self.rows(r0)
        xs = np.full(self.stage, np.nan, np.float32)
        e = np.arange(self.rb * self.K)
        i, k = e // self.K, e % self.K
        on = (r0 + i < self.R) & (k >= first[i])
        at = off[i] + k
        assert np.unique(at[on]).size == on.sum()   # each slot once
        xs[at[on]] = x[b[i[on]], t[i[on]] * self.hop + k[on]]
        return xs, off

    def block(self, x, a_re, a_im, wts, r0, log10_out=False):
        """One block: its rows' PSD as stored, and their (min, max)."""
        xs, off = self.staged(x, r0)
        rows = min(self.R - r0, self.rb)
        K, F, kp = self.K, self.F, self.kp
        for i in range(rows):                      # every row reads its frame
            b, t = divmod(r0 + i, self.T)
            assert np.array_equal(xs[off[i]:off[i] + K],
                                  x[b, t * self.hop:t * self.hop + K],
                                  equal_nan=True)
        assert off[self.rb - 1] + K <= self.rb * K <= self.stage
        ar = np.zeros((kp, F))
        ai = np.zeros((kp, F))
        ar[:K], ai[:K] = a_re, a_im
        nb = -(-F // self.groups)
        os_ = np.zeros(self.stage, np.float32)
        red = np.zeros((2 * self.groups, self.rb), np.float32)
        for g in range(self.groups):
            f0 = g * nb
            fn = min(F - f0, nb)
            ia = np.arange(self.tpg)
            for i in (ia, ia + self.tpg):          # a thread's two rows
                re = np.zeros((self.tpg, fn))
                im = np.zeros((self.tpg, fn))
                for k in range(kp):                # k ascending, k < KP
                    v = (xs[off[i] + k].astype(np.float64) if k < K
                         else np.zeros(self.tpg))
                    re = re + v[:, None] * ar[k, f0:f0 + fn]
                    im = im + v[:, None] * ai[k, f0:f0 + fn]
                s = re * re + im * im
                pw = np.where(s > stft_cuda.F32_MAX, np.inf,
                              s * wts[f0:f0 + fn])
                p = pw.astype(np.float32)
                stored = (np.log10(pw + 1e-20).astype(np.float32)
                          if log10_out else p)
                os_[(i * self.fs)[:, None] + f0 + np.arange(fn)] = stored
                nan = np.isnan(p).any(axis=1)
                red[g, i] = np.where(nan, np.nan, p.min(axis=1))
                red[self.groups + g, i] = np.where(nan, np.nan,
                                                   p.max(axis=1))
        e = np.arange(rows * F)                    # the contiguous store
        out = os_[(e // F) * self.fs + e % F]
        lo = red[:self.groups, :rows]
        hi = red[self.groups:, :rows]
        lo = np.where(np.isnan(lo).any(0), np.nan, lo.min(0))
        hi = np.where(np.isnan(hi).any(0), np.nan, hi.max(0))
        return out.reshape(rows, F), lo, hi

    def run(self, x, consts, log10_out=False):
        a_re, a_im, wts = (c.numpy() for c in consts)
        outs = [self.block(x, a_re, a_im, wts, blk * self.rb, log10_out)
                for blk in range(self.blocks)]
        return tuple(np.concatenate(o) for o in zip(*outs))


def _tile_and_plain(cfg, x, log10_out=False):
    B, n = x.shape
    T = num_frames(n, cfg.nperseg, cfg.hop_)
    F = cfg.n_freqs
    consts = stft_cuda.dft_constants(cfg, FS, "cpu")
    want = stft_cuda.stft_psd_reference(torch.from_numpy(x), consts, cfg,
                                        log10_out=log10_out)
    if T <= 0:
        return None, want.numpy()
    tile = SmallTile(B * T, T, F, cfg.nperseg, cfg.hop_)
    out, lo, hi = tile.run(x, consts, log10_out)
    return (tile, out.reshape(B, T, F), lo.reshape(B, T),
            hi.reshape(B, T)), want.numpy()


def _close(got, want):
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = np.isfinite(want)
    scale = np.where(ok, np.abs(want), 0).max(axis=(1, 2))
    diff = np.where(ok, np.abs(got - want), 0).max(axis=(1, 2))
    assert np.all(diff <= TOL * scale), diff / scale


@pytest.mark.parametrize("k", range(2, 32))
def test_small_tile_equals_the_plain_version(k):
    """Each nperseg 2-31: hop below nperseg (rows overlapping in the
    span) with a NaN sample in one clip, hop past it (each row its own
    span), and rows of several clips in a block (7 clips of a few
    frames); T = 0 gives the plain version's empty PSD and no grid. The
    transcription's PSD and per-row partials are the plain version's."""
    rs = np.random.RandomState(k)
    seen_edges = 0
    for cfg, n in ((SpecConfig(nperseg=k, hop=max(1, k // 3),
                               detrend="constant"), 40 * k),
                   (SpecConfig(nperseg=k, hop=k + 3, detrend="linear"),
                    k + 9 * (k + 3)),
                   (SpecConfig.scipy_default(k), 600)):
        x = (rs.randn(7, n) + 2.0).astype(np.float32)
        x[3, num_frames(n, k, cfg.hop_) // 2 * cfg.hop_] = np.nan
        (tile, out, lo, hi), want = _tile_and_plain(cfg, x)
        assert cfg.n_freqs <= MAX_F and tile.blocks >= 1
        _close(out, want)
        rows = want.reshape(-1, cfg.n_freqs)
        nan = np.isnan(rows).any(axis=1)
        assert np.array_equal(np.isnan(lo.ravel()), nan)
        assert np.array_equal(lo.ravel()[~nan], rows[~nan].min(axis=1))
        assert np.array_equal(hi.ravel()[~nan], rows[~nan].max(axis=1))
        assert nan.any() and not nan.all()
        off, first, b, t = tile.rows(0)
        seen_edges += int((b[:tile.R] != b[0]).any())
    assert seen_edges == 3        # every config's first block crosses clips
    x0 = rs.randn(2, k - 1).astype(np.float32)              # T = 0
    none, want = _tile_and_plain(SpecConfig.scipy_default(k), x0)
    assert none is None and want.shape == (2, 0, SpecConfig.scipy_default(
        k).n_freqs)


@pytest.mark.parametrize("k", [2, 13, 24, 31])
def test_small_tile_log10_and_overflow(k):
    """log10_out stores log10(p + 1e-20) of the same sums; a 1e19 clip
    overflows float32's |X|^2 to inf as the plain version does."""
    rs = np.random.RandomState(40 + k)
    cfg = SpecConfig(nperseg=k, hop=max(1, k // 4))
    x = np.stack([rs.randn(30 * k), 1e19 * rs.randn(30 * k)]).astype(
        np.float32)
    (_, out, lo, hi), want = _tile_and_plain(cfg, x)
    assert np.isinf(want[1]).any() and np.array_equal(np.isinf(out),
                                                      np.isinf(want))
    assert np.isinf(hi[1]).any() and np.isfinite(hi[0]).all()
    (_, out, _, _), want = _tile_and_plain(cfg, x[:1], log10_out=True)
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-6)


def test_small_tile_geometry_is_the_sources():
    """The transcription's constants and formulas are the CUDA source's,
    and the launcher takes the tile at every F up to SK_MAX_F with K
    below 32: each nperseg 2-31 one-sided, and two-sided up to 16, whole
    or banded; the large tile keeps F past it (nperseg 32 one-sided and
    up, forced) and every band of a forced nperseg from 32."""
    assert (THREADS, MAX_F, BINS, K_STEP) == (256, 16, 8, 4)
    for line in (
            "if (F <= SK_MAX_F && K < 2 * SK_MAX_F) {",
            "const int groups = F > SK_BINS ? 2 : 1;",
            "const int rb = 2 * SK_THREADS / groups;",
            "const int RB = 2 * tpg;",
            "const int tpg = SK_THREADS / groups;",
            "const int KP = (K + SK_K_STEP - 1) / SK_K_STEP * SK_K_STEP;",
            "const int FS = F | 1;",
            "const int stage = RB * (K > FS ? K : FS);",
            "const int s = hop < K ? hop : K;",
            "off[i] = i * s + (b - b0) * (K - s);",
            "first[i] = i == 0 || t == 0 ? 0 : K - s;",
            "if (r0 + i < R && k >= first[i])",
            "cp_async_f32(xs + off[i] + k, x + src[i] + k);",
            "const int nb = (F + groups - 1) / groups;",
            "const int f0 = g * NB;",
            "const int fn = F - f0 < NB ? F - f0 : NB;",
            "const auto kernel = by_nb[nb - 1];",
            "const double va = k < K ? static_cast<double>(xa[k]) : 0.0;",
            "re[0][j] = fma(va, a.x, re[0][j]);",
            "os[i * FS + f0 + j] =",
            "dst[e] = os[i * FS + (e - i * F)];",
            "for (int gg = 1; gg < groups; ++gg) {",
            "if (K < 1 || T < 1 || hop < 1)"):
        assert " ".join(line.split()) in FLAT, line
    import dataclasses
    for k in range(2, 32):
        assert SpecConfig.scipy_default(k).n_freqs <= MAX_F
        two = dataclasses.replace(SpecConfig.scipy_default(k),
                                  onesided=False)
        assert (two.n_freqs <= MAX_F) == (k <= MAX_F)
    assert SpecConfig.scipy_default(32).n_freqs > MAX_F


@pytest.mark.parametrize("k", [7, 24])
def test_port_matches_jax_pipeline_below_32(k):
    """batched_spectrogram_fn at scipy_default 24 (path 10's config) and 7
    on the CPU, the port (the GEMM route's plain version) against the JAX
    package's matmul route on the same clips (noise + 3), at
    tests/test_torch_pipeline.py's tolerances."""
    cfg = SpecConfig.scipy_default(k, log_scale=True)
    x = (np.random.RandomState(k).randn(2, 4000) + 3.0).astype(np.float32)
    ref = jax.jit(jax_pipeline(FS, cfg, use_matmul=True,
                               flip_image=True))(jnp.asarray(x))
    port = batched_spectrogram_fn(FS, cfg, flip_image=True)(
        torch.from_numpy(x))
    _assert_same_display(port, ref)
