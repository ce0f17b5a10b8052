"""Transforms past 8192 in the port ([large-nperseg]): nperseg and nfft up
to 32,768, on the CPU.

- The config space: ``stft_cuda.route``, ``core.stft.bluestein_plan`` and
  its ranks, and ``unsupported_reason`` on every nfft from 8193 to 32,768
  and a sample past it; the ceilings and the ranks rule equal in Python
  and in ``csrc/stft_psd.cu``.
- Numpy models of the radix-2 kernel's parity split
  (``tools/torch_precision.py::psd_fft_split``) and of the Bluestein
  kernel's ranks on clusters of 2, 4 and 8 (``_bluestein_transform``),
  held to ``np.fft`` within 1e-12 of the frame's largest bin.
- The port's CPU path (the plain version past nperseg 8192: float64
  ``torch.fft``, no dense matrix) against the JAX package under
  ``jax.enable_x64`` on float64 input, within 1e-10 of the clip's largest
  value, at nperseg 16,384, 32,768, 20,000, 30,002 and 32,767, every
  detrend, the PSD, the magnitude and the complex STFT, two-sided,
  centered, banded, 64 mels, and nperseg 9,000 zero-padded to 16,384.
- The CPU gradient against ``jax.grad`` within 1e-9 of its largest entry;
  on a CUDA tensor that requires grad the refusal naming
  [large-nperseg] before any launch.
- No dense (nperseg, F) matrix built past 8192.
- The entry points past 8192 against the JAX package's: the pipeline with
  the band, the mel branch and the display tail, the export, the
  session's plot, the sweep grid and the command line's render.
"""

import collections
import dataclasses
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tools"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spectral_tpu import config as jconfig  # noqa: E402
from spectral_tpu.api import session as jsession  # noqa: E402
from spectral_tpu.core import stft as jstft  # noqa: E402
from spectral_tpu.io import registry as jreg  # noqa: E402
from spectral_tpu.parallel import pipeline as jpipe  # noqa: E402
from spectral_tpu.parallel import sharding as jsharding  # noqa: E402
from spectral_tpu.parallel import sweep_grid as jsg  # noqa: E402
from spectral_tpu_torch import SpecConfig, ViewSettings  # noqa: E402
from spectral_tpu_torch.api import session as tsession  # noqa: E402
from spectral_tpu_torch.core import stft as tstft  # noqa: E402
from spectral_tpu_torch.io import registry as treg  # noqa: E402
from spectral_tpu_torch.ops import stft_cuda  # noqa: E402
from spectral_tpu_torch.parallel import pipeline as tpipe  # noqa: E402
from spectral_tpu_torch.parallel import sharding  # noqa: E402
from spectral_tpu_torch.parallel import sweep_grid as tsg  # noqa: E402
import torch_precision as tp  # noqa: E402

FS = 16000.0
X64_TOL = 1e-10          # of the clip's largest value, float64 both sides
GRAD_TOL = 1e-9          # of the gradient's largest entry
MODEL_TOL = 1e-12        # of the frame's largest bin, the numpy models
F32_TOL = 2e-5           # float32 pipelines, of the clip's largest value
SOURCE = os.path.join(os.path.dirname(HERE), "spectral_tpu_torch", "ops",
                      "csrc", "stft_psd.cu")
LARGE = (16384, 32768, 20000, 30002, 32767)
DETRENDS = ("none", "constant", "linear")


def _j(cfg):
    return jconfig.SpecConfig.from_json(cfg.to_json())


def _signal(seed, k, frames=3, clips=2, offset=0.0):
    """float64 noise of ``frames`` frames at hop k // 2, plus offset and a
    ramp (so that every detrend removes something)."""
    n = k + (frames - 1) * (k // 2)
    rs = np.random.RandomState(seed)
    return rs.randn(clips, n) + offset + np.linspace(0.0, 4.0, n)


def _rel(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale)


# ---------------------------------------------------------------------------
# the config space
# ---------------------------------------------------------------------------

def test_routes_ranks_and_refusals_past_8192():
    """Every nfft from 8193 to 32,768: a power of two on the radix-2
    kernel, every other on the Bluestein kernel, never the GEMM kernel;
    the convolution length M >= 2N - 1, 2, 3, 5, 7-smooth, on the fewest
    ranks of 1, 2, 4 and 8 whose M / RANKS slots a block holds, M a
    multiple of RANKS and its last log2 RANKS stages radix 2 (the stages
    that cross the ranks): 3,107 lengths on one block, 10,309 on two,
    9,180 on four and 1,978 on eight. Past 32,768 the GEMM kernel keeps
    nperseg up to 8192, and nperseg past 8192 is refused naming
    [large-nperseg]."""
    ranks = collections.Counter()
    for k in range(8193, 32769):
        cfg = SpecConfig(nperseg=k, hop=k // 2)
        got = stft_cuda.route(cfg)
        if k & (k - 1) == 0:
            assert got == "fft", k
            assert stft_cuda.partial_tiles(cfg, got) == (
                2 if k >= stft_cuda.R2_SPLIT_NFFT else 1)
            continue
        assert got == "bluestein", k
        n = tstft.transform_length(k)
        m = tstft.bluestein_length(n)
        r = tstft.bluestein_ranks(m)
        radices = tstft.fft_radices(m)
        cross = r.bit_length() - 1
        assert m >= 2 * n - 1 and set(radices) <= {2, 3, 5, 7}, k
        assert m % r == 0 and m // r <= tstft.BLUESTEIN_BLOCK_POINTS, k
        assert r == 1 or m > (r // 2) * tstft.BLUESTEIN_BLOCK_POINTS, k
        assert radices[len(radices) - cross:] == (2,) * cross, k
        ranks[r] += 1
    assert ranks == {1: 3107, 2: 10309, 4: 9180, 8: 1978}
    # the plans themselves: the crossing stages at spans H, 2H, ..., M/2
    for k in (8194, 9000, 14409, 20000, 28813, 28814, 30002, 32767):
        plan = tstft.bluestein_plan(k)
        H = plan.m // plan.ranks
        cross = plan.ranks.bit_length() - 1
        for t, st in enumerate(plan.stages[len(plan.stages) - cross:]):
            assert tuple(st[:2]) == (2, H << t), k
    assert [tstft.bluestein_plan(k).ranks for k in (8194, 20000, 14409,
                                                    28814, 28813, 32767)] \
        == [1, 2, 4, 4, 8, 8]
    assert tstft.bluestein_plan(32767).m == 65536
    # 20000 and 30000 run as two half transforms (a tile each), 28814 and
    # 32767 on their clusters of four and eight
    for k, tiles in ((16384, 1), (32768, 2), (20000, 2), (30000, 2),
                     (28814, 4), (32767, 8)):
        cfg = SpecConfig(nperseg=k)
        assert stft_cuda.partial_tiles(cfg, stft_cuda.route(cfg)) == tiles
    # past 32,768
    for cfg, want in ((SpecConfig(nperseg=1024, nfft=40000), "gemm"),
                      (SpecConfig(nperseg=8192, nfft=65536), "gemm"),
                      (SpecConfig(nperseg=9000, nfft=32768), "fft"),
                      (SpecConfig(nperseg=9000, nfft=32767), "bluestein"),
                      (SpecConfig(nperseg=24, nfft=8200), "bluestein")):
        assert stft_cuda.route(cfg) == want
    for cfg, text in ((SpecConfig(nperseg=32769), "> 32768"),
                      (SpecConfig.scipy_default(65536), "> 32768"),
                      (SpecConfig(nperseg=9000, nfft=32769), "nfft 32769")):
        reason = stft_cuda.unsupported_reason(cfg)
        assert "[large-nperseg]" in reason and text in reason, reason
        assert not stft_cuda.kernel_supported(cfg)
        with pytest.raises(NotImplementedError, match=r"\[large-nperseg\]"):
            stft_cuda.route(cfg)
    with pytest.raises(ValueError, match="cluster of 8"):
        tstft.bluestein_length(60000)


def test_forced_routes_and_backward_routes_past_8192():
    """The GEMM route may be forced only up to nperseg 8192 (its dense
    matrices), the Bluestein route on any nfft from 32 to 32,768; the
    backward of nfft past 8192 at nperseg up to 8192 stays "dense" (B1
    after the route's complex epilogue), and past nperseg 8192 the
    backward raises naming [large-nperseg]."""
    x = torch.zeros(1, 40000)
    big = SpecConfig.scipy_default(16384)
    with pytest.raises(ValueError, match="no 'gemm' route"):
        stft_cuda.stft_psd(x, FS, big, _route="gemm")
    assert torch.equal(stft_cuda.stft_psd(x, FS, big, _route="bluestein"),
                       stft_cuda.stft_psd(x, FS, big))
    padded = SpecConfig(nperseg=1024, nfft=16384)
    assert stft_cuda.backward_route(padded) == "dense"
    assert stft_cuda.backward_route(SpecConfig(nperseg=24, nfft=8200)) == \
        "dense"
    for k in (8193, 16384, 20000, 32767):
        with pytest.raises(NotImplementedError, match="large-nperseg"):
            stft_cuda.backward_route(SpecConfig.scipy_default(k))


def _constant(src, name):
    found = re.search(rf"^constexpr int {name} = (\d+);", src, re.M)
    assert found, name
    return int(found.group(1))


def test_ceilings_and_ranks_rule_are_the_sources():
    """The radix-2 and Bluestein routes' ceiling, the nfft from which the
    radix-2 kernel splits a frame, the ranks' limit and the ranks rule
    (``blue_ranks``) are the CUDA source's, and the launcher dispatches
    the split from R2_SPLIT_K and nfft 16384 to one block of 8192
    points."""
    with open(SOURCE) as fh:
        src = fh.read()
    assert _constant(src, "R2_MAX_K") == stft_cuda.MAX_FFT_NFFT == 32768
    assert _constant(src, "BLUE_MAX_K") == stft_cuda.MAX_FFT_NFFT
    assert _constant(src, "R2_SPLIT_K") == stft_cuda.R2_SPLIT_NFFT
    assert _constant(src, "BLUE_MAX_RANKS") == tstft.BLUESTEIN_MAX_RANKS
    assert _constant(src, "BLUE_MAX_BLOCK_POINTS") == \
        tstft.BLUESTEIN_BLOCK_POINTS
    body = re.search(r"^int blue_ranks\(int M\) \{\n(.*?)^\}", src,
                     re.M | re.S).group(1)
    assert ("while (ranks < BLUE_MAX_RANKS && M > ranks * "
            "BLUE_MAX_BLOCK_POINTS)") in body and "ranks *= 2;" in body

    def blue_ranks(m):                  # the source's loop, transcribed
        ranks = 1
        while ranks < 8 and m > ranks * tstft.BLUESTEIN_BLOCK_POINTS:
            ranks *= 2
        return ranks

    for m in range(1, 8 * tstft.BLUESTEIN_BLOCK_POINTS + 1, 7):
        assert blue_ranks(m) == tstft.bluestein_ranks(m), m
    assert "if (K >= R2_SPLIT_K)\n    return r2_large_launch<13, true>" \
        in src
    assert "if (K == 16384)\n    return r2_large_launch<13, false>" in src


def test_split_rule_and_halves_ranks_are_the_sources():
    """[large-bluestein]: the nfft the Bluestein kernel splits by bin
    parity (BLUE_SPLIT_K, ``blue_split``: from 14,408, where the whole
    transform's convolution passes one block, and divisible by 4),
    the launcher's refusal of halves on four or eight ranks, and its grid
    of two units a frame are the CUDA source's; on the route, every nfft
    from 14,408 to 32,768 divisible by 4 (4,589 lengths, each one whose
    whole transform takes a cluster) takes two halves of N = K/4 points
    whose convolution runs on one block (M' up to 14,406: 3,601 lengths)
    or a cluster of two (988, from 28,816), never four or eight, a
    partials tile a half; below 14,408 the whole transform keeps one
    block; K = 2 mod 4 and odd K keep the whole transform
    and its ranks."""
    with open(SOURCE) as fh:
        src = fh.read()
    assert _constant(src, "BLUE_SPLIT_K") == tstft.BLUESTEIN_SPLIT_NFFT
    assert ("bool blue_split(int K) { return K >= BLUE_SPLIT_K && K % 4 == "
            "0; }") in src
    launch = re.search(r"^int stft_bluestein_psd_launch\(.*?^\}", src,
                       re.M | re.S).group(0)
    for text in ("const bool halves = blue_split(K);",
                 "const int N = odd ? K : (halves ? K / 4 : K / 2);",
                 "(halves && ranks > 2))",
                 "static_cast<unsigned long long>(units) * (halves ? 2 : 1)"
                 " * ranks;",
                 "by_variant[halves][ext][variant]"):
        assert text in launch, text

    def blue_split(k):                  # the source's rule, transcribed
        return k >= 14408 and k % 4 == 0

    ranks = collections.Counter()
    for k in range(8193, 32769):
        cfg = SpecConfig(nperseg=k, hop=k // 2)
        if stft_cuda.route(cfg) != "bluestein":
            continue
        halves = tstft.bluestein_halves(k)
        assert halves == (2 if blue_split(k) else 1), k
        if halves == 1:
            continue
        m = tstft.bluestein_length(k // 4)
        assert m >= k // 2 - 1, k
        ranks[tstft.bluestein_ranks(m)] += 1
        # the whole transform would take a cluster; the halves never fit
        # two blocks an SM (the launcher's TWO)
        assert tstft.bluestein_ranks(tstft.bluestein_length(k // 2)) >= 2
        assert m > 7000, k
    assert ranks == {1: 3601, 2: 988}
    assert all(tstft.bluestein_ranks(tstft.bluestein_length(k // 2)) == 1
               for k in range(8196, 14408, 4))
    # the plans and partials of a sample (each plan takes numpy's FFT of
    # M' points to build)
    for k in (8196, 8198, 14404, 14408, 20000, 28812, 28816, 30000, 30002,
              32764, 32767):
        cfg = SpecConfig(nperseg=k, hop=k // 2)
        plan = tstft.bluestein_route_plan(k)
        tiles = stft_cuda.partial_tiles(cfg, "bluestein")
        if tstft.bluestein_halves(k) == 1:
            assert plan == tstft.bluestein_plan(k)
            assert tiles == (plan.ranks if plan.ranks > 2 else 1), k
            continue
        assert plan.halves == 2 and plan.n == k // 4, k
        assert plan.m == tstft.bluestein_length(k // 4), k
        assert plan.ranks == tstft.bluestein_ranks(plan.m) <= 2, k
        assert tiles == 2, k
    assert tstft.bluestein_route_plan(20000).m == 10000
    assert (tstft.bluestein_route_plan(30000).m,
            tstft.bluestein_route_plan(30000).ranks) == (15000, 2)
    assert tstft.bluestein_route_plan(30002).ranks == 4
    with pytest.raises(ValueError, match="does not split"):
        tstft.bluestein_split_plan(30002)


def test_split_plan_rows_are_the_whole_plans():
    """The split plan's rows: its chirp, b̂ and stages those of the whole
    transform's plan at half the length (an N-point transform), and its
    K/2 split rows the whole plan's at K, bitwise; the whole plans at
    K = 2 mod 4 and odd K as before (the split changes no other plan)."""
    for k in (14408, 20000, 30000):
        half = tstft.bluestein_split_plan(k)
        whole = tstft.bluestein_plan(k)
        n = k // 4
        assert np.array_equal(half.twiddles[half.split:half.split + k // 2],
                              whole.twiddles[whole.split:whole.split
                                             + k // 2])
        ref = tstft.bluestein_plan(2 * n) if n % 2 == 0 else None
        if ref is not None and ref.n == n:
            assert ref.m == half.m and np.array_equal(ref.stages,
                                                      half.stages)
            assert np.array_equal(
                ref.twiddles[:ref.chirp + n], half.twiddles[:half.chirp + n])
    for k in (28814, 30002, 32767, 20001):
        assert tstft.bluestein_route_plan(k).halves == 1


# ---------------------------------------------------------------------------
# the numpy models of the kernels' arithmetic
# ---------------------------------------------------------------------------

def _frames(k, seed, frames=3):
    cfg = SpecConfig(nperseg=k, hop=k // 2)
    x = _signal(seed, k, frames, clips=1)[0]
    return cfg, tp.frames_of(x, cfg)


@pytest.mark.parametrize("detrend", DETRENDS)
@pytest.mark.parametrize("k", [16384, 32768])
def test_split_model_against_numpy_fft(k, detrend):
    """The radix-2 kernel's parity split (each half transform's bins of
    its parity, the first stage in frequency fused into the load) against
    numpy's rFFT of the same detrended, windowed frames: the PSD and the
    complex STFT within 1e-12 of the frame's largest bin."""
    cfg, fr = _frames(k, 10 + k % 7, frames=3)
    window, tw, wts = tp.fft_operands(cfg)
    X = np.fft.rfft(tp.detrended(fr.astype(np.float64), detrend) * window)
    got = tp.psd_fft_split(fr, window, tw, wts, detrend, round_f32=False)
    want = (X.real ** 2 + X.imag ** 2) * wts
    assert np.all(np.abs(got - want).max(axis=-1)
                  <= MODEL_TOL * want.max(axis=-1))
    _, _, cw = tp.fft_operands(cfg, out="complex")
    z = tp.psd_fft_split(fr, window, tw, cw, detrend, round_f32=False,
                         mode="complex")
    assert np.all(np.abs(z - X * cw).max(axis=-1)
                  <= MODEL_TOL * np.abs(X * cw).max(axis=-1))


SPLIT_CASES = (14408, 20000, 28816, 30000, 32764)


@pytest.mark.parametrize("detrend", DETRENDS)
@pytest.mark.parametrize("k", SPLIT_CASES)
def test_bluestein_split_model_against_numpy_fft(k, detrend):
    """[large-bluestein]: the Bluestein kernel's split by bin parity
    (``psd_bluestein_split``: the first stage in frequency in the load,
    two N = K/4-point Bluestein transforms on one block at 14408 and
    20000 and on clusters of two at 28816, 30000 and 32764, the split step
    on
    each half's bins) against numpy's float64 rFFT of the same detrended,
    windowed frames, on ramp clips with an offset: the PSD within 1e-12 of
    the frame's largest bin; the complex STFT too at the first detrend."""
    cfg, fr = _frames(k, 30 + k % 13, frames=3)
    fr = fr + 3.0
    window, plan, wts = tp.bluestein_route_operands(cfg)
    assert plan.halves == 2 and plan.ranks == (1 if k <= 20000 else 2)
    X = np.fft.rfft(tp.detrended(fr.astype(np.float64), detrend) * window)
    got = tp.psd_bluestein(fr, window, plan, wts, detrend, round_f32=False)
    want = (X.real ** 2 + X.imag ** 2) * wts
    assert np.all(np.abs(got - want).max(axis=-1)
                  <= MODEL_TOL * want.max(axis=-1))
    if detrend == "none":
        _, _, cw = tp.bluestein_route_operands(cfg, out="complex")
        z = tp.psd_bluestein(fr, window, plan, cw, detrend, round_f32=False,
                             mode="complex")
        assert np.all(np.abs(z - X * cw).max(axis=-1)
                      <= MODEL_TOL * np.abs(X * cw).max(axis=-1))


@pytest.mark.parametrize("k", [8194, 20000, 14409, 28814, 28813, 32767])
def test_cluster_model_against_numpy_fft(k):
    """The Bluestein transform on the ranks as the cluster indexes them
    (one block at 8194, two at 20000, four at 14409 and 28814, eight at
    28813 and 32767: the crossing stages on each column, every other
    stage on a rank's slots) against numpy's DFT, and the whole PSD
    (odd k: two frames a transform) against numpy's rFFT, within 1e-12 of
    the frame's largest bin."""
    plan = tstft.bluestein_plan(k)
    rs = np.random.RandomState(k)
    re_, im = rs.randn(2, plan.n), rs.randn(2, plan.n)
    zr, zi = tp._bluestein_transform(re_, im, plan)
    want = np.fft.fft(re_ + 1j * im)
    assert np.abs(zr + 1j * zi - want).max() <= MODEL_TOL * \
        np.abs(want).max()
    cfg, fr = _frames(k, 20 + k % 11, frames=3)
    window, bplan, wts = tp.bluestein_operands(cfg)
    got = tp.psd_bluestein(fr, window, bplan, wts, "constant",
                           round_f32=False)
    X = np.fft.rfft(tp.detrended(fr.astype(np.float64), "constant")
                    * window)
    psd = (X.real ** 2 + X.imag ** 2) * wts
    assert np.all(np.abs(got - psd).max(axis=-1)
                  <= MODEL_TOL * psd.max(axis=-1))


@pytest.mark.parametrize("k", [28813, 32767])
def test_cluster_model_of_eight_is_one_buffer(k):
    """The eight ranks' model against the same plan's stages on one buffer
    of M slots (the crossing stages taken as the whole transform's last
    three): bitwise, as the cluster's columns only move values."""
    plan = tstft.bluestein_plan(k)
    assert plan.ranks == 8
    rs = np.random.RandomState(3)
    re_, im = rs.randn(2, plan.n), rs.randn(2, plan.n)
    ranks = tp._bluestein_transform(re_, im, plan)
    whole = tp._bluestein_transform(re_, im, plan._replace(ranks=1))
    assert all(np.array_equal(a, b) for a, b in zip(ranks, whole))


# ---------------------------------------------------------------------------
# the port's CPU path against the JAX package in float64
# ---------------------------------------------------------------------------

def _jax_psd(x, cfg, band=None):
    with jax.enable_x64(True):
        p = np.asarray(jstft.power_spectrogram(jnp.asarray(x), FS, _j(cfg),
                                               use_matmul=False))
    return p if band is None else p[..., band[0]:band[1]]


@pytest.mark.parametrize("detrend", DETRENDS)
@pytest.mark.parametrize("k", LARGE)
def test_psd_matches_jax_x64(k, detrend):
    """power_spectrogram and stft_psd on float64 input against the JAX
    package's (its rFFT route) under x64, within 1e-10 of the clip's
    largest value, and stft_psd's extrema the PSD's."""
    cfg = SpecConfig(nperseg=k, hop=k // 2, detrend=detrend)
    x = _signal(k % 97, k, offset=3.0)
    got = tstft.power_spectrogram(torch.from_numpy(x), FS, cfg)
    assert got.dtype == torch.float64 and tuple(got.shape) == (
        2, 3, cfg.n_freqs)
    want = _jax_psd(x, cfg)
    for b in range(2):
        assert _rel(got[b].numpy(), want[b]) <= X64_TOL
    p, lo, hi = stft_cuda.stft_psd(torch.from_numpy(x), FS, cfg,
                                   with_stats=True)
    assert torch.equal(p, got)
    assert torch.equal(lo, p.amin(dim=(1, 2)))
    assert torch.equal(hi, p.amax(dim=(1, 2)))


@pytest.mark.parametrize("k", [16384, 32767])
def test_magnitude_complex_and_spectrogram_match_jax_x64(k):
    """spectrogram in magnitude and complex mode and stft (the unscaled
    complex STFT) against the JAX package's under x64."""
    x = _signal(5, k, offset=1.0)
    with jax.enable_x64(True):
        for mode in ("magnitude", "complex", "psd"):
            cfg = SpecConfig(nperseg=k, hop=k // 2, mode=mode)
            f, t, sxx = tstft.spectrogram(torch.from_numpy(x), FS, cfg)
            jf, jt, jsxx = jstft.spectrogram(jnp.asarray(x), FS, _j(cfg),
                                             use_matmul=False)
            assert np.array_equal(f, np.asarray(jf))
            assert np.allclose(t, np.asarray(jt), rtol=0, atol=1e-12)
            for b in range(2):
                assert _rel(sxx[b].numpy(), np.asarray(jsxx)[b]) <= X64_TOL
        cfg = SpecConfig(nperseg=k, hop=k // 2, detrend="linear")
        z = tstft.stft(torch.from_numpy(x), cfg)
        jz = np.asarray(jstft.stft(jnp.asarray(x), _j(cfg),
                                   use_matmul=False))
    assert z.dtype == torch.complex128
    for b in range(2):
        assert _rel(z[b].numpy(), jz[b]) <= X64_TOL


@pytest.mark.parametrize("case", ["two-sided", "centered", "banded",
                                  "padded"])
def test_two_sided_centered_banded_and_padded_match_jax_x64(case):
    """A two-sided spectrum at 20000 (its bins past nfft/2 the
    conjugates of their mirrors bitwise), centered framing at 16384, the
    band 100-300 Hz through spectrogram's fmin/fmax and
    power_spectrogram_fm's band at 30002, and nperseg 9000 zero-padded to
    nfft 16384, each against the JAX package under x64."""
    if case == "two-sided":
        cfg = SpecConfig(nperseg=20000, hop=10000, onesided=False)
        x = _signal(7, 20000)
        z = stft_cuda.stft_complex(torch.from_numpy(x), FS, cfg)
        f = torch.arange(1, 10000)
        assert torch.equal(z[..., 20000 - f], z[..., f].conj())
    elif case == "centered":
        cfg = SpecConfig(nperseg=16384, hop=8192, center=True,
                         pad_mode="reflect")
        x = _signal(8, 16384)
    elif case == "banded":
        cfg = SpecConfig(nperseg=30002, hop=15001, fmin=100.0, fmax=300.0)
        x = _signal(9, 30002)
        with jax.enable_x64(True):
            f, _, sxx = tstft.spectrogram(torch.from_numpy(x), FS, cfg)
            jf, _, jsxx = jstft.spectrogram(jnp.asarray(x), FS, _j(cfg),
                                            use_matmul=False)
        assert np.array_equal(f, np.asarray(jf)) and len(f) == 375
        for b in range(2):
            assert _rel(sxx[b].numpy(), np.asarray(jsxx)[b]) <= X64_TOL
        band = tstft.band_row_slice(tstft.freq_axis(cfg, FS), cfg.fmin,
                                    cfg.fmax)
        fm = tstft.power_spectrogram_fm(torch.from_numpy(x), FS, cfg,
                                        band=band)
        assert torch.equal(fm, sxx)
        return
    else:
        cfg = SpecConfig(nperseg=9000, nfft=16384, hop=4500,
                         detrend="linear")
        x = _signal(10, 9000)
        assert stft_cuda.route(cfg) == "fft"
    got = tstft.power_spectrogram(torch.from_numpy(x), FS, cfg).numpy()
    want = _jax_psd(x, cfg)
    assert got.shape == want.shape
    for b in range(2):
        assert _rel(got[b], want[b]) <= X64_TOL


@pytest.mark.parametrize("k", [16384, 32768])
def test_64_mels_match_jax_x64(k):
    """The pipeline's 64 mel rows on float64 input against the JAX
    package's pipeline under x64 (both float64 through the mel
    projection), within 1e-10 of the clip's largest value."""
    cfg = SpecConfig.scipy_default(k, n_mels=64)
    x = _signal(k % 31, k)
    out = sharding.batched_spectrogram_fn(FS, cfg, colormap=None,
                                          device="cpu")(x)
    with jax.enable_x64(True):
        jout = jsharding.batched_spectrogram_fn(FS, _j(cfg),
                                                colormap=None)(
            jnp.asarray(x))
        want = np.asarray(jout["mel"])
    got = out["mel"].numpy()
    assert got.dtype == want.dtype == np.float64
    assert got.shape == want.shape and got.shape[-1] == 64
    for b in range(2):
        assert _rel(got[b], want[b]) <= X64_TOL


def test_mels_and_band_through_the_pipeline_match_jax():
    """The pipeline (batched_spectrogram_fn) at nperseg 16384 with 64 mels
    and with the band 0-30 Hz, and at 32768 on the full band (F = 16,385
    through the display tail), against the JAX package's pipeline on
    float32 clips: the PSD or mel rows within 2e-5 of the clip's largest
    value, the images within 2e-5 (the JAX package's float32 rFFT lands
    1.0e-3 dB from scipy float64 on the log image at 32768), and the log
    image within 1e-3 dB of scipy float64."""
    x = _signal(11, 32768, frames=3).astype(np.float32)
    for cfg, key in ((SpecConfig.scipy_default(16384, n_mels=64), "mel"),
                     (SpecConfig.scipy_default(16384, fmin=0.0, fmax=30.0),
                      "psd"),
                     (SpecConfig.scipy_default(32768, log_scale=True),
                      "psd")):
        out = sharding.batched_spectrogram_fn(FS, cfg, device="cpu")(x)
        jout = jsharding.batched_spectrogram_fn(FS, _j(cfg))(jnp.asarray(x))
        got, want = out[key].numpy(), np.asarray(jout[key])
        assert got.shape == want.shape, key
        for b in range(2):
            assert _rel(got[b], want[b]) <= F32_TOL, (cfg, key)
        assert np.abs(out["image"].numpy()
                      - np.asarray(jout["image"])).max() <= F32_TOL
    assert tuple(out["psd"].shape) == (2, 2, 16385)
    for b in range(2):
        oracle, db_range = tp.scipy_display(x[b].astype(np.float64), cfg, FS)
        assert np.abs(out["image"][b].numpy() - oracle).max() * db_range \
            <= 1e-3


def test_export_session_grid_and_render_match_jax(tmp_path):
    """export_spectrograms' PNGs at 16384 (indices within one of the JAX
    export's, 99.9% equal), the session's plot at 16384 on a 60 s sweep
    (sxx within 5e-6, the image within 1e-5), the sweep grid at 16384 and
    20000, and the CLI's render --nperseg 16384 exit 0 with a PNG the
    session's."""
    from PIL import Image
    cfg = SpecConfig.scipy_default(16384, log_scale=True)
    rs = np.random.RandomState(12)
    clips = [(f"c{i}", rs.randn(40000).astype(np.float32)) for i in range(2)]
    for name, fn, c, extra in (("port", tpipe.export_spectrograms, cfg,
                                {"device": "cpu"}),
                               ("jax", jpipe.export_spectrograms, _j(cfg),
                                {})):
        fn(list(clips), FS, c, str(tmp_path / name), clip_samples=40000,
           batch=2, **extra)
    for name in ("c0.png", "c1.png"):
        a = np.asarray(Image.open(tmp_path / "port" / name)).astype(int)
        b = np.asarray(Image.open(tmp_path / "jax" / name)).astype(int)
        assert a.shape == b.shape and a.shape[0] == 8193
        assert (a == b).mean() >= 0.999 and np.abs(a - b).max() <= 1
    # the session's plot
    fs = 1000.0
    x = (0.02 * np.random.RandomState(13).randn(60000)).astype(np.float32)
    t = tsession.AnalysisSession(device="cpu", warm_detection=False)
    j = jsession.AnalysisSession(warm_detection=False)
    for s, entry in ((t, treg.SweepEntry), (j, jreg.SweepEntry)):
        s.registry.register("rec_sweep0", entry(
            filepath="rec.h5", sweep_idx=0, fs=fs, fs_raw=fs, raw=x,
            processed=None))
    pcfg = SpecConfig.scipy_default(16384)
    rt = t.plot_sweeps(["rec_sweep0"], pcfg, ViewSettings())
    rj = j.plot_sweeps(["rec_sweep0"], _j(pcfg),
                       jconfig.ViewSettings(**dataclasses.asdict(
                           ViewSettings())))
    assert np.array_equal(rt.f, rj.f) and rt.sxx.shape == rj.sxx.shape
    assert rt.sxx.shape[0] == 8193
    assert _rel(rt.sxx, rj.sxx) <= 5e-6
    assert np.nanmax(np.abs(rt.image - rj.image)) <= 1e-5
    # the sweep grid
    grid = [SpecConfig(nperseg=16384, hop=8192, detrend="none"),
            SpecConfig(nperseg=20000, hop=10000, detrend="none")]
    y = rs.randn(40000).astype(np.float32)
    got = tsg.sweep_grid(y, FS, grid, device="cpu")
    want = jsg.sweep_grid(jnp.asarray(y), FS, [_j(c) for c in grid])
    for g, w in zip(got, want):
        assert _rel(g.numpy(), np.asarray(w)) <= F32_TOL
    # the command line's render
    from spectral_tpu_torch import cli as tcli
    from spectral_tpu_torch.io.wav import write_wav
    wav = str(tmp_path / "sig.wav")
    write_wav(wav, x, fs)
    png = str(tmp_path / "render.png")
    assert tcli.main(["--cpu", "render", wav, "-o", png, "--nperseg",
                      "16384"]) == 0
    assert Image.open(png).size[1] == 8193


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [16384, 20001])
def test_cpu_gradient_matches_jax_grad(k):
    """The gradient of sum(PSD g) through the plain version's torch.fft by
    autograd, on power_spectrogram and on stft_psd, against jax.grad of
    the JAX package's power_spectrogram (its rFFT route) in float64,
    within 1e-9 of its largest entry."""
    cfg = SpecConfig(nperseg=k, hop=k // 2, detrend="linear")
    x = _signal(k % 89, k, offset=2.0)
    T = tstft.num_frames(x.shape[-1], k, cfg.hop_)
    g = np.random.RandomState(1).rand(2, T, cfg.n_freqs)
    with jax.enable_x64(True):
        def loss(v):
            return jnp.sum(jstft.power_spectrogram(v, FS, _j(cfg),
                                                   use_matmul=False) * g)
        want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    for entry in (tstft.power_spectrogram, stft_cuda.stft_psd):
        xt = torch.from_numpy(x).requires_grad_()
        (entry(xt, FS, cfg) * torch.from_numpy(g)).sum().backward()
        assert _rel(xt.grad.numpy(), want) <= GRAD_TOL


def test_cuda_gradient_refused_before_any_launch(monkeypatch):
    """A CUDA tensor that requires grad at nperseg past 8192 raises naming
    [large-nperseg] before any launch (the library is never asked for);
    without grad the same call reaches the launch."""
    def no_library():
        raise AssertionError("the STFT library was asked for")

    monkeypatch.setattr(stft_cuda, "_library", no_library)
    x = torch.empty((1, 40000), device="meta", requires_grad=True)
    for cfg in (SpecConfig.scipy_default(16384),
                SpecConfig.scipy_default(20001)):
        for call in (lambda: stft_cuda.stft_psd(x, FS, cfg),
                     lambda: stft_cuda.stft_complex(x, FS, cfg),
                     lambda: stft_cuda.stft_psd_partials(x, FS, cfg)):
            with pytest.raises(NotImplementedError, match="large-nperseg"):
                call()
    with pytest.raises(AssertionError, match="library was asked"):
        stft_cuda.stft_psd(x.detach(), FS, SpecConfig.scipy_default(16384))


# ---------------------------------------------------------------------------
# no dense matrix past 8192
# ---------------------------------------------------------------------------

def test_no_dense_matrix_past_8192(monkeypatch):
    """Past nperseg 8192 no entry point builds the dense (nperseg, F)
    matrices (dft_matrices) or their device operands (dft_constants):
    both monkeypatched to raise, the PSD, the complex STFT, the
    spectrogram with a band, the partials, the pipeline and the gradient
    still compute."""
    def refuse(*a, **k):
        raise AssertionError("a dense DFT matrix was built past 8192")

    for mod, name in ((tstft, "dft_matrices"), (stft_cuda, "dft_matrices"),
                      (stft_cuda, "dft_constants"),
                      (stft_cuda, "mirrored_dft_matrices")):
        monkeypatch.setattr(mod, name, refuse)
    for k in (16384, 20000, 32767):
        cfg = SpecConfig.scipy_default(k)
        x = torch.from_numpy(_signal(k % 13, k).astype(np.float32))
        stft_cuda.stft_psd(x, FS, cfg, with_stats=True)
        stft_cuda.stft_complex(x, FS, dataclasses.replace(cfg,
                                                          onesided=False))
        stft_cuda.stft_psd_partials(x, FS, cfg, band=(3, 50))
        tstft.stft(x, cfg)
        tstft.spectrogram(x, FS, dataclasses.replace(cfg, fmin=10.0,
                                                     fmax=900.0))
        sharding.batched_spectrogram_fn(FS, cfg, device="cpu")(x)
        xg = x.double().requires_grad_()
        tstft.power_spectrogram(xg, FS, cfg).sum().backward()
        assert xg.grad is not None
