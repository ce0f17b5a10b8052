"""The Bluestein route of the port's STFT/PSD kernel (spectral_tpu_torch.
ops.stft_cuda.route, bluestein_constants; core.stft.bluestein_plan;
csrc/stft_psd.cu::stft_bluestein_psd_kernel), held on the CPU through a
numpy model of the kernel's exact algorithm
(``tools/torch_precision.py::psd_bluestein``: the chirp load, M's stages in
frequency, the conjugated product with b̂, the stages in time, the chirp
readout; on a cluster of two blocks the two half-buffers as the kernel
indexes them; the even kernels' split step, or the odd kernels' pairing).

The route takes every nperseg from 32 to 8192 whose transform length has
a prime past 255 that the mixed plan cannot take (2,389 values, none on
the GUI's grid); this file walks all of them against the CUDA source's
constants. Tolerances, each with its reason:

- against a long-double DFT of the same detrended, windowed frames: 1e-12
  of each clip's largest bin (the model sits within about 1e-15 of
  numpy's float64 FFT: Bluestein's two M-point transforms round as a
  mixed-radix transform of M points does).
- against the kernels' plain version (``stft_psd_reference``, a float64
  dense DFT): 1e-12 of each clip's largest bin, the radix-2 and mixed
  models' tolerance; above nperseg 4096 against a float64 dense DFT built
  512 rows at a time instead of the plain version's 537 MB matrices.
- against the JAX package's matmul route, which sums in float32 (the
  Pallas kernel refuses these configs: gcd(nperseg, hop) < 8): 2e-5 of
  each clip's max, the JAX package's own tolerance against scipy.
- against scipy in float64: 1e-6 dB of display error, three orders inside
  the 1e-3 dB contract.
- a frame the pairing's guard keeps apart: 1e-12 of that frame's own
  largest bin, and an all-zero frame's bins exactly 0.
"""

import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import jax.numpy as jnp  # noqa: E402

from spectral_tpu import config as jconfig  # noqa: E402
from spectral_tpu.core import stft as jstft  # noqa: E402
from spectral_tpu_torch import SpecConfig  # noqa: E402
from spectral_tpu_torch.core import stft as tstft  # noqa: E402
from spectral_tpu_torch.ops import stft_cuda  # noqa: E402
import torch_precision  # noqa: E402

FS = 16000.0
JAX_TOL = 2e-5          # against the JAX package's float32 route
F64_TOL = 1e-12         # against a float64 or long-double DFT
CSRC = os.path.join(os.path.dirname(stft_cuda.__file__), "csrc",
                    "stft_psd.cu")
DETRENDS = ("none", "constant", "linear")
# even (1126 = 2 · 563, 8182 = 2 · 4091), odd on one block (563, 2049 = 3 ·
# 683) and on a cluster of two (8185, 8189)
CASES = [563, 1126, 2049, 8182, 8185, 8189]


def _cuda_int(name):
    with open(CSRC) as fh:
        m = re.search(rf"constexpr int {name} = (\d+);", fh.read())
    return int(m.group(1))


def _route_before(k):
    """:func:`stft_cuda.route` before the Bluestein route, for nperseg k."""
    if not 32 <= k <= 8192:
        return "gemm"
    if k & (k - 1) == 0:
        return "fft"
    if max(tstft.plan_radices(k)) > 255:
        return "gemm"
    return "odd" if k % 2 else "mixed"


def _smooth(m):
    for p in (2, 3, 5, 7):
        while m % p == 0:
            m //= p
    return m == 1


def _next_smooth(m, step=1):
    while not _smooth(m):
        m += step
    return m


def _config(nperseg, detrend, hop=None):
    """hop nperseg/4 unless given: a Hann window for detrend none (the
    north_star family), scipy's Tukey 0.25 for constant and linear."""
    hop = hop or nperseg // 4
    if detrend == "none":
        return SpecConfig.north_star(nperseg, hop)
    return SpecConfig(nperseg=nperseg, hop=hop, detrend=detrend)


def _clips(seed, cfg, n_clips=2, offset=3.0, trend=0.5, frames=9):
    """``frames`` frames of white noise plus offset a clip; under linear
    detrend, noise plus ``trend`` times ``torch_precision.trend`` (half
    the ramp by default, for the plain version's rounding, as in
    ``tests/test_torch_odd_fft.py``)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(n_clips, cfg.nperseg + (frames - 1) * cfg.hop_)
    if cfg.detrend == "linear":
        return (x + trend * torch_precision.trend(x.shape[-1])).astype(
            np.float32)
    return (x + offset).astype(np.float32)


def _model(x, cfg, round_f32=False, pack=True):
    """The Bluestein kernel's PSD of each clip in x, (B, T, F), from the
    operands the wrapper hands the kernel."""
    bc = stft_cuda.bluestein_constants(cfg, FS, "cpu")
    plan = tstft.bluestein_plan(cfg.nperseg)
    return np.stack([torch_precision.psd_bluestein(
        torch_precision.frames_of(clip, cfg), bc.window.numpy(), plan,
        bc.wts.numpy(), detrend=cfg.detrend, round_f32=round_f32, pack=pack)
        for clip in x])


def _dense(x, cfg, dtype=np.float64):
    """The PSD by a dense DFT of the detrended, windowed frames in
    ``dtype``: the (K, F) matrix gathered 512 rows at a time from a table
    of cos and sin of -2π j / K, j < K, in ``dtype``, its index i·f
    reduced exactly mod K."""
    K, F = cfg.nperseg, cfg.n_freqs
    window = stft_cuda.bluestein_constants(cfg, FS, "cpu").window.numpy()
    wts = tstft.onesided_weights(cfg, FS)
    f = np.arange(F)
    ang = -2 * np.arccos(dtype(-1)) * np.arange(K).astype(dtype) / K
    cos, sin = np.cos(ang), np.sin(ang)
    v = np.stack([torch_precision.detrended(
        torch_precision.frames_of(clip, cfg).astype(np.float64),
        cfg.detrend) * window for clip in x]).astype(dtype)
    re = np.zeros(v.shape[:2] + (F,), dtype)
    im = np.zeros_like(re)
    for i0 in range(0, K, 512):
        i = np.arange(i0, min(K, i0 + 512))
        j = (i[:, None] * f[None]) % K
        re += v[..., i] @ cos[j]
        im += v[..., i] @ sin[j]
    return (re * re + im * im).astype(np.float64) * wts


def _plain(x, cfg):
    return stft_cuda.stft_psd_reference(
        torch.from_numpy(x).double(), stft_cuda.dft_constants(cfg, FS, "cpu"),
        cfg).numpy()


def _assert_close(got, want, tol):
    scale = want.max(axis=(-2, -1))
    err = np.abs(got - want).max(axis=(-2, -1))
    assert np.all(err <= tol * scale), err / scale


# ---------------------------------------------------------------------------
# the route and the plan against the kernel's constants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("detrend", DETRENDS)
def test_route_takes_exactly_the_former_gemm_values(detrend):
    """Every nperseg from 2 to 8192: the values that took the FFT, mixed
    or odd kernel still do; every value the GEMM kernel took from 32 up
    (2,389) takes the Bluestein kernel; 2-31 stay on the GEMM kernel."""
    counts = {}
    for k in range(2, 8193):
        got = stft_cuda.route(SpecConfig(nperseg=k, hop=max(1, k // 4),
                                         detrend=detrend))
        before = _route_before(k)
        want = "bluestein" if before == "gemm" and k >= 32 else before
        assert got == want, (k, got, before)
        counts[got] = counts.get(got, 0) + 1
    assert counts == {"gemm": 30, "fft": 9, "mixed": 3065, "odd": 2698,
                      "bluestein": 2389}


def test_every_bluestein_plan_fits_the_kernel():
    """Every nperseg the route gives the Bluestein kernel against the CUDA
    source's constants: M >= 2N - 1 with radices 2, 3, 5 and 7 only, at
    most MIX_MAX_STAGES stages in the plan's order; one block holds M up to
    BLUE_MAX_BLOCK_POINTS beside the kernel's static arrays within the
    card's BLOCK_SMEM, and no larger 2, 3, 5, 7-smooth number fits, so a
    cluster runs exactly where no block holds the smallest such M: odd
    nperseg with an even M whose last stage is radix 2 at span M/2, every
    input and output in rank 0's half."""
    max_stages = _cuda_int("MIX_MAX_STAGES")
    max_radix = _cuda_int("BLUE_MAX_RADIX")
    block_points = _cuda_int("BLUE_MAX_BLOCK_POINTS")
    block_smem = _cuda_int("BLOCK_SMEM")
    warps = _cuda_int("FFT_MAX_THREADS") // 32
    small_roots = _cuda_int("SMALL_ROOTS")      # radix 3, 5 and 7's roots
    with open(CSRC) as fh:
        assert re.search(
            r"BLUE_STATIC_SMEM =\s+SMALL_ROOTS \* 16 \+ 3 \* "
            r"FFT_MAX_WARPS \* 16 \+ 4 \* FFT_MAX_WARPS \* 4;", fh.read())
    static = small_roots * 16 + 3 * warps * 16 + 4 * warps * 4
    assert max_radix == max(tstft.BLUESTEIN_RADICES)
    assert block_points == tstft.BLUESTEIN_BLOCK_POINTS
    assert block_points * 16 + static <= block_smem
    assert _next_smooth(block_points + 1) * 16 + static > block_smem
    ranks = {1: 0, 2: 0}
    for k in range(32, 8193):
        if stft_cuda.route(SpecConfig(nperseg=k, hop=k // 4)) != "bluestein":
            continue
        plan = tstft.bluestein_plan(k)
        n, m = plan.n, plan.m
        assert n == tstft.transform_length(k)
        smallest = _next_smooth(2 * n - 1)
        must_cluster = smallest * 16 + static > block_smem
        assert plan.ranks == (2 if must_cluster else 1), k
        assert m == (_next_smooth(smallest + smallest % 2, 2)
                     if must_cluster else smallest)
        factors = plan.stages[:, 0].tolist()
        assert factors == list(tstft.fft_radices(m))
        assert set(factors) <= set(tstft.BLUESTEIN_RADICES)
        assert len(factors) <= max_stages and int(np.prod(factors)) == m
        assert (m // plan.ranks) * 16 + static <= block_smem
        if plan.ranks == 2:
            assert k % 2 and m % 2 == 0 and n <= m // 2
            assert plan.stages[-1, :2].tolist() == [2, m // 2]
        ranks[plan.ranks] += 1
    assert ranks == {1: 2389 - 235, 2: 235}
    assert (tstft.bluestein_plan(7201).m, tstft.bluestein_plan(7201).ranks,
            tstft.bluestein_plan(7207).m, tstft.bluestein_plan(7207).ranks
            ) == (14406, 1, 14580, 2)


@pytest.mark.parametrize("nperseg", [33, 563, 1126, 2049, 7563, 8185])
def test_bluestein_plan_rows(nperseg):
    """The plan's rows: M's stages as the mixed plan's over M (the same
    generator), the chirp w_i = exp(-iπ i² / N) and the split rows
    bitwise numpy's cos and sin of integer phases reduced exactly, and b̂
    in M's digit-reversed slot order (7563: the smallest M, 15309, is odd
    and past one block, so the cluster takes the next even one, 15360)."""
    plan = tstft.bluestein_plan(nperseg)
    n, m = plan.n, plan.m
    stages, perm, blocks, row = tstft._dit_plan(m, m)
    assert np.array_equal(plan.stages, stages)
    assert np.array_equal(plan.perm, perm) and plan.perm.dtype == np.int32
    assert np.array_equal(plan.twiddles[:row], np.concatenate(blocks))
    assert plan.bhat == row and plan.chirp == row + m
    i = np.arange(n)
    ang = -2.0 * np.pi * ((i * i) % (2 * n)) / (2 * n)
    assert np.array_equal(plan.twiddles[plan.chirp:plan.chirp + n],
                          np.stack([np.cos(ang), np.sin(ang)], axis=1))
    if nperseg % 2:
        assert plan.split == -1 and plan.chirp + n == len(plan.twiddles)
    else:
        ang = -2.0 * np.pi * i / nperseg
        assert np.array_equal(plan.twiddles[plan.split:],
                              np.stack([np.cos(ang), np.sin(ang)], axis=1))
    if nperseg == 7563:
        assert (_next_smooth(2 * n - 1), m, plan.ranks) == (15309, 15360, 2)
    # b̂ at slot perm[j]: the DFT of the M-periodic conj(w), over M
    w = np.exp(-1j * np.pi * ((i * i) % (2 * n)) / n)
    b = np.zeros(m, complex)
    b[:n] = np.conj(w)
    b[m - i[1:]] = np.conj(w[1:])
    rows = plan.twiddles[plan.bhat:plan.bhat + m]
    bhat = (rows[:, 0] + 1j * rows[:, 1])[plan.perm]
    assert np.allclose(bhat, np.fft.fft(b) / m, rtol=0, atol=1e-15)


@pytest.mark.parametrize("nperseg", [33, 563, 1126])
def test_bluestein_kernel_rows_against_a_long_double_dft(nperseg):
    """b̂ against the DFT of b summed in long double (the chirp's phases
    reduced exactly): numpy's float64 FFT within 1e-15 of b̂'s largest
    row."""
    plan = tstft.bluestein_plan(nperseg)
    n, m = plan.n, plan.m
    ld = np.longdouble
    pi = np.arccos(ld(-1))
    e = np.zeros(m, np.int64)             # b_j = exp(iπ e_j / n), 0 if -1
    mask = np.zeros(m, bool)
    i = np.arange(n)
    e[:n], mask[:n] = (i * i) % (2 * n), True
    e[m - i[1:]], mask[m - i[1:]] = ((i * i) % (2 * n))[1:], True
    j = np.arange(m)
    jk = (j[:, None] * j[None]) % m
    ang = (pi * e[:, None].astype(ld) / n
           - 2 * pi * jk.astype(ld) / m) * mask[:, None]
    want_re = (np.cos(ang) * mask[:, None]).sum(axis=0) / m
    want_im = (np.sin(ang) * mask[:, None]).sum(axis=0) / m
    rows = plan.twiddles[plan.bhat:plan.bhat + m]
    bhat = (rows[:, 0] + 1j * rows[:, 1])[plan.perm]
    err = np.abs(bhat - (want_re.astype(np.float64)
                         + 1j * want_im.astype(np.float64)))
    assert err.max() <= 1e-15 * np.abs(bhat).max(), err.max()


def test_bluestein_constants_build_no_dft_matrix(monkeypatch):
    """The Bluestein route's set-up never builds the (K, F) matrices (537
    MB in float64 at 8185)."""
    def refuse(cfg):
        raise AssertionError("the Bluestein route built a DFT matrix")

    monkeypatch.setattr(stft_cuda, "dft_matrices", refuse)
    monkeypatch.setattr(tstft, "dft_matrices", refuse)
    for k in (8185, 8182):
        cfg = SpecConfig.scipy_default(k, log_scale=True)
        bc = stft_cuda.bluestein_constants(cfg, FS, "cpu")
        plan = tstft.bluestein_plan(k)
        assert all(t.dtype == torch.float64
                   for t in (bc.window, bc.twiddles, bc.wts))
        assert bc.window.shape == (k,) and bc.wts.shape == (cfg.n_freqs,)
        assert np.array_equal(bc.twiddles.numpy(), plan.twiddles)
        assert np.array_equal(bc.stages, plan.stages)
        assert bc.stages.dtype == np.int32 and bc.stages.flags.c_contiguous
        assert (bc.m, bc.bhat, bc.chirp, bc.split) == (
            plan.m, plan.bhat, plan.chirp, plan.split)
        assert stft_cuda.bluestein_constants(cfg, FS, "cpu") is bc


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nperseg", [1024, 2049, 4110, 8182, 8185, 8189])
def test_cluster_halves_are_the_whole_buffer(nperseg):
    """The model's two half-buffers, indexed as the cluster's ranks index
    them (rank 1's first stage from rank 0's half, rank 0's last from rank
    1's, every other stage on a half alone), compute the one-block
    transform bitwise: at the cluster's own plans (8185, 8189) and at
    even M the route gives one block (1024, 2049, 4110, 8182)."""
    plan = tstft.bluestein_plan(nperseg)
    assert plan.m % 2 == 0 and plan.ranks == (2 if nperseg > 8184 else 1)
    rs = np.random.RandomState(nperseg)
    re, im = rs.randn(3, plan.n), rs.randn(3, plan.n)
    halves = torch_precision._bluestein_transform(
        re, im, plan._replace(ranks=2))
    whole = torch_precision._bluestein_transform(
        re, im, plan._replace(ranks=1))
    assert all(np.array_equal(a, b) for a, b in zip(halves, whole))


@pytest.mark.parametrize("nperseg", CASES)
def test_bluestein_model_against_a_long_double_dft(nperseg):
    """The model's float64 PSD of two frames (a pair for odd nperseg)
    against a dense DFT in long double, within 1e-12 of the clip max."""
    cfg = _config(nperseg, "constant")
    x = _clips(70 + nperseg, cfg, n_clips=1, frames=2)
    _assert_close(_model(x, cfg), _dense(x, cfg, np.longdouble), F64_TOL)


@pytest.mark.parametrize("detrend", DETRENDS)
@pytest.mark.parametrize("nperseg", CASES)
def test_bluestein_model_matches_plain_version(nperseg, detrend):
    cfg = _config(nperseg, detrend)
    assert stft_cuda.route(cfg) == "bluestein"
    x = _clips(80 + nperseg, cfg)
    got = _model(x, cfg)
    if nperseg > 4096:
        want = _dense(x, cfg)
    else:
        want = _plain(x, cfg)
        # and as the kernel stores it: float32, against the plain
        # version's float32 (both round once)
        plain32 = stft_cuda.stft_psd(torch.from_numpy(x), FS, cfg).numpy()
        _assert_close(_model(x, cfg, round_f32=True), plain32, 1.2e-7)
    assert got.shape == want.shape and got.shape[1] == 9
    _assert_close(got, want, F64_TOL)


def test_bluestein_model_two_sided_and_frames_alone():
    """onesided=False: the pair epilogue reads all K bins; and every frame
    transformed alone computes the same PSD."""
    cfg = SpecConfig(nperseg=563, hop=140, window="hann", detrend="none",
                     onesided=False)
    assert stft_cuda.route(cfg) == "bluestein" and cfg.n_freqs == 563
    x = _clips(81, cfg)
    want = _plain(x, cfg)
    _assert_close(_model(x, cfg), want, F64_TOL)
    _assert_close(_model(x, cfg, pack=False), want, F64_TOL)


@pytest.mark.parametrize("detrend", DETRENDS)
@pytest.mark.parametrize("nperseg,hop", [(563, 37), (1126, 563),
                                         (2049, 128)])
def test_bluestein_model_matches_the_jax_package(nperseg, hop, detrend):
    """The JAX package's matmul route, its own route for these configs
    (the Pallas kernel needs gcd(nperseg, hop) >= 8), at small hops where
    its framing allows (at 1126 a hop with gcd 2 takes its slice-and-
    concat framing 40 s to compile on the CPU); it sums in float32, and
    from 2048 through its two-stage Cooley-Tukey GEMM: held to the 2e-5
    of the clip max that the JAX package's own tests hold its PSD to
    against scipy (``tests/test_extended_modes.py``; 7.0e-6 measured at
    2049). Offset 1 and a twentieth of the ramp, as the odd route's
    test."""
    cfg = _config(nperseg, detrend, hop)
    jcfg = jconfig.SpecConfig.from_json(cfg.to_json())
    x = _clips(90 + nperseg, cfg, offset=0.0 if detrend == "none" else 1.0,
               trend=0.05)
    got = _model(x, cfg, round_f32=True)
    psd_j = np.asarray(jstft.power_spectrogram(jnp.asarray(x), FS, jcfg,
                                               use_matmul=True))
    assert got.shape == psd_j.shape
    _assert_close(got, psd_j, JAX_TOL)


@pytest.mark.parametrize("nperseg", [2049, 8182, 8185, 8189])
def test_bluestein_model_within_the_display_contract(nperseg):
    """scipy_default (path 8 is 8185, path 9 8182) against scipy in
    float64: 1e-6 dB, on a plain clip and on one whose frames the pairing
    must keep apart."""
    cfg = SpecConfig.scipy_default(nperseg)
    for pairs in (False, True):
        x = torch_precision.clip(cfg, 71, 3.0, pairs=pairs)
        psd = _model(x[None], cfg, round_f32=True)[0]
        assert psd.shape == (8, nperseg // 2 + 1)
        err = torch_precision.display_error_db(
            psd.T, x.astype(np.float64), cfg)
        assert err <= 1e-6, (pairs, err)


@pytest.mark.parametrize("nperseg", [563, 1126, 8185])
def test_pairing_keeps_zero_nan_and_quiet_frames_apart(nperseg):
    """A clip (scipy_default, T = 8) with frame 1 all zero, a NaN in frame
    3 and frame 5 at 1e-6 (``torch_precision.pair_breakers``): on odd
    nperseg the guard transforms frames 0-5 alone and pairs 6 with 7; on
    even nperseg every frame has its own transform. The zero frame's bins
    are exactly 0, the NaN stays in its frame, and each frame is within
    1e-12 of its own largest bin."""
    cfg = SpecConfig.scipy_default(nperseg)
    x = torch_precision.clip(cfg, 72, 3.0, pairs=True)
    if nperseg % 2:
        window = stft_cuda.bluestein_constants(cfg, FS, "cpu").window.numpy()
        v = torch_precision.detrended(
            torch_precision.frames_of(x, cfg).astype(np.float64),
            cfg.detrend) * window
        assert torch_precision.paired_frames(v).tolist() == [False] * 6 + [
            True, True]
    got = _model(x[None], cfg)[0]
    want = _dense(x[None], cfg)[0]
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).any(axis=1).tolist() == [False] * 3 + [True] + [
        False] * 4
    assert np.all(got[1] == 0.0) and np.all(want[1] == 0.0)
    for t in (0, 2, 4, 5, 6, 7):
        assert np.abs(got[t] - want[t]).max() <= F64_TOL * want[t].max(), t


def test_bluestein_model_overflow_like_the_plain_version():
    """|X|² past float32's range is inf, as in the GEMM route."""
    cfg = _config(563, "constant")
    x = _clips(73, cfg)
    x[1] *= 1e19
    want = stft_cuda.stft_psd(torch.from_numpy(x), FS, cfg).numpy()
    got = _model(x, cfg, round_f32=True)
    assert np.isinf(got[1]).any()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    ok = np.isfinite(want)
    scale = np.nanmax(np.where(ok, want, np.nan), axis=(1, 2))[:, None, None]
    diff = np.where(ok, got, 0.0) - np.where(ok, want, 0.0)
    assert np.all(np.abs(diff) <= 1.2e-7 * scale)


def test_forced_bluestein_route_is_checked():
    """``_route="bluestein"`` is accepted on any nperseg from 32 to 8192,
    whatever its own route (for timing), and refused below 32; on a CPU
    tensor every route is the plain version."""
    x = torch.from_numpy(_clips(74, SpecConfig.scipy_default(1023)))
    for cfg in (SpecConfig.scipy_default(1024), SpecConfig.scipy_default(992),
                SpecConfig.scipy_default(1023),
                SpecConfig.scipy_default(2049),
                SpecConfig(nperseg=32, hop=8, detrend="linear")):
        assert torch.equal(stft_cuda.stft_psd(x, FS, cfg,
                                              _route="bluestein"),
                           stft_cuda.stft_psd(x, FS, cfg))
    cfg = SpecConfig(nperseg=31, hop=8)
    assert stft_cuda.route(cfg) == "gemm"
    with pytest.raises(ValueError, match="'bluestein' route"):
        stft_cuda.stft_psd(x, FS, cfg, _route="bluestein")
    for own in ("fft", "mixed", "odd"):
        with pytest.raises(ValueError, match=f"'{own}' route"):
            stft_cuda.stft_psd(x, FS, SpecConfig.scipy_default(2049),
                               _route=own)
