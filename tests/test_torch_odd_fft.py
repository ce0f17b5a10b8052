"""The odd route of the port's STFT/PSD kernel and the Rader stage of the
odd and mixed-radix routes (spectral_tpu_torch.ops.stft_cuda.route,
mixed_constants; core.stft.fft_plan; csrc/stft_psd.cu::
stft_odd_fft_psd_kernel, which runs both on the pass engine), held on the
CPU through numpy models of the kernels' exact algorithms
(``tools/torch_precision.py::psd_odd_fft``: two frames of a clip a
transform, the pairing's guard, the pair epilogue; ``_transform``: the
Rader stage's stages in frequency, product and stages in time). The pass
engine itself, its loads and epilogues are transcribed in
``tests/test_torch_conv_registers.py``.

The models are held to the kernels' plain version (``stft_psd_reference``,
a float64 dense DFT) in float64, to the JAX package's Pallas kernel in
interpret mode where ``pallas_supported`` holds and its matmul route
where it does not, and to scipy in float64. Tolerances, each with its
reason:

- against the plain version, both in float64 before the float32 store:
  1e-12 of each clip's largest bin (the models sit within 2e-15 of
  numpy's float64 FFT on these clips). At 8186 and 8191 the plain
  version's (K, F) matrices take 537 MB each, so the comparison there is
  a dense float64 DFT of the detrended, windowed frames built 512 rows at
  a time. Under linear detrend the ramp clips take half the ramp, for the
  plain version's own rounding (``tests/test_torch_fft.py``).
- against the Pallas kernel and the JAX matmul route, which sum in
  float32: the 5e-6 of each clip's max that ``tests/test_torch_stft.py``
  holds the plain version to.
- against scipy in float64: 1e-6 dB of display error, three orders inside
  the 1e-3 dB contract.
- a frame the pairing's guard keeps apart: 1e-12 of that frame's own
  largest bin, and an all-zero frame's bins exactly 0, as the plain
  version gives.
"""

import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spectral_tpu import config as jconfig  # noqa: E402
from spectral_tpu.core import stft as jstft  # noqa: E402
from spectral_tpu.ops import stft_pallas  # noqa: E402
from spectral_tpu_torch import SpecConfig  # noqa: E402
from spectral_tpu_torch.core import stft as tstft  # noqa: E402
from spectral_tpu_torch.ops import stft_cuda  # noqa: E402
import torch_precision  # noqa: E402

FS = 16000.0
PSD_TOL = 5e-6          # against float32 arithmetic, of the clip's max
F64_TOL = 1e-12         # against a float64 dense DFT, of the clip's max
CSRC = os.path.join(os.path.dirname(stft_cuda.__file__), "csrc",
                    "stft_psd.cu")
RADER = [257, 514, 1021, 4093, 8186, 8191]


def _jax(cfg):
    return jconfig.SpecConfig.from_json(cfg.to_json())


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
    the ramp by default, for the plain version's rounding)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(n_clips, cfg.nperseg + (frames - 1) * cfg.hop_)
    if cfg.detrend == "linear":
        return (x + trend * torch_precision.trend(x.shape[-1])).astype(
            np.float32)
    return (x + offset).astype(np.float32)


def _model(x, cfg, round_f32=False, pack=True):
    """The route's kernel's PSD of each clip in x, (B, T, F), from the
    operands the wrapper hands the kernel."""
    mc = stft_cuda.mixed_constants(cfg, FS, "cpu")
    plan = tstft.fft_plan(cfg.nperseg)
    window, wts = mc.window.numpy(), mc.wts.numpy()
    out = []
    for clip in x:
        frames = torch_precision.frames_of(clip, cfg)
        if cfg.nperseg % 2:
            out.append(torch_precision.psd_odd_fft(
                frames, window, plan, wts, detrend=cfg.detrend,
                round_f32=round_f32, pack=pack))
        else:
            out.append(torch_precision.psd_mixed_fft(
                frames, window, plan, wts, detrend=cfg.detrend,
                round_f32=round_f32))
    return np.stack(out)


def _dense(x, cfg):
    """The float64 PSD by a dense DFT of the detrended, windowed frames,
    the (K, F) matrix built 512 rows at a time."""
    K, F = cfg.nperseg, cfg.n_freqs
    window = stft_cuda.mixed_constants(cfg, FS, "cpu").window.numpy()
    wts = tstft.onesided_weights(cfg, FS)
    f = np.arange(F)
    out = []
    for clip in x:
        v = torch_precision.detrended(
            torch_precision.frames_of(clip, cfg).astype(np.float64),
            cfg.detrend) * window
        re = np.zeros((v.shape[0], F))
        im = np.zeros_like(re)
        for i0 in range(0, K, 512):
            i = np.arange(i0, min(K, i0 + 512))
            ang = -2.0 * np.pi * ((i[:, None] * f[None]) % K) / K
            re += v[:, i] @ np.cos(ang)
            im += v[:, i] @ np.sin(ang)
        out.append((re * re + im * im) * wts)
    return np.stack(out)


def _plain(x, cfg):
    return stft_cuda.stft_psd_reference(
        torch.from_numpy(x).double(), stft_cuda.dft_constants(cfg, FS, "cpu"),
        cfg).numpy()


def _assert_close(got, want, tol):
    scale = want.max(axis=(-2, -1))
    err = np.abs(got - want).max(axis=(-2, -1))
    assert np.all(err <= tol * scale), err / scale


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nperseg", RADER)
def test_rader_plan_generator_orders_and_rows(nperseg):
    """The Rader plan of a prime transform length p (nperseg, or
    nperseg/2): g the smallest primitive root; value g^q at slot q and
    x[0] at slot P = p - 1 (the output map too); the P-point sub-plan's
    stages with rows over P; for even nperseg the split rows last."""
    plan = tstft.fft_plan(nperseg)
    p = tstft.transform_length(nperseg)
    P = p - 1
    assert tstft.rader_prime(p) and plan.rader >= 0
    g = plan.generator
    qs = set(tstft.fft_radices(P))
    assert all(pow(g, P // q, p) != 1 for q in qs)
    assert not any(all(pow(h, P // q, p) != 1 for q in qs)
                   for h in range(2, g))
    assert plan.perm.dtype == np.int32 and plan.perm[0] == P
    assert np.array_equal(np.sort(plan.perm), np.arange(p))
    for q in (0, 1, 2, P // 3, P - 1):
        assert plan.perm[pow(g, q, p)] == q
    factors = plan.stages[:, 0].tolist()
    assert factors == list(tstft.fft_radices(P)) == list(
        tstft.plan_radices(nperseg))
    assert int(np.prod(factors)) == P
    tw = plan.twiddles
    for r, L, tw_row, root_row in plan.stages.tolist():
        q, k = np.meshgrid(np.arange(1, r), np.arange(L), indexing="ij")
        rows = tw[tw_row:tw_row + (r - 1) * L]
        want = np.exp(-2j * np.pi * (q * k).ravel() / (L * r))
        assert np.allclose(rows[:, 0] + 1j * rows[:, 1], want, atol=1e-15)
        if r % 2:
            roots = tw[root_row:root_row + r]
            assert np.allclose(roots[:, 0] + 1j * roots[:, 1],
                               np.exp(-2j * np.pi * np.arange(r) / r),
                               atol=1e-15)
    assert plan.rader + P == (plan.split if nperseg % 2 == 0 else len(tw))
    if nperseg % 2 == 0:
        ang = -2.0 * np.pi * np.arange(p) / nperseg
        assert np.array_equal(tw[plan.split:],
                              np.stack([np.cos(ang), np.sin(ang)], axis=1))
        assert plan.split + p == len(tw)
    else:
        assert plan.split == -1


@pytest.mark.parametrize("nperseg", [257, 1021])
def test_rader_kernel_rows_against_a_long_double_dft(nperseg):
    """b̂ = DFT_P(W_p^(g^-q)) / P, the rows in the sub-plan's digit-reversed
    slot order, against the same DFT summed in long double."""
    plan = tstft.fft_plan(nperseg)
    p = tstft.transform_length(nperseg)
    P = p - 1
    g = plan.generator
    sub_perm = tstft._dit_plan(P, P)[1]
    rows = plan.twiddles[plan.rader:plan.rader + P]
    bhat = (rows[:, 0] + 1j * rows[:, 1])[sub_perm]
    ld = np.longdouble
    e = np.array([pow(g, (P - q) % P, p) for q in range(P)], np.int64)
    ang_b = -2 * ld(np.pi) * e.astype(ld) / p
    qk = (np.arange(P)[:, None] * np.arange(P)[None]) % P
    ang = -2 * ld(np.pi) * qk.astype(ld) / P
    # (b_re + i b_im)(c + i s) summed over q
    c, s = np.cos(ang), np.sin(ang)
    br, bi = np.cos(ang_b), np.sin(ang_b)
    want_re = (br[:, None] * c - bi[:, None] * s).sum(axis=0) / P
    want_im = (br[:, None] * s + bi[:, None] * c).sum(axis=0) / P
    err = np.abs(bhat - (want_re.astype(np.float64)
                         + 1j * want_im.astype(np.float64)))
    assert err.max() <= 1e-15 * np.abs(bhat).max(), err.max()
    # its magnitudes are those of a Gauss sum: sqrt(p) / P, and 1/P at 0
    assert abs(abs(bhat[0]) - 1.0 / P) <= 1e-15
    assert np.allclose(np.abs(bhat[1:]), np.sqrt(p) / P, rtol=1e-12)


@pytest.mark.parametrize("nperseg", [33, 45, 1023, 4095])
def test_odd_plan_without_a_rader_stage(nperseg):
    """An odd nperseg whose primes are all at most 255: a K-point plan of
    its factors, the digit-reversed load, rows over K, no split rows."""
    plan = tstft.fft_plan(nperseg)
    assert plan.rader == -1 and plan.split == -1 and plan.generator == 0
    factors = plan.stages[:, 0].tolist()
    assert factors == list(tstft.fft_radices(nperseg))
    assert int(np.prod(factors)) == nperseg
    assert np.array_equal(np.sort(plan.perm), np.arange(nperseg))
    tw = plan.twiddles
    for r, L, tw_row, root_row in plan.stages.tolist():
        q, k = np.meshgrid(np.arange(1, r), np.arange(L), indexing="ij")
        j = (q * k * (nperseg // (L * r))).ravel() % nperseg
        ang = -2.0 * np.pi * j / nperseg
        assert np.array_equal(tw[tw_row:tw_row + (r - 1) * L],
                              np.stack([np.cos(ang), np.sin(ang)], axis=1))
    assert stft_cuda.route(SpecConfig.scipy_default(nperseg)) == "odd"


def test_odd_constants_build_no_dft_matrix(monkeypatch):
    """The odd route's set-up never builds the (K, F) matrices (537 MB in
    float64 at 8191)."""
    def refuse(cfg):
        raise AssertionError("the odd route built a DFT matrix")

    monkeypatch.setattr(stft_cuda, "dft_matrices", refuse)
    monkeypatch.setattr(tstft, "dft_matrices", refuse)
    cfg = SpecConfig.scipy_default(8191, log_scale=True)
    mc = stft_cuda.mixed_constants(cfg, FS, "cpu")
    plan = tstft.fft_plan(8191)
    assert mc.perm.shape == (8191,) and mc.wts.shape == (4096,)
    assert np.array_equal(mc.twiddles.numpy(), plan.twiddles)
    assert (mc.split, mc.rader) == (-1, plan.rader)
    assert stft_cuda.mixed_constants(cfg, FS, "cpu") is mc      # cached


def _cuda_double(name):
    with open(CSRC) as fh:
        m = re.search(rf"constexpr double {name} = ([0-9.e+]+);", fh.read())
    return float(m.group(1))


def test_kernel_and_model_share_the_guard_and_launch_counts():
    assert _cuda_double("PAIR_MAX_RATIO") == torch_precision.PAIR_MAX_RATIO
    assert set(stft_cuda.launches) == {"gemm", "fft", "mixed", "odd",
                                       "bluestein"}


# ---------------------------------------------------------------------------
# the models against the plain version, JAX and scipy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("detrend", ["none", "constant", "linear"])
@pytest.mark.parametrize("nperseg", [33, 45, 257, 514, 1021, 1023, 8186,
                                     8191])
def test_odd_and_rader_models_match_plain_version(nperseg, detrend):
    cfg = _config(nperseg, detrend)
    assert stft_cuda.route(cfg) == ("odd" if nperseg % 2 else "mixed")
    x = _clips(30 + nperseg, cfg)
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


def test_odd_model_two_sided_and_frames_alone():
    """onesided=False: the pair epilogue reads all K bins; and every frame
    transformed alone (the kernel's packing off) computes the same PSD."""
    cfg = SpecConfig(nperseg=1021, hop=255, window="hann", detrend="none",
                     onesided=False)
    assert stft_cuda.route(cfg) == "odd" and cfg.n_freqs == 1021
    x = _clips(61, cfg)
    want = _plain(x, cfg)
    _assert_close(_model(x, cfg), want, F64_TOL)
    _assert_close(_model(x, cfg, pack=False), want, F64_TOL)


@pytest.mark.parametrize("detrend", ["none", "constant", "linear"])
@pytest.mark.parametrize("nperseg,hop", [(45, 9), (1023, 33), (257, 257),
                                         (33, 29), (1021, 894)])
def test_odd_model_matches_the_jax_package(nperseg, hop, detrend):
    """The Pallas kernel in interpret mode where ``pallas_supported``
    holds (gcd(nperseg, hop) >= 8), else the JAX package's matmul route;
    both sum in float32: offset 1 and a twentieth of the ramp, as
    ``tests/test_torch_fft.py`` holds the radix-2 model to the Pallas
    kernel."""
    cfg = _config(nperseg, detrend, hop)
    jcfg = _jax(cfg)
    x = _clips(40 + nperseg, cfg, offset=0.0 if detrend == "none" else 1.0,
               trend=0.05)
    got = _model(x, cfg, round_f32=True)
    if stft_pallas.pallas_supported(jcfg):
        psd_j, lo_j, hi_j = (np.asarray(a) for a in jax.jit(
            lambda v: stft_pallas.stft_psd_pallas(v, FS, jcfg,
                                                  with_stats=True))(
                jnp.asarray(x)))
        np.testing.assert_allclose(got.max(axis=(1, 2)), hi_j, rtol=1e-5)
        assert np.all(np.abs(got.min(axis=(1, 2)) - lo_j) <= PSD_TOL * hi_j)
    else:
        assert (nperseg, hop) in ((33, 29), (1021, 894))
        psd_j = np.asarray(jstft.power_spectrogram(jnp.asarray(x), FS, jcfg,
                                                   use_matmul=True))
    assert got.shape == psd_j.shape
    _assert_close(got, psd_j, PSD_TOL)


@pytest.mark.parametrize("nperseg", [4093, 8186, 8191])
def test_odd_and_rader_models_within_the_display_contract(nperseg):
    """scipy_default at the Rader primes (path 7 is 8191) and 8186 = 2 ·
    4093, against scipy in float64: 1e-6 dB, on a plain clip and on one
    whose frames the pairing must keep apart."""
    cfg = SpecConfig.scipy_default(nperseg)
    for pairs in (False, True):
        x = torch_precision.clip(cfg, 62, 3.0, pairs=pairs)
        psd = _model(x[None], cfg, round_f32=True)[0]
        assert psd.shape == (8, nperseg // 2 + 1)
        err = torch_precision.display_error_db(
            psd.T, x.astype(np.float64), cfg)
        assert err <= 1e-6, (pairs, err)


# ---------------------------------------------------------------------------
# the pairing's guard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nperseg", [45, 1023, 8191])
def test_pairing_keeps_zero_nan_and_quiet_frames_apart(nperseg):
    """A clip (scipy_default, T = 8) with frame 1 all zero, a NaN in frame
    3 and frame 5 at 1e-6 (``torch_precision.pair_breakers``): the guard
    transforms frames 0-5 alone and pairs 6 with 7; the zero frame's bins
    are exactly 0, the NaN stays in its frame, and each frame is within
    1e-12 of its own largest bin."""
    cfg = SpecConfig.scipy_default(nperseg)
    x = torch_precision.clip(cfg, 63, 3.0, pairs=True)
    frames = torch_precision.frames_of(x, cfg).astype(np.float64)
    window = stft_cuda.mixed_constants(cfg, FS, "cpu").window.numpy()
    v = torch_precision.detrended(frames, cfg.detrend) * window
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


def test_packing_a_quiet_frame_beside_a_loud_one_would_couple_them():
    """Why the guard exists: transformed together, a frame at 1e-9 of its
    partner takes the partner's rounding, past 1 float32 ulp in its own
    deep bins, and an all-zero frame stops being zero. (At 1e-6 this clip
    still holds 1.5e-8, a quarter ulp: the guard's 48 dB leaves a wide
    margin.)"""
    cfg = SpecConfig(nperseg=1023, hop=1023, window="hann", detrend="none")
    plan = tstft.fft_plan(1023)
    window = stft_cuda.mixed_constants(cfg, FS, "cpu").window.numpy()
    rs = np.random.RandomState(64)
    loud = rs.randn(1023)
    for quiet_frame in (1e-9 * rs.randn(1023), np.zeros(1023)):
        quiet = quiet_frame * window
        re = np.empty((1, 1023))
        im = np.empty((1, 1023))
        re[:, plan.perm] = loud * window
        im[:, plan.perm] = quiet
        zr, zi = torch_precision._transform(re, im, plan, 1023)
        f = np.arange(512)
        j = (1023 - f) % 1023
        br, bi = 0.5 * (zi[0, f] + zi[0, j]), 0.5 * (zr[0, j] - zr[0, f])
        packed = br * br + bi * bi
        X = np.fft.rfft(quiet)
        exact = X.real ** 2 + X.imag ** 2
        if quiet.any():
            assert np.max(np.abs(packed - exact) / exact) > 1e-7
        else:
            assert packed.max() > 0.0
        # the model's guard transforms them apart: exact to rounding
        alone = torch_precision.psd_odd_fft(
            np.stack([loud, quiet_frame]), window, plan, np.ones(512),
            round_f32=False)[1]
        if quiet.any():
            assert np.max(np.abs(alone - exact) / exact) < 1e-9
        else:
            assert np.all(alone == 0.0)


def test_forced_odd_route_is_checked():
    """``_route="odd"`` is the config's own route only; on a CPU tensor
    every route is the plain version."""
    x = torch.from_numpy(_clips(65, SpecConfig.scipy_default(1023)))
    for cfg in (SpecConfig.scipy_default(1024), SpecConfig.scipy_default(992),
                SpecConfig.scipy_default(8185)):
        with pytest.raises(ValueError, match="'odd' route"):
            stft_cuda.stft_psd(x, FS, cfg, _route="odd")
    cfg = SpecConfig.scipy_default(1023)
    want = stft_cuda.stft_psd(x, FS, cfg)
    assert torch.equal(stft_cuda.stft_psd(x, FS, cfg, _route="odd"), want)
    assert torch.equal(stft_cuda.stft_psd(x, FS, cfg, _route="gemm"), want)
