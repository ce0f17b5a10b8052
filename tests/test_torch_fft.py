"""The FFT route of the port's STFT/PSD kernel (spectral_tpu_torch.ops.
stft_cuda.route, fft_constants; csrc/stft_psd.cu::stft_fft_psd_kernel),
held on the CPU through a numpy model of the kernel's exact algorithm
(``tools/torch_precision.py::psd_fft``: the same bit-reversed load, the
same radix-2 butterfly order, the same host twiddle table).

The model is held to the kernels' plain version (``stft_psd_reference``,
a float64 dense DFT) in float64, to the JAX package's Pallas kernel in
interpret mode (as ``tests/test_torch_stft.py`` runs it), and to scipy in
float64. Tolerances, each with its reason:

- against the plain version, both in float64 before the float32 store:
  1e-12 of each clip's largest bin. Both sum in float64 in other orders;
  the largest departure measured is 7.3e-14 (nperseg 1024, constant
  detrend, noise + 3). Under linear detrend the clips are ramps, and the
  plain version, whose GEMM multiplies the raw samples, rounds in
  proportion to their size: on the full ramp (3 to 43) it sits 1.1e-12
  of the clip max from a long-double DFT at nperseg 992, where the
  model's detrend-first arithmetic sits at 6.8e-15. So those cases take
  half the ramp (1.0e-13 at 1024, 6.2e-13 at 992).
- against the Pallas kernel, which sums in float32: the 5e-6 of each
  clip's max that ``tests/test_torch_stft.py`` holds the plain version to.
- against scipy in float64: 1e-6 dB of display error, three orders inside
  the 1e-3 dB contract (the float64 GEMM route sits at 2.7e-7 dB there).
"""

import dataclasses
import inspect
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
F64_TOL = 1e-12         # against the float64 dense DFT, of the clip's max


def _jax(cfg):
    return jconfig.SpecConfig.from_json(cfg.to_json())


def _config(nperseg, detrend):
    """nperseg with hop nperseg/4: a Hann window for detrend none (the
    north_star family), scipy's Tukey 0.25 for constant and linear.
    (scipy's own hop, 7/8 nperseg, has gcd 4 with nperseg 32, which the
    Pallas kernel refuses.)"""
    if detrend == "none":
        return SpecConfig.north_star(nperseg, nperseg // 4)
    return SpecConfig(nperseg=nperseg, hop=nperseg // 4, detrend=detrend)


def _clips(seed, cfg, n_clips=2, offset=3.0, trend=1.0):
    """White noise plus offset; under linear detrend, ramp clips instead:
    noise plus ``trend`` times the trend 5·t + 3 of
    ``tests/test_extended_modes.py``, scaled to the clip's length
    (``torch_precision.trend``), whose slope a frame's line must remove."""
    rs = np.random.RandomState(seed)
    x = rs.randn(n_clips, 8 * cfg.nperseg)
    if cfg.detrend == "linear":
        return (x + trend * torch_precision.trend(x.shape[-1])).astype(
            np.float32)
    return (x + offset).astype(np.float32)


def _model(x, cfg, round_f32=False):
    """The FFT kernel's PSD of each clip in x, (B, T, F), from the operands
    the wrapper hands the kernel."""
    ops = [t.numpy() for t in stft_cuda.fft_constants(cfg, FS, "cpu")]
    return np.stack([torch_precision.psd_fft(
        torch_precision.frames_of(clip, cfg), *ops, detrend=cfg.detrend,
        round_f32=round_f32) for clip in x])


def _assert_close(got, want, tol):
    scale = want.max(axis=(-2, -1))
    err = np.abs(got - want).max(axis=(-2, -1))
    assert np.all(err <= tol * scale), err / scale


def test_fft_route_on_the_gui_range():
    """The routes on the GUI's range (32-8192 in steps of 32): under every
    detrend, linear too, its 9 powers of two take the FFT kernel and its
    other 247 values the mixed-radix kernel; the GEMM kernel computes no
    GUI value. Off the grid, every nperseg from 32 to 8192: the odd route
    and the Rader stage take 3,103 values that the GEMM kernel computed
    before them (odd nperseg whose primes are all at most 255, and
    transform lengths that are a prime p whose p - 1 has none past 255),
    and the Bluestein route the other 2,389 (a prime past 255 beside
    other factors, such as 2049 = 3 · 683, or one whose p - 1 has a prime
    past 255, such as 8185 = 5 · 1637); the GEMM kernel keeps nperseg
    below 32, and is forced on any config (the test below)."""
    gui = range(32, 8193, 32)
    counts = {"fft": 0, "mixed": 0}
    linear = {"fft": 0, "mixed": 0}
    for k in gui:
        want = "fft" if k & (k - 1) == 0 else "mixed"
        for cfg in (SpecConfig.scipy_default(k),
                    SpecConfig.north_star(k, max(1, k // 4))):
            assert stft_cuda.route(cfg) == want, k
        counts[want] += 1
        got = stft_cuda.route(SpecConfig(nperseg=k, detrend="linear"))
        assert got == want, k
        linear[got] += 1
    assert counts == {"fft": 9, "mixed": 247}
    assert linear == {"fft": 9, "mixed": 247}
    for k in (992, 8160, 960, 100, 8032, 2 * 257, 2 * 4093):
        assert stft_cuda.route(SpecConfig.scipy_default(k)) == "mixed"
    for k in (33, 45, 99, 257, 1021, 1023, 4093, 8191):
        assert stft_cuda.route(SpecConfig.scipy_default(k)) == "odd"
    for cfg, want in ((SpecConfig.north_star(16, 4), "gemm"),  # below 32
                      (SpecConfig.north_star(31, 8), "gemm"),
                      (SpecConfig.scipy_default(2049), "bluestein"),
                      (SpecConfig.scipy_default(2 * 771), "bluestein"),
                      (SpecConfig.scipy_default(8185), "bluestein")):
        assert stft_cuda.route(cfg) == want
        assert stft_cuda.route(dataclasses.replace(
            cfg, detrend="linear")) == want
    # the whole range against the rule before the odd route: odd nperseg
    # and nperseg/2 with an odd prime past 255 took the GEMM kernel; what
    # the odd and mixed routes left it, the Bluestein route takes
    before, after = set(), set()
    for k in range(32, 8193):
        cfg = SpecConfig(nperseg=k, hop=k // 4)
        if k % 2 or max(tstft.fft_radices(k // 2)) > 255:
            before.add(k)
        got = stft_cuda.route(cfg)
        assert got != "gemm", k
        if got == "bluestein":
            after.add(k)
    assert after <= before
    assert (len(before - after), len(after)) == (3103, 2389)
    for cfg in (SpecConfig.scipy_default(16384),      # past the GUI
                SpecConfig(nperseg=256, nfft=512),    # unsupported anywhere
                SpecConfig(nperseg=256, mode="magnitude")):
        with pytest.raises(NotImplementedError):
            stft_cuda.route(cfg)
    # the route does not depend on the band or the mel branch
    for k in (24, 256, 8160, 8191, 8185):
        plain = SpecConfig.scipy_default(k)
        assert stft_cuda.route(dataclasses.replace(
            plain, n_mels=32)) == stft_cuda.route(plain)
        assert stft_cuda.route(dataclasses.replace(
            plain, fmin=10.0, fmax=300.0)) == stft_cuda.route(plain)
    # a pure function of the config: equal configs, equal answers
    for k in (1024, 8160):
        assert stft_cuda.route(SpecConfig.scipy_default(k)) == \
            stft_cuda.route(SpecConfig.from_json(
                SpecConfig.scipy_default(k).to_json()))


@pytest.mark.parametrize("nperseg", [32, 1024, 8192])
def test_fft_tables_are_numpys_float64_values(nperseg):
    cfg = SpecConfig.scipy_default(nperseg)
    fc = stft_cuda.fft_constants(cfg, FS, "cpu")
    assert all(t.dtype == torch.float64 for t in fc)
    # numpy's cos and sin of -2π j / K, j < K/2, laid out stage by stage:
    # row h - 1 + k is W_2h^k, j = k K / 2h
    ang = -2.0 * np.pi * np.arange(nperseg // 2) / nperseg
    assert fc.twiddles.shape == (nperseg - 1, 2)
    h = 1
    while h < nperseg:
        rows = fc.twiddles[h - 1:2 * h - 1].numpy()
        j = np.arange(h) * (nperseg // (2 * h))
        assert np.array_equal(rows[:, 0], np.cos(ang)[j])
        assert np.array_equal(rows[:, 1], np.sin(ang)[j])
        h *= 2
    # the window and weights are the JAX package's host values, bitwise
    assert np.array_equal(fc.window.numpy(), jstft._window_f64(_jax(cfg)))
    assert np.array_equal(fc.wts.numpy(),
                          jstft.onesided_weights(_jax(cfg), FS))
    assert fc.wts.shape == (cfg.n_freqs,)


def test_fft_constants_build_no_dft_matrix(monkeypatch):
    """The FFT route's set-up never builds the (K, F) matrices (537 MB in
    float64 at 8192, 1.7 s on the host)."""
    def refuse(cfg):
        raise AssertionError("the FFT route built a DFT matrix")

    monkeypatch.setattr(stft_cuda, "dft_matrices", refuse)
    cfg = SpecConfig.scipy_default(8192, log_scale=True)
    fc = stft_cuda.fft_constants(cfg, FS, "cpu")
    assert fc.window.shape == (8192,) and fc.wts.shape == (4097,)
    assert stft_cuda.fft_constants(cfg, FS, "cpu") is fc      # cached


def test_bit_reverse_is_the_kernels_load_order():
    for k in (32, 1024, 8192):
        bits = k.bit_length() - 1
        rev = torch_precision.bit_reverse(k)
        want = [int(format(p, f"0{bits}b")[::-1], 2) for p in range(k)]
        assert rev.tolist() == want
        assert np.array_equal(rev[rev], np.arange(k))


@pytest.mark.parametrize("detrend", ["none", "constant", "linear"])
@pytest.mark.parametrize("nperseg", [32, 256, 1024])
def test_fft_model_matches_plain_version(nperseg, detrend):
    cfg = _config(nperseg, detrend)
    # half the ramp: the plain version's own rounding grows with the
    # samples' size (module docstring)
    x = _clips(20 + nperseg, cfg, trend=0.5)
    want = stft_cuda.stft_psd_reference(
        torch.from_numpy(x).double(), stft_cuda.dft_constants(cfg, FS, "cpu"),
        cfg).numpy()
    got = _model(x, cfg)
    assert got.shape == want.shape and got.shape[1] >= 7
    _assert_close(got, want, F64_TOL)
    # and as the kernel stores it: float32, against the plain version's
    # float32 (both round once)
    plain32 = stft_cuda.stft_psd(torch.from_numpy(x), FS, cfg).numpy()
    _assert_close(_model(x, cfg, round_f32=True), plain32, 1.2e-7)


@pytest.mark.parametrize("detrend", ["none", "constant", "linear"])
@pytest.mark.parametrize("nperseg", [32, 256, 1024])
def test_fft_model_matches_pallas_kernel(nperseg, detrend):
    """The Pallas kernel sums in float32, so its rounding grows with the
    samples' size: the offset is 1 rather than 3, and the ramp a twentieth
    of the others' (from 0.15 to 2.15; the full 3 to 43 puts the Pallas
    kernel 1.2e-5 to 3.9e-5 of the clip max from the float64 PSD). That
    ramp still moves the PSD far from the constant detrend's."""
    cfg = _config(nperseg, detrend)
    x = _clips(40 + nperseg, cfg, offset=0.0 if detrend == "none" else 1.0,
               trend=0.05)
    if detrend == "linear":
        lin = _model(x, cfg)
        const = _model(x, dataclasses.replace(cfg, detrend="constant"))
        assert np.all(np.abs(const - lin).max(axis=(1, 2))
                      > 1e-2 * lin.max(axis=(1, 2)))
    psd_j, lo_j, hi_j = (np.asarray(a) for a in jax.jit(
        lambda v: stft_pallas.stft_psd_pallas(v, FS, _jax(cfg),
                                              with_stats=True))(
            jnp.asarray(x)))
    got = _model(x, cfg, round_f32=True)
    assert got.shape == psd_j.shape
    _assert_close(got, psd_j, PSD_TOL)
    np.testing.assert_allclose(got.max(axis=(1, 2)), hi_j, rtol=1e-5)
    assert np.all(np.abs(got.min(axis=(1, 2)) - lo_j) <= PSD_TOL * hi_j)


def test_fft_model_two_sided():
    """onesided=False: the kernel's epilogue reads all K bins of its
    complex transform."""
    cfg = SpecConfig(nperseg=256, hop=64, window="hann", detrend="none",
                     onesided=False)
    assert stft_cuda.route(cfg) == "fft" and cfg.n_freqs == 256
    x = _clips(60, cfg)
    want = stft_cuda.stft_psd_reference(
        torch.from_numpy(x).double(), stft_cuda.dft_constants(cfg, FS, "cpu"),
        cfg).numpy()
    _assert_close(_model(x, cfg), want, F64_TOL)


def test_fft_model_scipy_8192_within_the_display_contract():
    cfg = SpecConfig.scipy_default(8192)
    x = _clips(61, cfg, n_clips=1)
    psd = _model(x, cfg, round_f32=True)[0]
    assert psd.dtype == np.float32 and psd.shape == (9, 4097)
    err = torch_precision.display_error_db(psd.T, x[0].astype(np.float64),
                                           cfg)
    assert err <= 1e-6, err


def test_fft_model_nan_and_overflow_like_the_plain_version():
    """A NaN sample makes its frames' every bin NaN (the butterflies
    spread it as the dense DFT's sums do), and |X|² past float32's range
    is inf, as in the GEMM route."""
    cfg = _config(256, "constant")
    x = _clips(62, cfg)
    x[0, 700] = np.nan
    x[1] *= 1e19
    want = stft_cuda.stft_psd(torch.from_numpy(x), FS, cfg).numpy()
    got = _model(x, cfg, round_f32=True)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0]).any() and np.isinf(got[1]).any()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    ok = np.isfinite(want)
    scale = np.nanmax(np.where(ok, want, np.nan), axis=(1, 2))[:, None, None]
    assert np.all(np.abs(np.where(ok, got - want, 0.0)) <= 1.2e-7 * scale)


def test_forced_route_is_checked():
    """The module-private ``_route`` forces a kernel on the card: the GEMM
    kernel on any config, the FFT and mixed-radix kernels only on the
    configs :func:`route` gives them, under linear detrend too. On a CPU
    tensor every route is the plain version."""
    x = torch.from_numpy(_clips(63, SpecConfig.scipy_default(992)))
    linear992 = SpecConfig(nperseg=992, hop=248, detrend="linear")
    linear1024 = SpecConfig(nperseg=1024, hop=256, detrend="linear")
    for cfg in (SpecConfig.scipy_default(992), linear992):
        with pytest.raises(ValueError, match="'fft' route"):
            stft_cuda.stft_psd(x, FS, cfg, _route="fft")
    for cfg in (SpecConfig.scipy_default(1024), linear1024):
        with pytest.raises(ValueError, match="'mixed' route"):
            stft_cuda.stft_psd(x, FS, cfg, _route="mixed")
    for cfg, own in ((linear992, "mixed"), (linear1024, "fft")):
        assert stft_cuda.route(cfg) == own
        assert torch.equal(stft_cuda.stft_psd(x, FS, cfg, _route=own),
                           stft_cuda.stft_psd(x, FS, cfg))
        assert torch.equal(stft_cuda.stft_psd(x, FS, cfg, _route="gemm"),
                           stft_cuda.stft_psd(x, FS, cfg))
    with pytest.raises(ValueError, match="'dense' route"):
        stft_cuda.stft_psd(x, FS, SpecConfig.scipy_default(1024),
                           _route="dense")
    for cfg in (SpecConfig.scipy_default(1024), SpecConfig.scipy_default(992),
                SpecConfig.scipy_default(2049)):
        assert torch.equal(stft_cuda.stft_psd(x, FS, cfg, _route="gemm"),
                           stft_cuda.stft_psd(x, FS, cfg))
    cfg = SpecConfig.scipy_default(992)
    assert torch.equal(stft_cuda.stft_psd(x, FS, cfg, _route="mixed"),
                       stft_cuda.stft_psd(x, FS, cfg))


def test_detrend_codes_are_the_kernels():
    """The wrapper hands the FFT kernels a three-valued detrend code, the
    CUDA source's DETREND_* constants, and both launchers refuse any
    other value."""
    assert stft_cuda.DETREND_CODES == {"none": 0, "constant": 1,
                                       "linear": 2}
    assert "detrend = DETREND_CODES[cfg.detrend]" in inspect.getsource(
        stft_cuda._stft_psd_cuda)
    csrc = os.path.join(os.path.dirname(stft_cuda.__file__), "csrc",
                        "stft_psd.cu")
    with open(csrc) as fh:
        src = fh.read()
    for mode, code in stft_cuda.DETREND_CODES.items():
        m = re.search(rf"constexpr int DETREND_{mode.upper()} = (\d+);", src)
        assert m and int(m.group(1)) == code, mode
    for launcher in ("stft_fft_psd_launch", "stft_mixed_fft_psd_launch"):
        body = src[src.index(f"int {launcher}("):]
        body = body[:body.index("return static_cast<int>(cudaGetLastError")]
        assert "!detrend_ok(detrend)" in body, launcher


@pytest.mark.parametrize("nperseg", [256, 1024, 8192])
def test_fft_model_linear_detrend_within_the_display_contract(nperseg):
    """Under linear detrend on a ramp clip, the model against scipy's
    detrend='linear' in float64: 1e-6 dB, as the other detrends."""
    cfg = dataclasses.replace(SpecConfig.scipy_default(nperseg),
                              detrend="linear")
    assert stft_cuda.route(cfg) == "fft"
    x = _clips(64, cfg, n_clips=1)
    psd = _model(x, cfg, round_f32=True)[0]
    err = torch_precision.display_error_db(psd.T, x[0].astype(np.float64),
                                           cfg)
    assert err <= 1e-6, err
