"""The port's fmin/fmax band mask and reference-parity entry points on the
CPU (spectral_tpu_torch.core.stft: band_row_slice, mask_band_rows,
effective_config, spectrogram, power_spectrogram_fm(band=); ops.stft_cuda's
band), held against the JAX package on the same seeded inputs, and the
PSD entry points' kernel route for a tensor off the CPU.

Tolerances:
- band_row_slice, mask_band_rows, effective_config, the axes: exact (the
  same numpy code), the same error and warning texts;
- spectrogram and power_spectrogram_fm against JAX's matmul route: 5e-6
  of each image's largest value (JAX's float32 GEMMs against the port's
  plain float32 GEMM, the tolerance of tests/test_torch_pipeline.py);
- the banded plain version against the full band's columns: bitwise (the
  float64 plain version of the kernels; each bin the same dot product).
"""

import dataclasses
import warnings

import numpy as np
import pytest
import scipy.signal

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spectral_tpu import config as jconfig  # noqa: E402
from spectral_tpu.core import stft as jstft  # noqa: E402
from spectral_tpu_torch import SpecConfig  # noqa: E402
from spectral_tpu_torch.core import scale as tscale  # noqa: E402
from spectral_tpu_torch.core import stft as tstft  # noqa: E402
from spectral_tpu_torch.ops import stft_cuda  # noqa: E402

PSD_TOL = 5e-6


def _jax(cfg):
    return jconfig.SpecConfig.from_json(cfg.to_json())


def _raises_like(fn_port, fn_jax, exc=ValueError):
    with pytest.raises(exc) as want:
        fn_jax()
    with pytest.raises(exc) as got:
        fn_port()
    assert str(got.value) == str(want.value)


AXES = [
    ("scipy_1024_eeg", SpecConfig.scipy_default(1024), 1000.0),
    ("north_512", SpecConfig.north_star(512, 128), 16000.0),
    ("odd_33", SpecConfig.scipy_default(33), 250.0),
    ("two_sided", SpecConfig(nperseg=64, hop=16, onesided=False,
                             detrend="none", window="hann"), 1000.0),
]
BANDS = [(None, None), (0.0, 30.0), (None, 30.0), (5.0, None), (5.0, 80.0),
         (31.25, 31.25), (-10.0, 0.0), (400.0, 500.0), (600.0, 700.0),
         (-300.0, -100.0)]


@pytest.mark.parametrize("name,cfg,fs", AXES, ids=[a[0] for a in AXES])
def test_band_row_slice_and_mask_match_jax(name, cfg, fs):
    f = tstft.freq_axis(cfg, fs)
    assert np.array_equal(f, jstft.freq_axis(_jax(cfg), fs))
    sxx = np.random.RandomState(0).rand(2, len(f), 7).astype(np.float32)
    for fmin, fmax in BANDS:
        try:
            want = jstft.band_row_slice(f, fmin, fmax)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tstft.band_row_slice(f, fmin, fmax)
            assert str(got.value) == str(e)
        else:
            assert tstft.band_row_slice(f, fmin, fmax) == want
        f_w, s_w = jstft.mask_band_rows(f, sxx, fmin, fmax)
        f_n, s_n = tstft.mask_band_rows(f, sxx, fmin, fmax)
        f_t, s_t = tstft.mask_band_rows(f, torch.from_numpy(sxx), fmin,
                                        fmax)
        _, s_j = jstft.mask_band_rows(f, jnp.asarray(sxx), fmin, fmax)
        assert np.array_equal(f_n, f_w) and np.array_equal(f_t, f_w)
        assert isinstance(s_n, np.ndarray) and np.array_equal(s_n, s_w)
        assert torch.is_tensor(s_t) and np.array_equal(s_t.numpy(), s_w)
        assert np.array_equal(np.asarray(s_j), s_w)


def test_band_row_slice_refuses_like_jax():
    f = tstft.freq_axis(AXES[3][1], 1000.0)       # fftfreq order
    _raises_like(lambda: tstft.band_row_slice(f, -100.0, 100.0),
                 lambda: jstft.band_row_slice(f, -100.0, 100.0))
    f1 = tstft.freq_axis(SpecConfig.scipy_default(256), 1000.0)
    _raises_like(lambda: tstft.band_row_slice(f1, 600.0, 700.0),
                 lambda: jstft.band_row_slice(f1, 600.0, 700.0))
    with pytest.raises(ValueError, match="no frequency rows"):
        tstft.band_row_slice(f1, 600.0, 700.0)
    with pytest.raises(ValueError, match="non-contiguous"):
        tstft.band_row_slice(f, -100.0, 100.0)


@pytest.mark.parametrize("n,cfg", [
    (300, SpecConfig.scipy_default(1024)),
    (1024, SpecConfig.scipy_default(1024)),
    (300, SpecConfig.north_star(1024, 256)),           # explicit hop: kept
    (300, SpecConfig.scipy_default(1024, center=True)),
    (0, SpecConfig.scipy_default(1024)),
])
def test_effective_config_matches_jax(n, cfg):
    with warnings.catch_warnings(record=True) as got_w:
        warnings.simplefilter("always")
        got = tstft.effective_config(cfg, n)
    with warnings.catch_warnings(record=True) as want_w:
        warnings.simplefilter("always")
        want = jstft.effective_config(_jax(cfg), n)
    assert got.to_json() == want.to_json()
    assert [str(w.message) for w in got_w] == [str(w.message) for w in want_w]
    assert all(w.category is UserWarning for w in got_w)
    shrunk = 0 < n < cfg.nperseg and cfg.hop is None and not cfg.center
    assert len(got_w) == int(shrunk)
    if shrunk:
        assert str(got_w[0].message) == (
            f"nperseg = {cfg.nperseg} is greater than input length  = {n}, "
            f"using nperseg = {n}")


SPECTROGRAMS = [
    ("eeg_band", SpecConfig.scipy_default(256, fmin=0.0, fmax=30.0), 1000.0,
     (8192,)),
    ("band_batch", SpecConfig.north_star(512, 128, fmin=200.0, fmax=3000.0),
     16000.0, (2, 3, 8000)),
    ("fmin_only", SpecConfig.scipy_default(128, fmin=100.0), 1000.0, (4000,)),
    ("fmax_only_odd", SpecConfig.scipy_default(33, fmax=50.0), 250.0,
     (2, 1500)),
    ("no_band", SpecConfig.scipy_default(256), 1000.0, (3000,)),
    ("short_shrinks", SpecConfig.scipy_default(1024, fmax=100.0), 1000.0,
     (300,)),
    ("empty_band", SpecConfig.scipy_default(256, fmin=600.0, fmax=700.0),
     1000.0, (3000,)),
    ("two_sided_gather", SpecConfig(nperseg=64, hop=16, onesided=False,
                                    detrend="none", window="hann",
                                    fmin=-100.0, fmax=100.0), 1000.0,
     (2000,)),
    ("linear_band", SpecConfig(nperseg=96, detrend="linear", fmin=10.0,
                               fmax=300.0), 1000.0, (5000,)),
]


@pytest.mark.parametrize("name,cfg,fs,shape", SPECTROGRAMS,
                         ids=[s[0] for s in SPECTROGRAMS])
def test_spectrogram_matches_jax(name, cfg, fs, shape):
    x = np.random.RandomState(len(name)).randn(*shape).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        f, t, sxx = tstft.spectrogram(torch.from_numpy(x), fs, cfg)
        f_j, t_j, sxx_j = jstft.spectrogram(jnp.asarray(x), fs, _jax(cfg),
                                            use_matmul=True)
    sxx_j = np.asarray(sxx_j)
    assert isinstance(f, np.ndarray) and isinstance(t, np.ndarray)
    assert np.array_equal(f, f_j) and np.array_equal(t, t_j)
    assert torch.is_tensor(sxx) and sxx.dtype == torch.float32
    assert tuple(sxx.shape) == sxx_j.shape
    if sxx_j.size:
        scale = np.abs(sxx_j).max(axis=(-2, -1), keepdims=True)
        assert np.all(np.abs(sxx.numpy() - sxx_j) <= PSD_TOL * scale)


def test_spectrogram_refuses_the_extended_modes():
    """The complex and magnitude modes, refused until [ext-modes], are the
    JAX package's spectrogram, banded or not: the axes equal, Sxx within
    PSD_TOL of each clip's largest |Sxx|."""
    x = np.random.RandomState(8).randn(2, 4096).astype(np.float32)
    for mode in ("complex", "magnitude"):
        for band in ({}, {"fmin": 40.0, "fmax": 200.0}):
            cfg = SpecConfig(nperseg=256, mode=mode, **band)
            f, t, sxx = tstft.spectrogram(torch.from_numpy(x), 1000.0, cfg)
            f_j, t_j, sxx_j = jstft.spectrogram(jnp.asarray(x), 1000.0,
                                                _jax(cfg), use_matmul=True)
            sxx_j = np.asarray(sxx_j)
            assert np.array_equal(f, f_j) and np.array_equal(t, t_j)
            assert tuple(sxx.shape) == sxx_j.shape
            assert sxx.is_complex() == (mode == "complex")
            scale = np.abs(sxx_j).max(axis=(-2, -1), keepdims=True)
            assert np.all(np.abs(sxx.numpy() - sxx_j) <= PSD_TOL * scale)


def test_fmin_fmax_mask_before_normalization():
    """Port of tests/test_stft_golden.py:153: the row mask applies before
    normalization (PlotEngine.py:114-115,126), against scipy in float64."""
    fs = 1000.0
    t = np.arange(8192) / fs
    x = scipy.signal.chirp(t, f0=1.0, t1=t[-1], f1=200.0)
    cfg = SpecConfig.scipy_default(256, fmin=0.0, fmax=30.0)
    f, _, sxx = tstft.spectrogram(torch.from_numpy(x.astype(np.float32)), fs,
                                  cfg)
    assert f.min() >= 0.0 and f.max() <= 30.0
    f_ref, _, sxx_ref = scipy.signal.spectrogram(
        x, fs=fs, nperseg=256, scaling="density", mode="psd")
    mask = (f_ref >= 0.0) & (f_ref <= 30.0)
    ref = np.clip(sxx_ref[mask] / (sxx_ref[mask].max() + 1e-20), 0, 1)
    ours = tscale.normalize(sxx).numpy()
    assert np.max(np.abs(ours - ref)) < 1e-4


X_FM = np.random.RandomState(7).randn(2, 6000).astype(np.float32)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("cfg", [SpecConfig.scipy_default(256),
                                 SpecConfig.north_star(512, 128),
                                 SpecConfig.scipy_default(2048)],
                         ids=["scipy_256", "north_512", "scipy_2048"])
def test_fm_band_matches_jax_and_the_full_band(cfg, flip):
    """Port of tests/test_freq_major.py::test_fm_band_fold_matches_full:
    band=(lo, hi) against slicing the full freq-major result at the same
    flip sense, and against the JAX package's banded result."""
    x = torch.from_numpy(X_FM)
    full = tstft.power_spectrogram_fm(x, 1000.0, cfg, flip_freqs=flip)
    F = full.shape[-2]
    lo, hi = 3, 2 * F // 3
    got = tstft.power_spectrogram_fm(x, 1000.0, cfg, flip_freqs=flip,
                                     band=(lo, hi))
    ref = full[..., F - hi:F - lo, :] if flip else full[..., lo:hi, :]
    scale = float(ref.max())
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= 2e-7 * scale
    want = np.asarray(jstft.power_spectrogram_fm(
        jnp.asarray(X_FM), 1000.0, _jax(cfg), use_matmul=True,
        flip_freqs=flip, band=(lo, hi)))
    assert np.abs(got.numpy() - want).max() <= PSD_TOL * scale


def test_fm_band_requires_onesided():
    cfg = SpecConfig(nperseg=256, hop=64, onesided=False, detrend="none",
                     window="hann")
    with pytest.raises(ValueError, match="one-sided"):
        tstft.power_spectrogram_fm(torch.from_numpy(X_FM), 1000.0, cfg,
                                   band=(1, 5))


@pytest.mark.parametrize("nperseg", [24, 256, 1023, 8192])
def test_banded_plain_version_is_bitwise_the_full_bands_columns(nperseg):
    """The kernels' plain version (float64 dense DFT) on banded matrix
    columns gives the full band's columns bitwise: the PSD, its log10_out
    and the per-clip extrema over the band."""
    cfg = SpecConfig.scipy_default(nperseg)
    x = torch.from_numpy(np.random.RandomState(nperseg).randn(
        2, 3 * nperseg + 11).astype(np.float32))
    F = cfg.n_freqs
    full = stft_cuda.stft_psd(x, 1000.0, cfg)
    full_log = stft_cuda.stft_psd(x, 1000.0, cfg, log10_out=True)
    for band in {(0, F), (0, 1), (F - 1, F), (1, F - 1), (F // 3, F // 2)}:
        lo, hi = band
        got = stft_cuda.stft_psd(x, 1000.0, cfg, band=band)
        assert torch.equal(got, full[..., lo:hi])
        assert torch.equal(stft_cuda.stft_psd(x, 1000.0, cfg, band=band,
                                              log10_out=True),
                           full_log[..., lo:hi])
        p, pmin, pmax = stft_cuda.stft_psd(x, 1000.0, cfg, band=band,
                                           with_stats=True)
        assert torch.equal(pmin, full[..., lo:hi].amin(dim=(1, 2)))
        assert torch.equal(pmax, full[..., lo:hi].amax(dim=(1, 2)))
        psd, parts = stft_cuda.stft_psd_partials(x, 1000.0, cfg, band)
        assert torch.equal(psd, got) and parts.shape == (2, 1, 2,
                                                         got.shape[1])
        assert torch.equal(parts[1, 0], got.amax(dim=-1))
    assert stft_cuda.stft_psd(x[0], 1000.0, cfg, band=(2, 5)).shape == (
        full.shape[1], 3)


def test_kernel_band_refuses_an_empty_or_outside_band():
    cfg = SpecConfig.scipy_default(256)
    x = torch.zeros(1, 1024)
    for band in ((5, 5), (-1, 3), (100, 130), (7, 3)):
        with pytest.raises(ValueError, match="nonempty range"):
            stft_cuda.stft_psd(x, 1000.0, cfg, band=band)


def test_psd_entry_points_launch_the_kernel_off_the_cpu(monkeypatch):
    """power_spectrogram and power_spectrogram_fm (so spectrogram too)
    take the route's STFT/PSD kernel (ops.stft_cuda.stft_psd) for a tensor
    off the CPU, with the leading axes flattened into its clips and the
    band passed, and never the plain dense product: a meta tensor stands
    in for a CUDA one, and the launcher is a stand-in that records its
    call."""
    calls = []

    def kernel(x, fs, cfg, *, band=None, **kw):
        calls.append((tuple(x.shape), x.is_contiguous(), band, kw))
        T = tstft.num_frames(x.shape[-1], cfg.nperseg, cfg.hop_)
        lo, hi = band or (0, cfg.n_freqs)
        return torch.empty((x.shape[0], T, hi - lo), device=x.device)

    def no_plain(*a, **k):
        raise AssertionError("the plain dense product ran off the CPU")

    monkeypatch.setattr(stft_cuda, "stft_psd", kernel)
    monkeypatch.setattr(tstft, "dense_power", no_plain)
    cfg = SpecConfig.scipy_default(1024, fmin=0.0, fmax=30.0)
    x = torch.empty((2, 3, 20000), device="meta")
    p = tstft.power_spectrogram(x, 1000.0, cfg)
    assert p.shape == (2, 3, 22, 513) and p.device.type == "meta"
    fm = tstft.power_spectrogram_fm(x, 1000.0, cfg, flip_freqs=True,
                                    band=(0, 31))
    assert fm.shape == (2, 3, 31, 22)
    f, t, sxx = tstft.spectrogram(torch.empty(60000, device="meta"), 1000.0,
                                  cfg)
    assert sxx.shape == (31, 66) and len(f) == 31 and len(t) == 66
    assert calls == [((6, 20000), True, None, {}),
                     ((6, 20000), True, (0, 31), {}),
                     ((1, 60000), True, (0, 31), {})]
    # a CPU tensor takes the plain version and never the launcher
    monkeypatch.undo()
    monkeypatch.setattr(stft_cuda, "stft_psd", no_plain)
    p = tstft.power_spectrogram(torch.zeros(2, 4096), 1000.0,
                                SpecConfig.scipy_default(1024))
    assert p.shape == (2, 4, 513)
