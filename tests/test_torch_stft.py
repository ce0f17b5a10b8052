"""The port's STFT/PSD core and the STFT kernel's plain version, held
against the JAX package on the same inputs (spectral_tpu_torch.core.stft,
spectral_tpu_torch.ops.stft_cuda).

The JAX side runs as its own tests run it on the CPU: the Pallas kernel in
interpret mode and the dense matmul route of ``power_spectrogram``. Port
configs are the port's SpecConfig; each JAX twin is built from its JSON.

Tolerances: the PSD within 5e-6 of each clip's max (the JAX side's
float32 GEMMs over up to 1024 terms against the port's float64); the
per-clip max to rtol 1e-5. The per-clip min is the deepest bin, where
cancellation makes a float32 engine's relative error large (up to ~3e-4
measured), so it is held to the PSD's own bound and to equal the min of
the port's PSD exactly. At nperseg 2048-8192 the JAX package's own
tolerance for its Pallas kernel holds (tests/test_stft_pallas.py:120:
rtol 3e-4, atol 1e-6 of the max), and the display error against scipy in
float64 is held to the 1e-3 dB contract.
"""

import dataclasses
import os
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
from spectral_tpu_torch.core import scale as tscale  # noqa: E402
from spectral_tpu_torch.core import stft as tstft  # noqa: E402
from spectral_tpu_torch.ops import stft_cuda  # noqa: E402
import torch_precision  # noqa: E402

FS = 16000.0
PSD_TOL = 5e-6
CONFIGS = {
    "north_star_256_64": SpecConfig.north_star(256, 64),
    "north_star_1024_256": SpecConfig.north_star(1024, 256),
    "scipy_256": SpecConfig.scipy_default(256),
    "scipy_1024": SpecConfig.scipy_default(1024),
}


def _jax(cfg):
    """The JAX package's twin of a port config."""
    return jconfig.SpecConfig.from_json(cfg.to_json())


def stft_psd_pallas(x, fs, cfg, **kw):
    return stft_pallas.stft_psd_pallas(x, fs, _jax(cfg), **kw)


def _clips(seed, n_clips=2, n=16000, offset=0.0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n_clips, n) + offset).astype(np.float32)


def _jax_constants(cfg):
    a_re, a_im = jstft.dft_matrices(_jax(cfg))
    return stft_cuda.constants_from_numpy(
        a_re, a_im, jstft.onesided_weights(_jax(cfg), FS), "cpu",
        torch.float64)


def _float32_constants(cfg):
    """The kernel's operands rounded to float32, as an fp32 chain takes
    them."""
    a_re, a_im = tstft.dft_matrices(cfg)
    return stft_cuda.constants_from_numpy(
        a_re, a_im, tstft.onesided_weights(cfg, FS), "cpu", torch.float32)


def _assert_psd_close(got, want):
    scale = want.max(axis=(-2, -1))
    err = np.abs(got - want).max(axis=(-2, -1))
    assert np.all(err <= PSD_TOL * scale), err / scale


@pytest.mark.parametrize("name", CONFIGS)
def test_host_constants_bitwise_equal(name):
    cfg = CONFIGS[name]
    jcfg = _jax(cfg)
    for a, b in zip(jstft.dft_matrices(jcfg), tstft.dft_matrices(cfg)):
        assert np.array_equal(a, b)
    assert np.array_equal(jstft.onesided_weights(jcfg, FS),
                          tstft.onesided_weights(cfg, FS))
    assert jstft.psd_scale(jcfg, FS) == tstft.psd_scale(cfg, FS)
    assert np.array_equal(jstft.freq_axis(jcfg, FS),
                          tstft.freq_axis(cfg, FS))
    for n in (0, 100, 16000, 16001):
        assert np.array_equal(jstft.time_axis(jcfg, FS, n),
                              tstft.time_axis(cfg, FS, n))
        assert (jstft.num_frames(n, cfg.nperseg, cfg.hop_)
                == tstft.num_frames(n, cfg.nperseg, cfg.hop_))
    # the operands built from the JAX package's constants are the port's
    for a, b in zip(_jax_constants(cfg), stft_cuda.dft_constants(cfg, FS,
                                                                 "cpu")):
        assert a.dtype == torch.float64
        assert torch.equal(a, b)


def test_constants_are_copies_not_views():
    cfg = CONFIGS["north_star_256_64"]
    a_re, a_im = tstft.dft_matrices(cfg)
    consts = stft_cuda.constants_from_numpy(a_re, a_im,
                                            tstft.onesided_weights(cfg, FS),
                                            "cpu", torch.float64)
    consts.a_re.zero_()
    assert np.any(tstft.dft_matrices(cfg)[0] != 0)


@pytest.mark.parametrize("nperseg,hop", [(256, 64), (1024, 896), (256, 255),
                                         (64, 100)])
def test_frame_signal_matches_jax(nperseg, hop):
    x = _clips(1, n=5000)
    want = np.asarray(jstft.frame_signal(jnp.asarray(x), nperseg, hop))
    got = tstft.frame_signal(torch.from_numpy(x), nperseg, hop)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_pallas_kernel(name):
    cfg = CONFIGS[name]
    x = _clips(2, offset=0.0 if cfg.detrend == "none" else 1.0)
    psd_j, lo_j, hi_j = (np.asarray(a) for a in jax.jit(
        lambda v: stft_psd_pallas(v, FS, cfg, with_stats=True))(
            jnp.asarray(x)))
    psd, lo, hi = (a.numpy() for a in stft_cuda.stft_psd_reference(
        torch.from_numpy(x), _jax_constants(cfg), cfg, with_stats=True))
    assert psd.shape == psd_j.shape
    _assert_psd_close(psd, psd_j)
    np.testing.assert_allclose(hi, hi_j, rtol=1e-5)
    assert np.all(np.abs(lo - lo_j) <= PSD_TOL * hi_j)
    assert np.array_equal(lo, psd.min(axis=(1, 2)))
    assert np.array_equal(hi, psd.max(axis=(1, 2)))


def test_log10_out_matches_pallas_kernel():
    cfg = CONFIGS["north_star_256_64"]
    x = _clips(3)
    want = np.asarray(jax.jit(lambda v: stft_psd_pallas(
        v, FS, cfg, log10_out=True))(jnp.asarray(x)))
    got = stft_cuda.stft_psd(torch.from_numpy(x), FS, cfg, log10_out=True)
    # log10 turns the PSD's absolute error at the deepest bins into large
    # log-domain steps (2.8e-5 measured at 1e-5 of the max), so compare in
    # linear units under the PSD's bound, and the log itself exactly: the
    # log10 of the float64 PSD, rounded once
    _assert_psd_close(10.0 ** got.double().numpy(),
                      10.0 ** want.astype(np.float64))
    psd64 = stft_cuda.stft_psd(torch.from_numpy(x).double(), FS, cfg)
    assert psd64.dtype == torch.float64
    assert torch.equal(got, torch.log10(psd64 + 1e-20).float())
    with pytest.raises(ValueError, match="with_stats"):
        stft_cuda.stft_psd(torch.from_numpy(x), FS, cfg, log10_out=True,
                           with_stats=True)


@pytest.mark.parametrize("name", ["north_star_1024_256", "scipy_256"])
def test_power_spectrogram_matches_jax_dense_route(name):
    cfg = CONFIGS[name]
    x = _clips(4, offset=1.0)
    want = np.asarray(jstft.power_spectrogram(jnp.asarray(x), FS, _jax(cfg),
                                              use_matmul=True))
    got = tstft.power_spectrogram(torch.from_numpy(x), FS, cfg).numpy()
    _assert_psd_close(got, want)
    for flip in (False, True):
        want_fm = np.asarray(jstft.power_spectrogram_fm(
            jnp.asarray(x), FS, _jax(cfg), use_matmul=True, flip_freqs=flip))
        got_fm = tstft.power_spectrogram_fm(torch.from_numpy(x), FS, cfg,
                                            flip_freqs=flip).numpy()
        _assert_psd_close(got_fm, want_fm)


def test_wrapper_on_cpu_is_the_plain_version():
    cfg = CONFIGS["north_star_256_64"]
    x = torch.from_numpy(_clips(5))
    got = stft_cuda.stft_psd(x, FS, cfg, with_stats=True)
    want = stft_cuda.stft_psd_reference(
        x, stft_cuda.dft_constants(cfg, FS, "cpu"), cfg, with_stats=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    one = stft_cuda.stft_psd(x[0], FS, cfg, with_stats=True)
    assert one[0].shape == got[0].shape[1:] and one[1].shape == ()
    assert torch.equal(one[0], got[0][0])


def test_zero_frames_like_jax():
    cfg = CONFIGS["north_star_1024_256"]
    psd_j, lo_j, hi_j = stft_psd_pallas(jnp.zeros((3, 100)), FS, cfg,
                                        with_stats=True)
    psd, lo, hi = stft_cuda.stft_psd(torch.zeros(3, 100), FS, cfg,
                                     with_stats=True)
    assert tuple(psd.shape) == psd_j.shape == (3, 0, 513)
    assert np.array_equal(lo.numpy(), np.asarray(lo_j))
    assert np.array_equal(hi.numpy(), np.asarray(hi_j))
    assert tuple(stft_cuda.stft_psd(torch.zeros(100), FS, cfg).shape) == \
        stft_psd_pallas(jnp.zeros(100), FS, cfg).shape
    assert tuple(tstft.power_spectrogram(torch.zeros(2, 100), FS,
                                         cfg).shape) == \
        jstft.power_spectrogram(jnp.zeros((2, 100)), FS, _jax(cfg),
                                use_matmul=True).shape


@pytest.mark.parametrize("dtype", [np.int16, np.float16, np.bool_])
def test_narrow_inputs_promote_like_jax(dtype):
    cfg = CONFIGS["north_star_256_64"]
    x = (np.random.RandomState(6).randn(2, 4096) * 300).astype(dtype)
    jx = jstft.ensure_real_waveform(jnp.asarray(x))
    tx = tstft.ensure_real_waveform(torch.from_numpy(x))
    assert str(jx.dtype) == "float32" and tx.dtype == torch.float32
    assert np.array_equal(np.asarray(jx), tx.numpy())
    want = np.asarray(stft_psd_pallas(jnp.asarray(x), FS, cfg))
    got = stft_cuda.stft_psd(torch.from_numpy(x), FS, cfg).numpy()
    _assert_psd_close(got, want)


def test_complex_and_scalar_inputs_refused_like_jax():
    cfg = CONFIGS["north_star_256_64"]
    for bad in (np.ones(4096, np.complex64), np.float32(1.0)):
        with pytest.raises(ValueError):
            jstft.ensure_real_waveform(jnp.asarray(bad))
        with pytest.raises(ValueError):
            tstft.ensure_real_waveform(torch.as_tensor(bad))
        with pytest.raises(ValueError):
            stft_cuda.stft_psd(torch.as_tensor(bad), FS, cfg)
    assert tstft.ensure_real_waveform([0.5, 1, 2]).dtype == torch.float32


def test_kernel_supported_keeps_the_semantic_conditions():
    ok = [SpecConfig.north_star(1024, 256), SpecConfig.scipy_default(1024),
          SpecConfig.scipy_default(64), SpecConfig.north_star(256, 64,
                                                              window="hann"),
          SpecConfig.scipy_default(2048), SpecConfig.north_star(8192, 2048),
          SpecConfig.scipy_default(8192), SpecConfig.north_star(8192, 24),
          SpecConfig(nperseg=256, nfft=512)]
    assert all(stft_cuda.kernel_supported(c) for c in ok)
    # the TPU's layout limits (gcd >= 8, the VMEM frame budget) are not
    # the port's: 8192/24 is refused by pallas_supported only
    assert not stft_pallas.pallas_supported(_jax(ok[-2]))
    # nfft > nperseg: the JAX package computes it off its kernel, on its
    # dense matmul route; the port's GEMM kernel takes it
    assert not stft_pallas.pallas_supported(_jax(ok[-1]))
    # the extended modes, refused by pallas_supported, are the port's:
    # the magnitude and centered configs run, and match the JAX package
    # (tests/test_torch_ext_modes.py holds them across entry points)
    x = torch.zeros(1, 4096)
    xr = torch.from_numpy(_clips(5, n_clips=1, n=4096))
    for cfg in (SpecConfig(nperseg=256, mode="magnitude"),
                SpecConfig(nperseg=256, center=True)):
        assert stft_cuda.kernel_supported(cfg)
        assert not stft_pallas.pallas_supported(_jax(cfg))
        got = stft_cuda.stft_psd(xr, FS, cfg).numpy()
        want = np.asarray(jstft.power_spectrogram(
            jnp.asarray(xr.numpy()), FS, _jax(cfg), use_matmul=False))
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()
    # a transform past 8192, computed off the JAX package's Pallas kernel
    # (its VMEM stops there), is the port's to 32,768: the JAX package's
    # rFFT route; past it refused
    big = SpecConfig.scipy_default(16384)
    assert stft_cuda.kernel_supported(big)
    assert not stft_pallas.pallas_supported(_jax(big))
    xb = torch.from_numpy(_clips(6, n_clips=1, n=40000))
    got = stft_cuda.stft_psd(xb, FS, big).numpy()
    want = np.asarray(jstft.power_spectrogram(
        jnp.asarray(xb.numpy()), FS, _jax(big), use_matmul=False))
    assert got.shape == want.shape == (1, 2, 8193)
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()
    past = SpecConfig.scipy_default(65536)
    assert not stft_cuda.kernel_supported(past)
    with pytest.raises(NotImplementedError, match=r"\[large-nperseg\]"):
        stft_cuda.stft_psd(x, FS, past)
    # the mel branch and the band mask are not the kernel's concern: the
    # caller passes the band's bins, and projects the PSD onto mel rows
    for cfg in (SpecConfig(nperseg=256, n_mels=32),
                SpecConfig.scipy_default(256, fmin=0.0, fmax=30.0)):
        assert stft_cuda.kernel_supported(cfg)
        plain = dataclasses.replace(cfg, n_mels=None, fmin=None, fmax=None)
        assert torch.equal(stft_cuda.stft_psd(x, FS, cfg),
                           stft_cuda.stft_psd(x, FS, plain))
    centered = SpecConfig(nperseg=256, center=True)
    got = tstft.power_spectrogram(xr, FS, centered).numpy()
    want = np.asarray(jstft.power_spectrogram(
        jnp.asarray(xr.numpy()), FS, _jax(centered), use_matmul=True))
    assert got.shape == want.shape == (
        1, tstft.num_frames(4096 + 256, 256, centered.hop_), 129)
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# nperseg 2048-8192: the JAX package's frequency-tiled auto kernel (K1) and,
# above 6144 on its chip, the manual-DMA kernel (K2); in interpret mode both
# run the auto kernel's arithmetic
# ---------------------------------------------------------------------------

LARGE = {
    "north_star_2048_512": SpecConfig.north_star(2048, 512),
    "scipy_4096": SpecConfig.scipy_default(4096),
    "north_star_8192_2048": SpecConfig.north_star(8192, 2048),
    "scipy_8192": SpecConfig.scipy_default(8192),
}


@pytest.fixture(scope="module")
def drop_large_constants():
    """The 8192 matrices are 537 MB a config in float64: share them across
    this module's tests, then free them."""
    yield
    stft_cuda._CONSTANTS.clear()
    tstft.dft_matrices.cache_clear()
    jstft.dft_matrices.cache_clear()


def _db_error(psd_tf, x64, cfg):
    """bench.py's display error: max |Δimage| x the dB range, the port's
    log display of a (F, T) PSD against scipy.signal.spectrogram in
    float64 on the same clip."""
    oracle, rng_db = torch_precision.scipy_display(x64, cfg, FS)
    img = tscale.normalize(torch.as_tensor(psd_tf), log_scale=True).numpy()
    assert img.shape == oracle.shape
    return float(np.max(np.abs(img - oracle)) * rng_db)


@pytest.mark.parametrize("name", LARGE)
def test_large_nperseg_matches_pallas_kernel(name, drop_large_constants):
    cfg = LARGE[name]
    x = _clips(8, n_clips=1, n=6 * cfg.nperseg, offset=3.0)
    psd_j, lo_j, hi_j = (np.asarray(a) for a in jax.jit(
        lambda v: stft_psd_pallas(v, FS, cfg, with_stats=True))(
            jnp.asarray(x)))
    psd, lo, hi = (a.numpy() for a in stft_cuda.stft_psd(
        torch.from_numpy(x), FS, cfg, with_stats=True))
    assert psd.shape == psd_j.shape and psd.shape[1] >= 3
    np.testing.assert_allclose(psd, psd_j, rtol=3e-4,
                               atol=float(psd_j.max()) * 1e-6)
    np.testing.assert_allclose(hi, hi_j, rtol=1e-5)
    assert np.all(np.abs(lo - lo_j) <= 1e-6 * hi_j)


def test_scipy_8192_within_the_display_contract(drop_large_constants):
    cfg = LARGE["scipy_8192"]
    x = _clips(9, n_clips=1, n=8 * cfg.nperseg, offset=3.0)
    psd = stft_cuda.stft_psd(torch.from_numpy(x[0]), FS, cfg)
    assert psd.dtype == torch.float32
    err = _db_error(psd.T, x[0].astype(np.float64), cfg)
    assert err <= 1e-3, err


def test_precision_routing():
    """Every config accumulates in float64, with or without detrend (a
    float32 chain breaks 1e-3 dB at every nperseg): the plain version is
    float64 matmuls rounded once to float32, and float32 constants are
    refused."""
    x = torch.from_numpy(_clips(10, offset=3.0))
    for cfg in (SpecConfig.north_star(1024, 256), SpecConfig.north_star(256, 64),
                SpecConfig(nperseg=512, hop=128, detrend="none"),
                SpecConfig.scipy_default(256),
                SpecConfig(nperseg=1024, hop=256, detrend="linear")):
        consts = stft_cuda.dft_constants(cfg, FS, "cpu")
        assert consts.a_re.dtype == torch.float64
        want = tstft.dense_power(
            tstft.frame_signal(x.double(), cfg.nperseg, cfg.hop_),
            *consts).float()
        assert torch.equal(stft_cuda.stft_psd(x, FS, cfg), want)
    cfg = SpecConfig.scipy_default(256)
    with pytest.raises(ValueError, match="float64"):
        stft_cuda.stft_psd_reference(x, _float32_constants(cfg), cfg)


def test_f64_routing_holds_the_contract_where_fp32_breaks_it(
        drop_large_constants):
    """scipy_default 8192 on white noise + 3 (the detrend fold cancels the
    offset inside the sum): the float32 route's arithmetic, emulated in
    numpy, breaks 1e-3 dB; the f64 route the wrapper takes holds it."""
    cfg = LARGE["scipy_8192"]
    x = _clips(11, n_clips=1, n=8 * cfg.nperseg, offset=3.0)[0]
    x64 = x.astype(np.float64)
    a_re, a_im = tstft.dft_matrices(cfg)
    fp32 = torch_precision.psd_fp32_chain(
        torch_precision.frames_of(x, cfg), a_re, a_im,
        tstft.onesided_weights(cfg, FS))
    assert _db_error(fp32.T, x64, cfg) > 1e-3
    routed = stft_cuda.stft_psd(torch.from_numpy(x), FS, cfg)
    assert _db_error(routed.T, x64, cfg) <= 1e-5


def test_headline_config_needs_f64_too(drop_large_constants):
    """north_star 1024/256, no detrend, on a white-noise clip (seed 7 of
    the precision sweep): one float32 chain, emulated in numpy, breaks
    1e-3 dB at its deepest bin; the float64 route the wrapper takes holds
    it."""
    cfg = CONFIGS["north_star_1024_256"]
    x = np.random.RandomState(7).randn(8 * cfg.nperseg).astype(np.float32)
    x64 = x.astype(np.float64)
    a_re, a_im = tstft.dft_matrices(cfg)
    fp32 = torch_precision.psd_fp32_chain(
        torch_precision.frames_of(x, cfg), a_re, a_im,
        tstft.onesided_weights(cfg, FS))
    assert _db_error(fp32.T, x64, cfg) > 1e-3
    routed = stft_cuda.stft_psd(torch.from_numpy(x), FS, cfg)
    assert _db_error(routed.T, x64, cfg) <= 1e-5


@pytest.mark.parametrize("name", ["north_star_256_64", "scipy_256"])
def test_emulation_models_the_plain_routes(name):
    """The numpy emulation behind the precision rule computes the same
    PSD as the plain versions: its float64 model as the route the wrapper
    takes, to within one float32 rounding (both sum in float64 and round
    once); its float32 chain as a float32 matmul of the float32 matrices,
    within the float32 PSD bound (torch's CPU matmul sums in another
    order)."""
    cfg = CONFIGS[name]
    x = _clips(12, n_clips=1, offset=3.0)[0]
    a_re, a_im = tstft.dft_matrices(cfg)
    wts = tstft.onesided_weights(cfg, FS)
    frames = torch_precision.frames_of(x, cfg)
    plain = stft_cuda.stft_psd(torch.from_numpy(x), FS, cfg).numpy()
    model = torch_precision.psd_f64(frames, a_re, a_im, wts)
    np.testing.assert_allclose(plain, model, rtol=1.2e-7,
                               atol=float(model.max()) * 1e-12)
    consts32 = _float32_constants(cfg)
    plain32 = tstft.dense_power(torch.from_numpy(frames), *consts32).numpy()
    chain = torch_precision.psd_fp32_chain(frames, a_re, a_im, wts)
    _assert_psd_close(plain32[None], chain[None])
