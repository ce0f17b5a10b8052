"""The port's STFT/PSD core and the STFT kernel's plain version, held
against the JAX package on the same inputs (spectral_tpu_torch.core.stft,
spectral_tpu_torch.ops.stft_cuda).

The JAX side runs as its own tests run it on the CPU: the Pallas kernel in
interpret mode and the dense matmul route of ``power_spectrogram``.

Tolerances: the PSD within 5e-6 of each clip's max (float32 GEMMs over up
to 1024 terms, summed in another order by XLA and by torch); the per-clip
max to rtol 1e-5. The per-clip min is the deepest bin, where cancellation
makes any float32 engine's relative error large (up to ~3e-4 measured
between these two), so it is held to the PSD's own bound and to equal the
min of the port's PSD exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spectral_tpu.config import SpecConfig  # noqa: E402
from spectral_tpu.core import stft as jstft  # noqa: E402
from spectral_tpu.ops.stft_pallas import stft_psd_pallas  # noqa: E402
from spectral_tpu_torch.core import stft as tstft  # noqa: E402
from spectral_tpu_torch.ops import stft_cuda  # noqa: E402

FS = 16000.0
PSD_TOL = 5e-6
CONFIGS = {
    "north_star_256_64": SpecConfig.north_star(256, 64),
    "north_star_1024_256": SpecConfig.north_star(1024, 256),
    "scipy_256": SpecConfig.scipy_default(256),
    "scipy_1024": SpecConfig.scipy_default(1024),
}


def _clips(seed, n_clips=2, n=16000, offset=0.0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n_clips, n) + offset).astype(np.float32)


def _jax_constants(cfg):
    a_re, a_im = jstft.dft_matrices(cfg)
    return stft_cuda.constants_from_numpy(
        a_re, a_im, jstft.onesided_weights(cfg, FS), "cpu")


def _assert_psd_close(got, want):
    scale = want.max(axis=(-2, -1))
    err = np.abs(got - want).max(axis=(-2, -1))
    assert np.all(err <= PSD_TOL * scale), err / scale


@pytest.mark.parametrize("name", CONFIGS)
def test_host_constants_bitwise_equal(name):
    cfg = CONFIGS[name]
    for a, b in zip(jstft.dft_matrices(cfg), tstft.dft_matrices(cfg)):
        assert np.array_equal(a, b)
    assert np.array_equal(jstft.onesided_weights(cfg, FS),
                          tstft.onesided_weights(cfg, FS))
    assert jstft.psd_scale(cfg, FS) == tstft.psd_scale(cfg, FS)
    assert np.array_equal(jstft.freq_axis(cfg, FS), tstft.freq_axis(cfg, FS))
    for n in (0, 100, 16000, 16001):
        assert np.array_equal(jstft.time_axis(cfg, FS, n),
                              tstft.time_axis(cfg, FS, n))
        assert (jstft.num_frames(n, cfg.nperseg, cfg.hop_)
                == tstft.num_frames(n, cfg.nperseg, cfg.hop_))
    # the operands built from the JAX package's constants are the port's
    for a, b in zip(_jax_constants(cfg), stft_cuda.dft_constants(cfg, FS,
                                                                 "cpu")):
        assert a.dtype == torch.float32 and torch.equal(a, b)


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
    # linear units under the PSD's bound, and the log itself exactly
    _assert_psd_close(10.0 ** got.double().numpy(),
                      10.0 ** want.astype(np.float64))
    psd = stft_cuda.stft_psd(torch.from_numpy(x), FS, cfg)
    assert torch.equal(got, torch.log10(psd + 1e-20))
    with pytest.raises(ValueError, match="with_stats"):
        stft_cuda.stft_psd(torch.from_numpy(x), FS, cfg, log10_out=True,
                           with_stats=True)


@pytest.mark.parametrize("name", ["north_star_1024_256", "scipy_256"])
def test_power_spectrogram_matches_jax_dense_route(name):
    cfg = CONFIGS[name]
    x = _clips(4, offset=1.0)
    want = np.asarray(jstft.power_spectrogram(jnp.asarray(x), FS, cfg,
                                              use_matmul=True))
    got = tstft.power_spectrogram(torch.from_numpy(x), FS, cfg).numpy()
    _assert_psd_close(got, want)
    for flip in (False, True):
        want_fm = np.asarray(jstft.power_spectrogram_fm(
            jnp.asarray(x), FS, cfg, use_matmul=True, flip_freqs=flip))
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
        jstft.power_spectrogram(jnp.zeros((2, 100)), FS, cfg,
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
                                                              window="hann")]
    assert all(stft_cuda.kernel_supported(c) for c in ok)
    refused = {
        "item 8": [SpecConfig(nperseg=256, nfft=512),
                   SpecConfig(nperseg=256, mode="magnitude"),
                   SpecConfig(nperseg=256, center=True),
                   SpecConfig.scipy_default(2048)],
        "item 5": [SpecConfig(nperseg=256, n_mels=32),
                   SpecConfig.scipy_default(256, fmin=0.0, fmax=30.0)],
    }
    x = torch.zeros(1, 4096)
    for item, cfgs in refused.items():
        for cfg in cfgs:
            assert not stft_cuda.kernel_supported(cfg)
            with pytest.raises(NotImplementedError, match=item):
                stft_cuda.stft_psd(x, FS, cfg)
    with pytest.raises(NotImplementedError, match="item 8"):
        tstft.power_spectrogram(x, FS, SpecConfig(nperseg=256, center=True))
