"""Zero-padded transforms (nfft > nperseg, scipy's nfft, the CLI's --nfft)
on the port: the route of nfft takes every such config (an FFT family
from nfft 32 to 32,768, whose kernels load the frame's nperseg samples and
zero the rest; the GEMM route below 32 and past 32,768, its small-K tile
where the padded bins still fit it and the 128 x 64 tile past them), and
each entry point that reaches the kernel (the PSD, the session, the
pipeline, the mel branch, the band) gives what the JAX package gives on
the CPU, where it computes nfft > nperseg off its Pallas kernel on its
dense matmul route (spectral_tpu/ops/stft_pallas.py:206).

Tolerances: the PSD within PSD_REL = 2e-5 of each clip's max against
scipy float64 and the JAX package (the PSD contract); the small-K tile's
transcription within 1e-6 of the plain version (tests/test_torch_gemm_tile
.py's TOL); displays within tests/test_torch_pipeline.py's and
tests/test_torch_session.py's tolerances; a banded PSD bitwise the full
band's columns.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import scipy.signal

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spectral_tpu import config as jconfig  # noqa: E402
from spectral_tpu.core import stft as jstft  # noqa: E402
from spectral_tpu_torch import SpecConfig, ViewSettings  # noqa: E402
from spectral_tpu_torch.ops import stft_cuda  # noqa: E402
from test_torch_gemm_tile import (MAX_F, SmallTile, _close,  # noqa: E402
                                  _tile_and_plain)
from test_torch_pipeline import (_assert_same_display,  # noqa: E402
                                 batched_spectrogram_fn, jax_pipeline)
from test_torch_session import Pair, _same_plot  # noqa: E402

FS = 16000.0
PSD_REL = 2e-5

# one config on each route of nfft: radix-2 (1024, 2048, 64 from nperseg
# 24), mixed (1536), odd (2047), Bluestein (2049), the GEMM kernel (20)
PADDED = [dataclasses.replace(SpecConfig.scipy_default(256), nfft=1024),
          SpecConfig.north_star(512, 128, nfft=2048),
          SpecConfig(nperseg=24, hop=21, nfft=64),
          SpecConfig(nperseg=7, hop=3, nfft=20, detrend="linear"),
          SpecConfig(nperseg=1000, hop=250, nfft=1536, detrend="linear"),
          dataclasses.replace(SpecConfig.scipy_default(1024), nfft=2047),
          SpecConfig(nperseg=2000, hop=500, nfft=2049, window="hann")]


def _j(cfg):
    return jconfig.SpecConfig.from_json(cfg.to_json())


def takes_small_tile(F, K):
    """stft_psd_launch's choice, the text test_small_tile_geometry_is_the_
    sources pins in the CUDA source: the small-K tile at F <= SK_MAX_F
    with K below 2 SK_MAX_F, else the 128 x 64 tile."""
    return F <= MAX_F and K < 2 * MAX_F


def test_route_takes_gemm_for_every_padded_config():
    """nfft > nperseg routes by nfft: the GEMM kernel below nfft 32 and
    past 32,768, and from 32 to 32,768 the FFT family of nfft's
    factorization, whatever nperseg is (the route of the unpadded config
    of nperseg nfft: past 8192 the radix-2 or the Bluestein kernel); a
    forced Bluestein route takes a padded config from nfft 32, a forced
    GEMM one any up to nperseg 8192; centered and magnitude padded configs
    run; nperseg past 8192 with nfft past 32,768 names [large-nperseg]."""
    for k in list(range(2, 32)) + list(range(32, 8193, 331)) + [8191, 8192]:
        for nfft in (k + 1, 2 * k, 4 * k, 8 * k):
            cfg = SpecConfig(nperseg=k, hop=max(1, k // 4), nfft=nfft)
            want = ("gemm" if not 32 <= nfft <= 32768 else stft_cuda.route(
                SpecConfig(nperseg=nfft, hop=max(1, nfft // 4))))
            assert stft_cuda.route(cfg) == want, (k, nfft)
            assert want != "gemm" or nfft < 32 or nfft > 32768
    assert stft_cuda.route(SpecConfig(nperseg=1024, nfft=1024)) == "fft"
    assert stft_cuda.route(SpecConfig(nperseg=1000, nfft=1536)) == "mixed"
    assert stft_cuda.route(SpecConfig(nperseg=1024, nfft=2047)) == "odd"
    assert stft_cuda.route(SpecConfig(nperseg=2000, nfft=2049)) == \
        "bluestein"
    assert stft_cuda.route(SpecConfig.scipy_default(8160)) == "mixed"
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 4096).astype(
        np.float32))
    padded = SpecConfig(nperseg=256, nfft=512)
    want = stft_cuda.stft_psd(x, FS, padded)
    for forced in ("bluestein", "gemm"):
        got = stft_cuda.stft_psd(x, FS, padded, _route=forced)
        assert torch.equal(got, want) and got.shape == (1, 18, 257)
    with pytest.raises(ValueError, match="no 'mixed' route"):
        stft_cuda.stft_psd(x, FS, padded, _route="mixed")
    for cfg in (SpecConfig(nperseg=256, nfft=512, center=True),
                SpecConfig(nperseg=256, nfft=512, mode="magnitude")):
        assert stft_cuda.kernel_supported(cfg)
        assert stft_cuda.route(cfg) == "fft"
    assert stft_cuda.route(SpecConfig(nperseg=16384, nfft=32768)) == "fft"
    assert stft_cuda.route(SpecConfig(nperseg=1024, nfft=65536)) == "gemm"
    bad = SpecConfig(nperseg=16384, nfft=65536)
    assert not stft_cuda.kernel_supported(bad)
    with pytest.raises(NotImplementedError, match=r"\[large-nperseg\]"):
        stft_cuda.route(bad)


@pytest.mark.parametrize("cfg", PADDED, ids=lambda c: f"{c.nperseg}-"
                         f"{c.nfft_}")
def test_padded_psd_matches_jax_and_scipy(cfg):
    x = (np.random.RandomState(cfg.nfft_).randn(2, 6000) + 1.5).astype(
        np.float32)
    got = stft_cuda.stft_psd(torch.from_numpy(x), FS, cfg).numpy()
    assert got.shape[-1] == cfg.nfft_ // 2 + 1
    want = np.asarray(jstft.power_spectrogram(jnp.asarray(x), FS, _j(cfg),
                                              use_matmul=True))
    for b in range(2):
        _f, _t, ref = scipy.signal.spectrogram(
            x[b].astype(np.float64), fs=FS, window=cfg.window,
            nperseg=cfg.nperseg, noverlap=cfg.nperseg - cfg.hop_,
            nfft=cfg.nfft_, scaling="density",
            detrend=False if cfg.detrend == "none" else cfg.detrend,
            mode="psd")
        scale = ref.max()
        assert np.abs(got[b].T - ref).max() <= PSD_REL * scale
        assert np.abs(want[b].T - ref).max() <= PSD_REL * scale


@pytest.mark.parametrize("k, nfft", [(4, 30), (5, 16), (8, 24), (12, 30),
                                     (13, 16)])
def test_small_tile_takes_padded_configs_within_its_bins(k, nfft):
    """Below nperseg 32 a padded config whose nfft // 2 + 1 bins fit the
    small-K tile (at most SK_MAX_F) takes it: its (K, F) matrices carry
    the padding, so the transcription of the tile is held to the plain
    version with F past K/2 + 1."""
    cfg = SpecConfig(nperseg=k, hop=max(1, k // 3), nfft=nfft)
    assert takes_small_tile(cfg.n_freqs, k) and cfg.n_freqs > k // 2 + 1
    x = (np.random.RandomState(k).randn(5, 40 * k) + 1.0).astype(np.float32)
    (tile, out, lo, hi), want = _tile_and_plain(cfg, x)
    assert isinstance(tile, SmallTile) and out.shape == want.shape
    _close(out, want)
    rows = want.reshape(-1, cfg.n_freqs)
    assert np.array_equal(lo.ravel(), rows.min(axis=1))
    assert np.array_equal(hi.ravel(), rows.max(axis=1))


def test_large_tile_takes_padded_configs_past_its_bins():
    """A small nperseg with a large nfft has more bins than the small-K
    tile holds: the GEMM kernel, forced (these configs route to the FFT
    family of nfft: past 8192 the Bluestein kernel) or past nfft 32,768,
    must take the 128 x 64 tile, whose bins come in frequency tiles of 64
    (stft_psd_freq_tiles)."""
    for k, nfft in ((2, 64), (8, 64), (24, 64), (31, 32), (24, 4096),
                    (1024, 4096), (24, 9000), (24, 40000)):
        cfg = SpecConfig(nperseg=k, hop=max(1, k // 4), nfft=nfft)
        assert stft_cuda.route(cfg) == ("gemm" if nfft > 32768 else "fft"
                                        if nfft & (nfft - 1) == 0
                                        else "bluestein" if nfft > 8192
                                        else "mixed")
        assert cfg.n_freqs > MAX_F and not takes_small_tile(cfg.n_freqs, k)
    # one-sided configs at nfft == nperseg below 32 all fit the small tile
    assert all(takes_small_tile(SpecConfig.scipy_default(k).n_freqs, k)
               for k in range(2, 32))
    assert -(-SpecConfig(nperseg=1024, nfft=4096).n_freqs // 64) == 33


def test_band_of_a_padded_config_is_the_full_bands_columns():
    cfg = SpecConfig(nperseg=200, hop=50, nfft=1000)
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 5000).astype(
        np.float32))
    full = stft_cuda.stft_psd(x, FS, cfg)
    for lo, hi in ((0, 1), (7, 300), (480, 501)):
        assert torch.equal(stft_cuda.stft_psd(x, FS, cfg, band=(lo, hi)),
                           full[..., lo:hi])


@pytest.mark.parametrize("extra", [{}, {"n_mels": 40},
                                   {"fmin": 300.0, "fmax": 3000.0}],
                         ids=["full", "mel", "band"])
def test_pipeline_with_nfft_matches_jax(extra):
    """batched_spectrogram_fn at nfft 1024 over nperseg 256 against the
    JAX pipeline (its float32 dense route) on zero-mean noise, and the
    port's log display against scipy float64 within 1e-3 dB on noise + 3,
    where a DC line 40 dB over the floor widens the JAX route's float32
    error past its own 5e-3 dB budget (8e-3 to 1.2e-2 dB on seeds 3-5),
    while the port's float64 sums hold the contract."""
    cfg = SpecConfig.north_star(256, 64, nfft=1024, log_scale=True, **extra)
    x = np.random.RandomState(3).randn(2, 8000).astype(np.float32)
    port = batched_spectrogram_fn(FS, cfg, flip_image=True)(
        torch.from_numpy(x))
    ref = jax.jit(jax_pipeline(FS, cfg, flip_image=True))(jnp.asarray(x))
    if extra:
        from test_torch_pipeline import _assert_same_shown
        _assert_same_shown(port, ref, True)
        return
    _assert_same_display(port, ref)
    from torch_precision import scipy_display
    y = x + 3.0
    img = batched_spectrogram_fn(FS, cfg)(torch.from_numpy(y))["image"]
    for b in range(2):
        oracle, rng_db = scipy_display(y[b].astype(np.float64), cfg, FS)
        assert np.abs(img[b].numpy() - oracle).max() * rng_db <= 1e-3


@pytest.mark.parametrize("log_scale", [False, True])
def test_session_plot_with_nfft_matches_jax(log_scale):
    """The session's plot (the CLI's render --nfft) on the port and the
    JAX package: the axes exactly, sxx and image within
    tests/test_torch_session.py's tolerances."""
    p = Pair()
    rs = np.random.RandomState(9)
    fs = 1000.0
    t = np.arange(int(30 * fs)) / fs
    x = (0.05 * rs.randn(t.size) + np.sin(2 * np.pi * 6 * t)
         * ((t > 8) & (t < 14))).astype(np.float32)
    p.register("rec_sweep0", "rec.wav", 0, fs, fs, x, None)
    cfg = dataclasses.replace(SpecConfig.scipy_default(
        256, fmin=0.0, fmax=60.0, log_scale=log_scale), nfft=1024)
    rt, rj = p.plot(["rec_sweep0"], cfg, ViewSettings())
    _same_plot(rt, rj, log_scale)
    assert rt.f[1] - rt.f[0] == fs / 1024
