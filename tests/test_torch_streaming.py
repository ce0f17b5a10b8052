"""The port's streaming STFT (spectral_tpu_torch.parallel.streaming,
device='cpu': the kernel's plain version) held against the JAX package's
(spectral_tpu.parallel.streaming, run as tests/test_parallel.py runs it),
against scipy in float64 and against the port's own monolithic
computation, on seeded numpy signals of seconds at 1-48 kHz.

Tolerances:
- PSD: within PSD_REL of the reference's max, against scipy float64 and
  against the JAX package; chunked against monolithic within CHUNK_REL
  (the plain route's float32 products block differently at other
  lengths; on the card's even routes the two are bitwise, chip_smoke.py
  path 17);
- band powers within 1e-6 relative of the port's band_powers_device on
  the monolithic PSD and of the JAX package's;
- features within 1e-5 of the JAX package's (float32 there, float64 sums
  here), and of the port's monolithic features_from_psd within CHUNK_REL;
- events equal exactly on tests/test_parallel.py's fixtures;
- refusals with the JAX package's texts.
"""

import numpy as np
import pytest
import scipy.signal

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spectral_tpu import config as jconfig  # noqa: E402
from spectral_tpu.core import stft as jstft  # noqa: E402
from spectral_tpu.models import hmm as jhmm  # noqa: E402
from spectral_tpu.models.detector import BurstDetector as JDetector  # noqa: E402
from spectral_tpu.parallel import streaming as jst  # noqa: E402
from spectral_tpu_torch import SpecConfig  # noqa: E402
from spectral_tpu_torch.core import events as tev  # noqa: E402
from spectral_tpu_torch.core.stft import (freq_axis,  # noqa: E402
                                          power_spectrogram, time_axis)
from spectral_tpu_torch.models import hmm  # noqa: E402
from spectral_tpu_torch.models.detector import BurstDetector  # noqa: E402
from spectral_tpu_torch.parallel import streaming as st  # noqa: E402

PSD_REL = 2e-5
CHUNK_REL = 1e-5
BAND_REL = 1e-6
FEAT_TOL = 1e-5


def _j(cfg):
    return jconfig.SpecConfig.from_json(cfg.to_json())


def _mono(x, fs, cfg):
    return power_spectrogram(torch.from_numpy(np.asarray(x, np.float32)),
                             fs, cfg).numpy()


def _jax_psd(x, fs, cfg):
    return np.asarray(jstft.power_spectrogram(jnp.asarray(x), fs, _j(cfg)))


def _scipy(x, fs, cfg):
    _, _, s = scipy.signal.spectrogram(
        np.asarray(x, np.float64), fs=fs, window=cfg.window,
        nperseg=cfg.nperseg, noverlap=cfg.nperseg - cfg.hop_,
        detrend=False if cfg.detrend == "none" else cfg.detrend,
        scaling="density", mode="psd")
    return s.T


def _close(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max()) / scale
    assert err <= rel, (what, err)


CASES = [
    (SpecConfig.north_star(1024, 256), 4096),
    (SpecConfig.scipy_default(1024), 8960),      # hop 896: carry 896
    (SpecConfig.north_star(256, 64), 1024),
    (SpecConfig.scipy_default(511), 448 * 4),    # odd nperseg, hop 448
]


@pytest.mark.parametrize("cfg,chunk", CASES)
def test_stream_spectrogram_against_jax_scipy_and_monolithic(cfg, chunk):
    x = np.random.RandomState(0).randn(30000).astype(np.float32)
    fs = 16000.0
    out = st.stream_spectrogram(x, fs, cfg, chunk, device="cpu")
    assert out.device.type == "cpu" and out.dtype == torch.float32
    _close(out, _scipy(x, fs, cfg), PSD_REL, "scipy")
    _close(out, _jax_psd(x, fs, cfg), PSD_REL, "jax")
    _close(out, _mono(x, fs, cfg), CHUNK_REL, "monolithic")
    jout = np.asarray(jst.stream_spectrogram(x, fs, _j(cfg), chunk))
    _close(out, jout, PSD_REL, "jax stream")


@pytest.mark.parametrize("cpb", [1, 2, 3, 7])
def test_block_streaming_equals_monolithic(cpb):
    cfg = SpecConfig.scipy_default(1024)
    fs = 48000.0
    x = np.random.RandomState(7).randn(60000).astype(np.float32)
    out = st.stream_spectrogram(x, fs, cfg, 8960, chunks_per_block=cpb,
                                device="cpu").numpy()
    _close(out, _mono(x, fs, cfg), CHUNK_REL)
    jout = np.asarray(jst.stream_spectrogram(x, fs, _j(cfg), 8960,
                                             use_matmul=True,
                                             chunks_per_block=cpb))
    _close(out, jout, PSD_REL)


def test_block_streaming_carry_roundtrip():
    cfg = SpecConfig.north_star(512, 128)
    fs = 1000.0
    s = st.BlockStreamingSTFT(fs, cfg, chunk_size=1024, chunks_per_block=2,
                              device="cpu")
    js = jst.BlockStreamingSTFT(fs, _j(cfg), chunk_size=1024,
                                chunks_per_block=2)
    x = np.random.RandomState(11).randn(3 * s.block_size).astype(np.float32)
    got = []
    for j in range(3):
        blk = x[j * s.block_size:(j + 1) * s.block_size]
        psd, valid, first = s.process_block(blk)
        jpsd, jvalid, jfirst = js.process_block(blk)
        assert first == jfirst and np.array_equal(valid, jvalid)
        _close(psd.numpy(), np.asarray(jpsd), PSD_REL)
        got.append(psd.numpy()[valid])
    assert s.frames_per_block == js.frames_per_block
    ref = _mono(x, fs, cfg)
    _close(np.concatenate(got)[:ref.shape[0]], ref, CHUNK_REL)
    with pytest.raises(ValueError, match="expected block") as e:
        s.process_block(np.zeros(100, np.float32))
    with pytest.raises(ValueError, match="expected block") as je:
        js.process_block(np.zeros(100, np.float32))
    assert str(e.value) == str(je.value)


def test_streamers_reset_reproduces_first_recording():
    cfg = SpecConfig.north_star(512, 128)
    fs = 1000.0
    x = np.random.RandomState(3).randn(4096).astype(np.float32)

    def run(s, step, size):
        out = []
        for j in range(4096 // size):
            psd, valid, _ = step(x[j * size:(j + 1) * size])
            out.append(psd.numpy()[valid])
        return np.concatenate(out)

    s = st.StreamingSTFT(fs, cfg, 1024, device="cpu")
    a = run(s, s.process, 1024)
    s.reset()
    np.testing.assert_array_equal(run(s, s.process, 1024), a)
    b = st.BlockStreamingSTFT(fs, cfg, 1024, 2, device="cpu")
    ba = run(b, b.process_block, 2048)
    b.reset()
    np.testing.assert_array_equal(run(b, b.process_block, 2048), ba)
    _close(ba, a, CHUNK_REL)


@pytest.mark.parametrize("cfg,chunk,cpb", [
    (SpecConfig.scipy_default(1024), 8960, 2),
    (SpecConfig.north_star(512, 128), 1024, 3),
])
def test_scan_spectrogram_against_jax_and_monolithic(cfg, chunk, cpb):
    fs = 48000.0
    x = np.random.RandomState(5).randn(70000).astype(np.float32)
    out = st.scan_spectrogram(x, fs, cfg, chunk, chunks_per_block=cpb,
                              device="cpu").numpy()
    _close(out, _mono(x, fs, cfg), CHUNK_REL)
    jout = np.asarray(jst.scan_spectrogram(x, fs, _j(cfg), chunk,
                                           use_matmul=True,
                                           chunks_per_block=cpb))
    _close(out, jout, PSD_REL)
    _close(out, _scipy(x, fs, cfg), PSD_REL)


def test_scan_spectrogram_fleet_is_each_recording():
    """A (B, n) fleet streams as one block loop (one launch a block on the
    card) and gives each recording's monolithic PSD."""
    cfg = SpecConfig.north_star(512, 128)
    fs = 8000.0
    x = np.random.RandomState(6).randn(3, 30000).astype(np.float32)
    out = st.scan_spectrogram(x, fs, cfg, 1024, chunks_per_block=4,
                              device="cpu").numpy()
    assert out.shape == (3,) + _mono(x[0], fs, cfg).shape
    for b in range(3):
        _close(out[b], _mono(x[b], fs, cfg), CHUNK_REL, b)
        _close(out[b], _jax_psd(x[b], fs, cfg), PSD_REL, b)


def test_stream_fold_global_max_and_band_sum():
    cfg = SpecConfig.scipy_default(512)
    fs = 1000.0
    x = np.random.RandomState(9).randn(20000).astype(np.float32)
    ref = _mono(x, fs, cfg)

    def fold(acc, psd, valid):
        m, s = acc
        v = valid[:, None].to(psd.dtype)
        return (torch.maximum(m, torch.max(psd * v)), s + torch.sum(psd * v))

    m, s = st.stream_fold(x, fs, cfg, chunk_size=448 * 4, fold=fold,
                          init=(torch.zeros(()), torch.zeros(())),
                          chunks_per_block=3, device="cpu")

    def jfold(acc, psd, valid):
        jm, js = acc
        v = valid[:, None].astype(psd.dtype)
        return (jnp.maximum(jm, jnp.max(psd * v)), js + jnp.sum(psd * v))

    jm, js = jst.stream_fold(x, fs, _j(cfg), chunk_size=448 * 4, fold=jfold,
                             init=(jnp.zeros(()), jnp.zeros(())),
                             chunks_per_block=3)
    np.testing.assert_allclose(float(m), ref.max(), rtol=1e-6)
    np.testing.assert_allclose(float(s), ref.sum(), rtol=1e-5)
    np.testing.assert_allclose(float(m), float(jm), rtol=PSD_REL)
    np.testing.assert_allclose(float(s), float(js), rtol=PSD_REL)


def test_a_fold_that_ignores_valid_is_seen_to_fail():
    """The warm-up slots of block 0 are frames of the zero carry: a global
    min that ignores ``valid`` comes out 0 instead of the signal's least
    bin, and the masked fold gets it right."""
    cfg = SpecConfig.north_star(256, 64)
    fs = 1000.0
    x = (np.random.RandomState(4).randn(8192) + 3.0).astype(np.float32)
    ref = _mono(x, fs, cfg)
    assert ref.min() > 0.0

    def masked(acc, psd, valid):
        big = torch.full_like(psd, float("inf"))
        return torch.minimum(acc, torch.where(valid[:, None], psd,
                                              big).min())

    def blind(acc, psd, valid):
        return torch.minimum(acc, psd.min())

    init = torch.tensor(float("inf"))
    got = st.stream_fold(x, fs, cfg, 1024, masked, init, device="cpu")
    bad = st.stream_fold(x, fs, cfg, 1024, blind, init, device="cpu")
    np.testing.assert_allclose(float(got), ref.min(), rtol=CHUNK_REL)
    assert float(bad) == 0.0 != ref.min()


@pytest.mark.parametrize("B", [3, 8])
def test_scan_streamer_fleet_against_jax(B):
    cfg = SpecConfig.scipy_default(512)          # hop 448
    fs = 1000.0
    n = 20000
    x = np.random.RandomState(13).randn(B, n).astype(np.float32)

    def fold(acc, psd, valid):                   # psd (B, fpb, F)
        v = valid[None, :, None].to(psd.dtype)
        return acc + torch.sum(psd * v, dim=(1, 2)), torch.zeros(())

    def jfold(acc, psd, valid):
        v = valid[None, :, None].astype(psd.dtype)
        return acc + jnp.sum(psd * v, axis=(1, 2)), jnp.zeros(())

    s = st.ScanStreamer(fs, cfg, block_size=448 * 8, n=n, fold=fold,
                        init=torch.zeros(B), batch=B, device="cpu")
    acc, ys = s(x)
    assert s.last_layout == "batched" and ys.shape == (s.n_blocks,)
    js = jst.ScanStreamer(fs, _j(cfg), block_size=448 * 8, n=n,
                          use_matmul=True, fold=jfold, init=jnp.zeros(B),
                          batch=B)
    jacc, _ = js(x)
    assert (s.skip, s.total_frames, s.n_blocks, s.padded_len) == (
        js.skip, js.total_frames, js.n_blocks, js.padded_len)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=PSD_REL)
    ref = np.stack([_mono(x[b], fs, cfg).sum() for b in range(B)])
    np.testing.assert_allclose(acc.numpy(), ref, rtol=1e-5)
    one = st.ScanStreamer(fs, cfg, 448 * 8, n, fold=lambda a, p, v: (a, p),
                          init=None, device="cpu")
    _, ys = one(x[0])
    assert one.last_layout == "single"
    assert ys.shape == (one.n_blocks, one.frames_per_block, cfg.n_freqs)


def test_streaming_random_lengths():
    cfg = SpecConfig.north_star(512, 128)
    fs = 1000.0
    for n in (512, 513, 5000, 12345, 100):
        x = np.random.RandomState(n).randn(n).astype(np.float32)
        ref = _mono(x, fs, cfg) if n >= 512 else np.zeros((0, 257))
        out = st.stream_spectrogram(x, fs, cfg, 1024, device="cpu").numpy()
        assert out.shape == ref.shape, n
        if n >= 512:
            _close(out, ref, CHUNK_REL, n)
            _close(out, _jax_psd(x, fs, cfg), PSD_REL, n)


def _raises_like_jax(entry, jentry, exc=ValueError):
    with pytest.raises(exc) as got:
        entry()
    with pytest.raises(exc) as want:
        jentry()
    assert str(got.value) == str(want.value)


def test_refusals_carry_the_jax_texts():
    cfg = SpecConfig.north_star(1024, 256)
    jc = _j(cfg)
    _raises_like_jax(lambda: st.StreamingSTFT(1000.0, cfg, 1000),
                     lambda: jst.StreamingSTFT(1000.0, jc, 1000))
    _raises_like_jax(lambda: st.StreamingSTFT(1000.0, cfg, 512),
                     lambda: jst.StreamingSTFT(1000.0, jc, 512))
    s = st.StreamingSTFT(1000.0, cfg, 2048, device="cpu")
    js = jst.StreamingSTFT(1000.0, jc, 2048)
    _raises_like_jax(lambda: s.process(np.zeros(100, np.float32)),
                     lambda: js.process(jnp.zeros(100)))
    ident = lambda acc, psd, valid: (acc, torch.zeros(()))  # noqa: E731
    small = SpecConfig.north_star(256, 64)
    for size in (500, 128):
        _raises_like_jax(
            lambda: st.ScanStreamer(1000.0, small, size, 4096, ident,
                                    torch.zeros(())),
            lambda: jst.ScanStreamer(1000.0, _j(small), size, 4096, True,
                                     ident, jnp.zeros(())))
    _raises_like_jax(
        lambda: st.BlockStreamingSTFT(1000.0, small, 1024, 0),
        lambda: jst.BlockStreamingSTFT(1000.0, _j(small), 1024, 0))
    centered = SpecConfig(nperseg=256, hop=64, center=True)
    for make, jmake in ((st.StreamingSTFT, jst.StreamingSTFT),
                        (st.BlockStreamingSTFT, jst.BlockStreamingSTFT)):
        _raises_like_jax(lambda: make(1000.0, centered, 1024),
                         lambda: jmake(1000.0, _j(centered), 1024))
    mel = SpecConfig(nperseg=256, hop=64, n_mels=32, detrend="none")
    x = np.zeros(4096, np.float32)
    for entry, jentry in (
            (lambda: st.StreamingSTFT(1000.0, mel, 512),
             lambda: jst.StreamingSTFT(1000.0, _j(mel), 512)),
            (lambda: st.BlockStreamingSTFT(1000.0, mel, 512),
             lambda: jst.BlockStreamingSTFT(1000.0, _j(mel), 512)),
            (lambda: st.stream_spectrogram(x, 1000.0, mel, 512),
             lambda: jst.stream_spectrogram(x, 1000.0, _j(mel), 512)),
            (lambda: st.scan_spectrogram(x, 1000.0, mel, 512),
             lambda: jst.scan_spectrogram(x, 1000.0, _j(mel), 512)),
            (lambda: st.stream_fold(x, 1000.0, mel, 512, lambda a, p, v: a,
                                    torch.zeros(())),
             lambda: jst.stream_fold(x, 1000.0, _j(mel), 512,
                                     lambda a, p, v: a, jnp.zeros(())))):
        _raises_like_jax(entry, jentry)


def test_refusals_of_the_port():
    """What the port leaves to later items: the mesh branch ([multi-
    device]) and configs the kernels cannot compute ([large-nperseg]:
    nperseg past 32,768), on every device, before any work; the
    single-recording folds refuse a fleet. A transform past 8192 (to
    32,768) streams like any other config, its PSD the JAX package's
    stream's; so does a zero-padded transform (nfft > nperseg), refused
    until the GEMM kernel took it."""
    x = np.zeros(8192, np.float32)
    cfg = SpecConfig.north_star(256, 64)
    with pytest.raises(NotImplementedError, match=r"\[multi-device\]"):
        st.scan_spectrogram(x, 1000.0, cfg, 1024, mesh=object())
    past = SpecConfig.north_star(65536, 16384)
    for entry in (lambda: st.stream_spectrogram(x, 1000.0, past, 65536,
                                                device="cpu"),
                  lambda: st.scan_spectrogram(x, 1000.0, past, 65536,
                                              device="cpu"),
                  lambda: st.StreamingSTFT(1000.0, past, 65536),
                  lambda: st.stream_features(x, 1000.0, past, 65536,
                                             device="cpu")):
        with pytest.raises(NotImplementedError, match=r"\[large-nperseg\]"):
            entry()
    big = SpecConfig.north_star(16384, 4096)
    z = np.random.RandomState(3).randn(40960).astype(np.float32)
    jout = np.asarray(jst.stream_spectrogram(z, 1000.0, _j(big), 16384))
    for entry in (st.stream_spectrogram, st.scan_spectrogram):
        got = entry(z, 1000.0, big, 16384, device="cpu").numpy()
        assert got.shape == jout.shape == (7, 8193)
        assert np.abs(got - jout).max() <= CHUNK_REL * np.abs(jout).max()
    padded = SpecConfig.north_star(512, 128, nfft=1024)
    y = np.random.RandomState(2).randn(8192).astype(np.float32)
    mono = _mono(y, 1000.0, padded)
    for entry in (st.stream_spectrogram, st.scan_spectrogram):
        got = entry(y, 1000.0, padded, 1024, device="cpu").numpy()
        assert got.shape == mono.shape == (61, 513)
        assert np.abs(got - mono).max() <= CHUNK_REL * np.abs(mono).max()
    for entry in (st.stream_band_powers, st.stream_features):
        with pytest.raises(ValueError, match="one recording"):
            entry(np.zeros((2, 8192), np.float32), 1000.0, cfg, 1024,
                  device="cpu")


def test_carry_len_covers_scipy_hop():
    for cfg in (SpecConfig.scipy_default(1024), SpecConfig.north_star(
            1024, 256), SpecConfig.scipy_default(8191),
            SpecConfig.north_star(300, 70)):
        assert st.carry_len(cfg) == jst.carry_len(_j(cfg))
    assert st.carry_len(SpecConfig.scipy_default(1024)) == 896


def test_iter_stream_indices_and_short_final_chunk():
    cfg = SpecConfig.north_star(256, 64)
    fs = 1000.0
    x = np.random.RandomState(3).randn(4000).astype(np.float32)
    cuts = [x[:1024], x[1024:2048], x[2048:3072], x[3072:]]  # short last
    got = list(st.iter_stream(iter(cuts), fs, cfg, 1024, device="cpu"))
    want = list(jst.iter_stream(iter(cuts), fs, _j(cfg), 1024))
    assert [f for _, f in got] == [f for _, f in want]
    assert [p.shape[0] for p, _ in got] == [p.shape[0] for p, _ in want]
    idx = 0
    for psd, first in got:
        assert first == idx
        idx += psd.shape[0]
    cat = np.concatenate([p.numpy() for p, _ in got])
    ref = _mono(x, fs, cfg)
    assert cat.shape == ref.shape
    _close(cat, ref, CHUNK_REL)
    _close(cat, np.concatenate([p for p, _ in want]), PSD_REL)


def test_iter_stream_rejects_chunk_after_short_chunk():
    cfg = SpecConfig.north_star(256, 64)
    rng = np.random.RandomState(1)
    chunks = [rng.randn(512).astype(np.float32),
              rng.randn(100).astype(np.float32),   # short, NOT final
              rng.randn(512).astype(np.float32)]

    def third(it):
        next(it)
        next(it)
        next(it)

    _raises_like_jax(
        lambda: third(st.iter_stream(iter(chunks), 1000.0, cfg, 512,
                                     device="cpu")),
        lambda: third(jst.iter_stream(iter(chunks), 1000.0, _j(cfg), 512)))


@pytest.mark.parametrize("cfg", [
    SpecConfig.north_star(256, 64),
    SpecConfig.scipy_default(1024),
    SpecConfig.scipy_default(1024, fmin=0.0, fmax=30.0),
], ids=["ns256", "sd1024", "sd1024-band"])
def test_stream_features_against_jax_and_monolithic(cfg):
    fs = 1000.0
    x = np.random.RandomState(0).randn(60 * 1000).astype(np.float32)
    t, feats = st.stream_features(x, fs, cfg, chunk_size=8 * cfg.hop_,
                                  chunks_per_block=4, device="cpu")
    jt, jfeats = jst.stream_features(x, fs, _j(cfg), chunk_size=8 * cfg.hop_,
                                     chunks_per_block=4)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(t, time_axis(cfg, fs, len(x)))
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats),
                               rtol=FEAT_TOL, atol=FEAT_TOL)
    f = freq_axis(cfg, fs)
    fmin = cfg.fmin if cfg.fmin is not None else 0.0
    fmax = cfg.fmax if cfg.fmax is not None else float(f[-1])
    ref = tev.features_from_psd(f, torch.from_numpy(_mono(x, fs, cfg)),
                                fmin, fmax).numpy()
    np.testing.assert_allclose(feats.numpy(), ref, rtol=CHUNK_REL,
                               atol=CHUNK_REL)


def _bursty(seed=2, n=60 * 1000, fs=1000.0):
    rng = np.random.RandomState(seed)
    t_samp = np.arange(n) / fs
    x = 0.02 * rng.randn(n)
    for a, b in ((10, 15), (30, 38)):
        m = (t_samp >= a) & (t_samp < b)
        x[m] += 0.6 * np.hanning(m.sum()) * np.sin(
            2 * np.pi * 6.0 * t_samp[m])
    return x.astype(np.float32)


def test_stream_detect_equals_jax_and_the_plot_flow():
    """tests/test_parallel.py's fixture: the streamed events equal the
    JAX package's streamed events and the port's plot-based flow's; the
    JAX fit, carried over by params_from_jax, decodes the port's streamed
    features to the JAX package's states."""
    fs = 1000.0
    x = _bursty()
    cfg = SpecConfig.scipy_default(1024, fmin=0.0, fmax=30.0)
    got = st.stream_detect(x, fs, cfg, chunk_size=8 * cfg.hop_,
                           device="cpu")
    want = jst.stream_detect(x, fs, _j(cfg), chunk_size=8 * cfg.hop_)
    assert got == want and len(got) >= 2
    psd = torch.from_numpy(_mono(x, fs, cfg))
    feats = tev.features_from_psd(freq_axis(cfg, fs), psd, 0.0, 30.0)
    plot = BurstDetector(device="cpu").unsupervised_detect(
        time_axis(cfg, fs, len(x)), feats)
    assert got == plot

    t, feats = st.stream_features(x, fs, cfg, 8 * cfg.hop_, device="cpu")
    jt, jfeats = jst.stream_features(x, fs, _j(cfg), 8 * cfg.hop_)
    jdet = JDetector()
    jdet.unsupervised_detect(jt, np.asarray(jfeats))
    p = hmm.params_from_jax(*(np.asarray(a) for a in jdet.params),
                            device="cpu")
    states = hmm.viterbi(p, torch.from_numpy(
        feats.numpy().astype(np.float64)))
    jstates = jhmm.viterbi(jdet.params, jnp.asarray(jfeats))
    np.testing.assert_array_equal(states.numpy(), np.asarray(jstates))


def test_stream_detect_takes_a_detector():
    fs = 1000.0
    x = _bursty(seed=5)
    cfg = SpecConfig.scipy_default(1024, fmin=0.0, fmax=30.0)
    det = BurstDetector(device="cpu", seed=7)
    got = st.stream_detect(x, fs, cfg, 8 * cfg.hop_, detector=det,
                           device="cpu")
    want = jst.stream_detect(x, fs, _j(cfg), 8 * cfg.hop_,
                             detector=JDetector(seed=7))
    assert got == want and det.params is not None


@pytest.mark.parametrize("cfg", [
    SpecConfig.scipy_default(512),
    SpecConfig.scipy_default(512, fmin=3.0, fmax=70.0),
], ids=["full", "premasked"])
def test_stream_band_powers_against_device_and_jax(cfg):
    fs = 500.0
    rng = np.random.RandomState(12)
    t = np.arange(60 * 500) / fs
    x = (rng.randn(t.size) + 2.0 * np.sin(2 * np.pi * 10.0 * t)
         + np.sin(2 * np.pi * 40.0 * t)).astype(np.float32)
    rel, total = st.stream_band_powers(x, fs, cfg, 448 * 4,
                                       chunks_per_block=3, device="cpu")
    jrel, jtotal = jst.stream_band_powers(x, fs, _j(cfg), 448 * 4,
                                          chunks_per_block=3)
    assert list(rel) == list(jrel) == list(tev.EEG_BANDS)
    np.testing.assert_allclose(total, jtotal, rtol=PSD_REL)
    np.testing.assert_allclose([rel[k] for k in rel],
                               [jrel[k] for k in rel], rtol=PSD_REL,
                               atol=1e-7)
    f = freq_axis(cfg, fs)
    psd = torch.from_numpy(_mono(x, fs, cfg).astype(np.float64))
    lo = cfg.fmin if cfg.fmin is not None else -np.inf
    hi = cfg.fmax if cfg.fmax is not None else np.inf
    keep = (f >= lo) & (f <= hi)
    ref = tev.band_powers_device(f[keep], psd[:, keep],
                                 list(tev.EEG_BANDS.values())).numpy()
    np.testing.assert_allclose([rel[k] for k in rel], ref, rtol=BAND_REL,
                               atol=1e-12)
    np.testing.assert_allclose(total, float(psd[:, keep].sum()),
                               rtol=BAND_REL)


def test_stream_band_powers_silence_is_all_zero():
    cfg = SpecConfig.scipy_default(256)
    rel, total = st.stream_band_powers(np.zeros(8192, np.float32), 500.0,
                                       cfg, 224 * 4, device="cpu")
    jrel, jtotal = jst.stream_band_powers(np.zeros(8192, np.float32), 500.0,
                                          _j(cfg), 224 * 4)
    assert rel == jrel == {k: 0.0 for k in tev.EEG_BANDS}
    assert total == jtotal == 0.0


def test_the_loop_never_concatenates_carry_and_block(monkeypatch):
    """The carry moves inside the two buffers: no torch.cat on the way."""
    def no_cat(*a, **k):
        raise AssertionError("torch.cat in the block loop")

    cfg = SpecConfig.north_star(512, 128)
    x = np.random.RandomState(8).randn(20000).astype(np.float32)
    want = st.scan_spectrogram(x, 1000.0, cfg, 1024, chunks_per_block=2,
                               device="cpu")
    monkeypatch.setattr(torch, "cat", no_cat)
    got = st.scan_spectrogram(x, 1000.0, cfg, 1024, chunks_per_block=2,
                              device="cpu")
    assert torch.equal(got, want)


def test_chip_smokes_event_mask_is_the_per_event_pass():
    """chip_smoke.py's ``in_events`` (detection_quality's frames inside an
    event, by a search) against the pass over the events it replaces."""
    import chip_smoke
    rng = np.random.RandomState(0)
    for trial in range(100):
        t = np.sort(rng.uniform(0, 100, rng.randint(1, 300)))
        if trial % 3 == 0:
            t = np.round(t, 1)
        events = []
        for _ in range(rng.randint(0, 30)):
            a = float(np.round(rng.uniform(0, 100), 1))
            events.append((a, a + float(np.round(rng.uniform(0, 10), 1))))
        want = np.zeros(len(t), bool)
        for s, e in events:
            want |= (t >= s) & (t <= e)
        np.testing.assert_array_equal(chip_smoke.in_events(t, events), want)


def test_one_launch_a_block_over_the_carry_buffer(monkeypatch):
    """Each block of a fleet is one call of the STFT over a contiguous
    float32 (B, c + L) buffer, passed as it is: the carry's c samples,
    then the block's L."""
    calls = []
    real = st.power_spectrogram

    def spy(x, fs, cfg, band=None):
        calls.append((tuple(x.shape), x.dtype, x.is_contiguous(),
                      x.data_ptr()))
        return real(x, fs, cfg, band=band)

    monkeypatch.setattr(st, "power_spectrogram", spy)
    cfg = SpecConfig.north_star(512, 128)
    x = np.random.RandomState(2).randn(2, 20000).astype(np.float32)
    out = st.scan_spectrogram(x, 1000.0, cfg, 1024, chunks_per_block=3,
                              device="cpu")
    L, c = 3 * 1024, st.carry_len(cfg)
    assert len(calls) == -(-20000 // L)
    assert all(shape == (2, c + L) and dtype == torch.float32 and contig
               for shape, dtype, contig, _ in calls)
    assert len({ptr for *_, ptr in calls}) == 2     # two buffers, in turn
    _close(out.numpy()[1], _mono(x[1], 1000.0, cfg), CHUNK_REL)
