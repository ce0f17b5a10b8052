"""The extended STFT modes on the port: zero-padded transforms on the FFT
routes (nfft > nperseg), the PSD, magnitude and complex outputs of the
kernels' epilogues, one- and two-sided spectra, centered framing, and the
complex STFT (``core.stft.stft``), held against the JAX package on the
same numpy-seeded inputs (its Pallas kernel refuses them all, so its dense
matmul route, ``use_matmul=True``, or its jnp.fft route computes them) and
against scipy in float64.

The numpy models of the four FFT families (``tools/torch_precision.py``:
the kernels' zero-padded load and their epilogues' output modes) are held
to the plain version here (:func:`check_model_modes`); the route tests
call the same check at their families' configs.

Tolerances: the PSD, magnitude and complex outputs within REL = 2e-5 of
each clip's largest |value| against the JAX package (its float32 sums)
and scipy float64 (the PSD contract); the models within MODEL_TOL = 1e-12
of the plain float64 version; a two-sided complex spectrum's mirrored
bins bitwise conjugates; the ported cases of tests/test_extended_modes.py
with that file's tolerances (rtol 1e-4, or 1e-3 under linear detrend;
atol 2e-5 of the max; 5e-3 dB across input magnitudes); displays, PNGs
and plots within the tolerances of tests/test_torch_pipeline.py,
tests/test_torch_export.py and tests/test_torch_session.py.
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
from spectral_tpu.parallel import streaming as jst  # noqa: E402
from spectral_tpu.parallel import sweep_grid as jsg  # noqa: E402
from spectral_tpu_torch import SpecConfig, ViewSettings  # noqa: E402
from spectral_tpu_torch.core import stft as tstft  # noqa: E402
from spectral_tpu_torch.core.scale import normalize  # noqa: E402
from spectral_tpu_torch.ops import stft_cuda  # noqa: E402
from spectral_tpu_torch.parallel import streaming as st  # noqa: E402
from spectral_tpu_torch.parallel import sweep_grid as sg  # noqa: E402
import torch_precision as tp  # noqa: E402
from test_torch_export import (_assert_same_pngs, _counts,  # noqa: E402
                               _export_both)
from test_torch_pipeline import (_assert_same_shown,  # noqa: E402
                                 batched_spectrogram_fn, jax_pipeline)
from test_torch_session import Pair, _bursty, _same_plot  # noqa: E402
from test_torch_streaming import CHUNK_REL, _raises_like_jax  # noqa: E402

FS = 16000.0
REL = 2e-5
MODEL_TOL = 1e-12
PAD_MODES = ("reflect", "symmetric", "edge", "wrap", "constant", "empty",
             "mean", "maximum", "minimum", "median", "linear_ramp")


def _j(cfg):
    return jconfig.SpecConfig.from_json(cfg.to_json())


def _close(got, want, rel=REL):
    """|got - want| within rel of each clip's largest |want| (the last two
    axes a clip's)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max(axis=(-2, -1), keepdims=True)
    err = np.abs(got - want)
    assert np.all(err <= rel * scale), (err / scale).max()


def _scipy(x, cfg, fs=FS):
    """scipy.signal.spectrogram in float64 of x (..., n) at cfg (centered
    by np.pad as the JAX package pads), freq-major, and its axis."""
    x = np.asarray(x, np.float64)
    if cfg.center:
        x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(cfg.nperseg // 2,) * 2],
                   mode=cfg.pad_mode)
    f, _, s = scipy.signal.spectrogram(
        x, fs=fs, window=cfg.window, nperseg=cfg.nperseg,
        noverlap=cfg.nperseg - cfg.hop_, nfft=cfg.nfft_,
        detrend=False if cfg.detrend == "none" else cfg.detrend,
        return_onesided=cfg.onesided, scaling=cfg.scaling, mode=cfg.mode)
    return f, s


def _noise(seed, shape, offset=0.0):
    return (np.random.RandomState(seed).randn(*shape) + offset).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the numpy models of the FFT families: zero-padded load, output modes
# ---------------------------------------------------------------------------

_MODELS = {"fft": (tp.psd_fft, tp.fft_operands),
           "mixed": (tp.psd_mixed_fft, tp.mixed_operands),
           "odd": (tp.psd_odd_fft, tp.mixed_operands),
           "bluestein": (tp.psd_bluestein, tp.bluestein_operands)}


def model_out(x, cfg, out="psd", round_f32=False, fs=FS):
    """The route's kernel's output of each clip of x (B, n) by its numpy
    model, (B, T, F): the frame's nperseg samples loaded into an
    nfft-point transform, the epilogue's ``out`` ("psd", "magnitude",
    "complex", or "stft" the unscaled complex STFT), from the operands the
    wrapper hands the kernel."""
    fn, operands = _MODELS[stft_cuda.route(cfg)]
    window, plan, wts = operands(cfg, fs, out)
    mode = "complex" if out == "stft" else out
    return np.stack([fn(tp.frames_of(clip, cfg), window, plan, wts,
                        detrend=cfg.detrend, round_f32=round_f32,
                        nfft=cfg.nfft_, mode=mode) for clip in x])


def plain_out(x, cfg, out="psd"):
    """The plain version's output of x (B, n) in float64, (B, T, F)."""
    xt = torch.from_numpy(np.asarray(x)).double()
    consts = stft_cuda.dft_constants(cfg, FS, "cpu", out=out)
    if out in ("complex", "stft"):
        return stft_cuda.stft_complex_reference(xt, consts, cfg).numpy()
    return stft_cuda.stft_psd_reference(
        xt, consts, dataclasses.replace(cfg, mode=out)).numpy()


def _same(a, b):
    """a and b equal bitwise: arrays and tensors by value and dtype,
    tuples element by element, anything else by ==."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a, b))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    if isinstance(a, tuple):
        return (isinstance(b, tuple) and len(a) == len(b)
                and all(_same(u, v) for u, v in zip(a, b)))
    return a == b


def check_cached_operands(cfg, fs=FS):
    """The cached operands that the numpy models and the plain version read
    at cfg in each output mode (the window, the twiddle table or plan of
    nfft, the folded matrices, the plain version's operands) equal fresh
    builds of them bitwise, so that a test before this one in the process
    that changed one in place fails here, naming it, and not as a model
    that drifted from the plain version."""
    K = cfg.nfft_
    plan = {"fft": tstft.fft_twiddles,
            "bluestein": tstft.bluestein_plan}.get(stft_cuda.route(cfg),
                                                   tstft.fft_plan)
    assert _same(plan(K), plan.__wrapped__(K)), (
        f"the cached {plan.__name__}({K}) was changed")
    for out in ("psd", "magnitude", "complex"):
        c = dataclasses.replace(cfg, mode=out)
        for cached in (tstft._window_f64, tstft.dft_matrices):
            assert _same(cached(c), cached.__wrapped__(c)), (
                f"the cached {cached.__name__} at {c} was changed")
        # the window and matrices checked, the plain version's operands
        # are built from them afresh
        key = ("dense", "cpu", c, float(fs), 0, c.n_freqs, out)
        held = stft_cuda._CONSTANTS.get(key)
        if held is not None:
            fresh = stft_cuda.constants_from_numpy(
                *stft_cuda.mirrored_dft_matrices(c),
                stft_cuda.kernel_weights(c, fs, out), "cpu", torch.float64)
            assert _same(tuple(held), tuple(fresh)), (
                f"the cached plain-version operands at {c} were changed")


def check_model_modes(cfg, seed=0):
    """The route's numpy model at cfg (nfft may pass nperseg) against the
    plain version in PSD, magnitude and complex modes, within MODEL_TOL of
    each clip's largest |value|, on noise + 3 (under linear detrend ramp
    clips); two-sided, the complex spectrum's bins past nfft/2 the
    conjugates of their mirrors bitwise, in the model and the plain
    version alike. First the cached operands the two read are held
    bitwise to fresh builds (:func:`check_cached_operands`)."""
    check_cached_operands(cfg)
    x = _noise(seed, (2, 8 * cfg.nperseg), 3.0)
    if cfg.detrend == "linear":
        x = (x + tp.trend(x.shape[-1])).astype(np.float32)
    for out in ("psd", "magnitude", "complex"):
        c = dataclasses.replace(cfg, mode=out)
        got, want = model_out(x, c, out), plain_out(x, c, out)
        _close(got, want, MODEL_TOL)
        if out == "complex" and not cfg.onesided:
            K = cfg.nfft_
            f = np.arange(1, (K + 1) // 2)
            for z in (got, want):
                assert np.array_equal(z[..., K - f], np.conj(z[..., f]))


@pytest.mark.parametrize("nperseg, nfft, onesided", [
    (250, 256, False), (24, 64, True), (200, 480, False), (100, 255, False),
    (250, 257, True), (300, 563, False)],
    ids=lambda v: str(v))
def test_models_of_every_family_at_padded_configs(nperseg, nfft, onesided):
    cfg = SpecConfig(nperseg=nperseg, hop=nperseg // 2, nfft=nfft,
                     onesided=onesided)
    assert stft_cuda.route(cfg) != "gemm"
    check_model_modes(cfg)


# ---------------------------------------------------------------------------
# stft and spectrogram
# ---------------------------------------------------------------------------

STFT_CFGS = [
    SpecConfig(nperseg=256, hop=64),
    SpecConfig(nperseg=255, hop=100, nfft=600, detrend="linear"),
    SpecConfig(nperseg=256, hop=64, nfft=1000, onesided=False,
               window="hann", detrend="none"),
    SpecConfig(nperseg=24, hop=7, nfft=64),
    SpecConfig(nperseg=10, hop=3),
    SpecConfig(nperseg=256, hop=64, center=True),
    SpecConfig(nperseg=300, hop=150, nfft=563, center=True,
               pad_mode="constant", onesided=False),
]


@pytest.mark.parametrize("use_matmul", [False, True])
@pytest.mark.parametrize("cfg", STFT_CFGS, ids=lambda c: (
    f"{c.nperseg}-{c.nfft_}-{'1' if c.onesided else '2'}"
    f"{'-c' if c.center else ''}"))
def test_stft_matches_jax(cfg, use_matmul):
    """``stft`` against the JAX package's, by its jnp.fft route and its
    dense matmul route: the shape, complex64 for float32 input, and within
    REL of each clip's largest |X|; float64 input gives complex128."""
    x = _noise(1, (2, 4000), 0.5)
    z = tstft.stft(torch.from_numpy(x), cfg)
    zj = np.asarray(jstft.stft(jnp.asarray(x), _j(cfg), use_matmul=use_matmul))
    assert z.dtype == torch.complex64
    _close(z.numpy(), zj)
    assert tstft.stft(torch.from_numpy(x[0]).double(), cfg).dtype == \
        torch.complex128


@pytest.mark.parametrize("band", [None, (300.0, 3000.0)], ids=["full",
                                                                "band"])
@pytest.mark.parametrize("onesided", [True, False])
@pytest.mark.parametrize("mode", ["psd", "magnitude", "complex"])
def test_spectrogram_modes_match_jax_and_scipy(mode, onesided, band):
    """spectrogram in each mode, one- and two-sided, with and without the
    band mask, at nperseg 256 zero-padded to 512: the axes the JAX
    package's bitwise, Sxx within REL of each clip's max against it and
    against scipy float64 (the band masked from scipy's rows)."""
    fmin, fmax = band or (None, None)
    cfg = SpecConfig(nperseg=256, hop=64, nfft=512, mode=mode,
                     onesided=onesided, fmin=fmin, fmax=fmax)
    x = _noise(2, (2, 6000), 1.0)
    f, t, sxx = tstft.spectrogram(torch.from_numpy(x), FS, cfg)
    f_j, t_j, sxx_j = jstft.spectrogram(jnp.asarray(x), FS, _j(cfg),
                                        use_matmul=True)
    assert np.array_equal(f, f_j) and np.array_equal(t, t_j)
    assert sxx.is_complex() == (mode == "complex")
    _close(sxx.numpy(), np.asarray(sxx_j))
    f_s, ref = _scipy(x, dataclasses.replace(cfg, fmin=None, fmax=None))
    if band:
        keep = (f_s >= fmin) & (f_s <= fmax)
        f_s, ref = f_s[keep], ref[..., keep, :]
    assert np.allclose(f, f_s)
    _close(sxx.numpy(), ref)


def test_complex_band_is_the_full_bands_rows():
    """A contiguous one-sided band in complex mode is computed alone (the
    kernels' band): bitwise the full spectrum's rows, as for the PSD."""
    x = torch.from_numpy(_noise(3, (2, 5000)))
    full = SpecConfig(nperseg=256, hop=64, mode="complex")
    f, _, z = tstft.spectrogram(x, FS, full)
    fb, _, zb = tstft.spectrogram(x, FS, dataclasses.replace(
        full, fmin=500.0, fmax=2500.0))
    lo = int(np.searchsorted(f, fb[0]))
    assert torch.equal(zb, z[..., lo:lo + fb.size, :])
    for out in ("complex", "stft"):
        want = stft_cuda.stft_complex(x, FS, full, scaled=out == "complex")
        got = stft_cuda.stft_complex(x, FS, full, (lo, lo + fb.size),
                                     scaled=out == "complex")
        assert torch.equal(got, want[..., lo:lo + fb.size])


def test_magnitude_is_the_square_root_of_the_psd():
    """Magnitude mode is sqrt(|X|²)·sqrt(w) with no one-sided doubling
    (scipy's), so magnitude² times the doubling is the PSD; its partials
    are the magnitude's extrema."""
    x = torch.from_numpy(_noise(4, (2, 5000), 2.0))
    cfg = SpecConfig(nperseg=256, hop=64)
    mag = dataclasses.replace(cfg, mode="magnitude")
    p = stft_cuda.stft_psd(x, FS, cfg).double()
    m = stft_cuda.stft_psd(x, FS, mag).double()
    double = torch.ones(cfg.n_freqs, dtype=torch.float64)
    double[1:-1] = 2.0
    assert torch.allclose(m * m * double, p, rtol=1e-6, atol=0)
    got, parts = stft_cuda.stft_psd_partials(x, FS, mag)
    assert torch.equal(got, stft_cuda.stft_psd(x, FS, mag))
    assert torch.equal(parts[0, 0], got.amin(-1))
    assert torch.equal(parts[1, 0], got.amax(-1))


def test_refusals_name_their_items():
    """A transform past 32,768 raises naming [large-nperseg] on every entry
    point (one past 8192 computes: test_torch_large_nperseg.py); the
    complex mode has no power spectrogram (the JAX package's ValueError,
    text and all)."""
    x = torch.zeros(1, 70000)
    big = SpecConfig.scipy_default(65536)
    for call in (lambda: tstft.stft(x, big),
                 lambda: tstft.spectrogram(x, FS, big),
                 lambda: stft_cuda.stft_complex(x, FS, big),
                 lambda: stft_cuda.stft_psd(x, FS, big)):
        with pytest.raises(NotImplementedError, match=r"\[large-nperseg\]"):
            call()
    cplx = SpecConfig(nperseg=256, mode="complex")
    for call, jcall in (
            (lambda: tstft.power_spectrogram(x, FS, cplx),
             lambda: jstft.power_spectrogram(jnp.zeros((1, 4096)), FS,
                                             _j(cplx))),
            (lambda: tstft.power_spectrogram_fm(x, FS, cplx),
             lambda: jstft.power_spectrogram_fm(jnp.zeros((1, 4096)), FS,
                                                _j(cplx)))):
        _raises_like_jax(call, jcall)
    with pytest.raises(ValueError, match="no power spectrogram"):
        stft_cuda.stft_psd(x, FS, cplx)


# ---------------------------------------------------------------------------
# centered framing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [5, 300, 4001], ids=["n5", "n300", "n4001"])
@pytest.mark.parametrize("pad_mode", PAD_MODES)
def test_center_pad_is_jnp_pad(pad_mode, n):
    """center_pad against jnp.pad(mode=pad_mode) of nperseg // 2 = 128 a
    side: the repeating modes exactly, a pad longer than the signal (n 5)
    included; the statistics and the ramp within float32 rounding."""
    cfg = SpecConfig(nperseg=256, hop=64, center=True, pad_mode=pad_mode)
    x = _noise(n, (2, n), 1.0)
    got = tstft.center_pad(torch.from_numpy(x), cfg).numpy()
    want = np.asarray(jnp.pad(jnp.asarray(x), [(0, 0), (128, 128)],
                              mode=pad_mode))
    assert got.shape == want.shape == (2, n + 256)
    if pad_mode in ("mean", "linear_ramp"):
        assert np.allclose(got, want, rtol=2e-6, atol=1e-6)
    else:
        assert np.array_equal(got, want)


def test_center_pad_refuses_like_jnp_pad():
    for cfg in (SpecConfig(nperseg=256, center=True, pad_mode="bogus"),):
        _raises_like_jax(
            lambda: tstft.center_pad(torch.zeros(1, 1000), cfg),
            lambda: jnp.pad(jnp.zeros((1, 1000)), [(0, 0), (128, 128)],
                            mode=cfg.pad_mode), NotImplementedError)
    assert tstft.center_pad(torch.ones(3), SpecConfig(nperseg=256)).shape \
        == (3,)


@pytest.mark.parametrize("pad_mode", PAD_MODES)
def test_centered_spectrogram_matches_jax_and_scipy(pad_mode):
    """The centered PSD in each pad mode, through the plain version and the
    dense route, against the JAX package (power_spectrogram) and scipy
    float64 on the np.pad-padded signal; frame times k·hop/fs."""
    cfg = SpecConfig(nperseg=256, hop=64, nfft=300, center=True,
                     pad_mode=pad_mode)
    x = _noise(5, (2, 3000), 0.5)
    got = stft_cuda.stft_psd(torch.from_numpy(x), FS, cfg).numpy()
    dense = tstft.power_spectrogram(torch.from_numpy(x), FS, cfg).numpy()
    want = np.asarray(jstft.power_spectrogram(jnp.asarray(x), FS, _j(cfg),
                                              use_matmul=True))
    _close(got, want)
    _close(dense, want)
    if pad_mode != "empty":
        _close(got, np.swapaxes(_scipy(x, cfg)[1], -1, -2))
    t = tstft.time_axis(cfg, FS, 3000)
    assert t.size == got.shape[1] and np.allclose(t, np.arange(t.size) * 64
                                                  / FS)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

PIPE_CFGS = {
    "magnitude": dict(mode="magnitude"),
    "magnitude_band": dict(mode="magnitude", fmin=300.0, fmax=3000.0),
    "magnitude_mel": dict(mode="magnitude", n_mels=40),
    "center_reflect": dict(center=True),
    "center_constant_nfft": dict(center=True, pad_mode="constant",
                                 nfft=400),
    "center_edge_band": dict(center=True, pad_mode="edge", fmin=100.0,
                             fmax=2000.0),
}


@pytest.mark.parametrize("log_scale", [True, False])
@pytest.mark.parametrize("kind", sorted(PIPE_CFGS))
def test_pipeline_matches_jax(kind, log_scale):
    """batched_spectrogram_fn on magnitude and centered configs (with a
    band, the mel branch over the magnitude, nfft > nperseg) against the
    JAX pipeline: the displayed rows and what lies beside them
    (tests/test_torch_pipeline.py's _assert_same_shown)."""
    cfg = SpecConfig(nperseg=256, hop=64, window="hann", detrend="none",
                     log_scale=log_scale, **PIPE_CFGS[kind])
    x = _noise(6, (2, 8000))
    port = batched_spectrogram_fn(FS, cfg, flip_image=True)(
        torch.from_numpy(x))
    ref = jax.jit(jax_pipeline(FS, cfg, flip_image=True))(jnp.asarray(x))
    _assert_same_shown(port, ref, log_scale)


@pytest.mark.parametrize("cfg", [
    SpecConfig.north_star(256, 64, center=True, log_scale=True),
    SpecConfig.north_star(256, 64, center=True, pad_mode="wrap"),
    SpecConfig.north_star(256, 64, mode="magnitude", log_scale=True)],
    ids=["center_log", "center_wrap", "magnitude_log"])
def test_export_matches_jax(tmp_path, cfg):
    """export_spectrograms of centered (the palette unpack width from the
    padded clip) and magnitude configs: the JAX export's PNGs and
    counts."""
    rs = np.random.RandomState(7)
    clips = [(f"c{i}", rs.randn(4096).astype(np.float32)) for i in range(3)]
    dirs, stats = _export_both(tmp_path, clips, cfg=cfg)
    _assert_same_pngs(dirs)
    assert _counts(stats["port"]) == _counts(stats["jax"])


def test_sweep_grid_centered_groups_match_jax():
    """Centered groups in several pad modes beside an uncentered one, each
    config against the JAX grid's; a magnitude config keeps the JAX
    package's ValueError."""
    fs = 8000.0
    cfgs = [SpecConfig(nperseg=n, hop=n // 4, window=w, detrend="none",
                       center=c, pad_mode=m)
            for n, c, m in ((256, True, "reflect"), (512, True, "edge"),
                            (256, False, "reflect"), (300, True, "wrap"))
            for w in ("hann", "hamming")]
    x = _noise(8, (6000,))
    got = sg.sweep_grid(x, fs, cfgs, device="cpu")
    want = jsg.sweep_grid(jnp.asarray(x), fs, [_j(c) for c in cfgs])
    for c, a, b in zip(cfgs, got, want):
        _close(a.numpy(), np.asarray(b))
        assert a.shape[0] == tstft.num_frames(
            6000 + (2 * (c.nperseg // 2) if c.center else 0), c.nperseg,
            c.hop_)
    mag = dataclasses.replace(cfgs[0], mode="magnitude")
    _raises_like_jax(lambda: sg.sweep_grid(x, fs, [mag], device="cpu"),
                     lambda: jsg.sweep_grid(jnp.asarray(x), fs, [_j(mag)]))


@pytest.mark.parametrize("cfg", [
    SpecConfig.north_star(256, 64, center=True, log_scale=True),
    dataclasses.replace(SpecConfig.scipy_default(
        512, fmin=0.0, fmax=40.0, log_scale=True), mode="magnitude"),
    SpecConfig.scipy_default(256, onesided=False, log_scale=True),
    SpecConfig.scipy_default(256, onesided=False, fmin=-100.0, fmax=100.0),
    dataclasses.replace(SpecConfig.scipy_default(256, nfft=1000,
                                                  center=True),
                        mode="magnitude")],
    ids=["center", "magnitude_band", "two_sided", "two_sided_band",
         "padded_magnitude_center"])
def test_session_plot_matches_jax(cfg):
    """The session's plot (the plot program, or the legacy host path for
    a two-sided band) on centered, magnitude and two-sided configs: the
    JAX session's axes, sxx and image."""
    p = Pair()
    p.register("rec_sweep0", "rec.wav", 0, 1000.0, 1000.0,
               _bursty(dur=30.0), None)
    rt, rj = p.plot(["rec_sweep0"], cfg, ViewSettings())
    _same_plot(rt, rj, cfg.log_scale)
    assert rt.sxx.shape[0] == rt.f.size and rt.sxx.shape[1] == rt.t.size


def test_streaming_magnitude_and_padded_blocks():
    """The streaming drivers take magnitude and nfft > nperseg configs
    (blocks on the route of nfft): the monolithic spectrogram within
    CHUNK_REL; centered framing and the complex mode keep the JAX
    package's ValueErrors."""
    y = _noise(9, (8192,))
    for cfg in (SpecConfig.north_star(256, 64, mode="magnitude"),
                SpecConfig.north_star(256, 64, nfft=1000, mode="magnitude")):
        mono = tstft.power_spectrogram(torch.from_numpy(y), 1000.0,
                                       cfg).numpy()
        for entry in (st.stream_spectrogram, st.scan_spectrogram):
            got = entry(y, 1000.0, cfg, 1024, device="cpu").numpy()
            assert got.shape == mono.shape
            assert np.abs(got - mono).max() <= CHUNK_REL * np.abs(mono).max()
    centered = SpecConfig(nperseg=256, hop=64, center=True)
    _raises_like_jax(lambda: st.StreamingSTFT(1000.0, centered, 1024),
                     lambda: jst.StreamingSTFT(1000.0, _j(centered), 1024))
    cplx = SpecConfig(nperseg=256, hop=64, mode="complex")
    _raises_like_jax(
        lambda: st.stream_spectrogram(y, 1000.0, cplx, 1024, device="cpu"),
        lambda: jst.stream_spectrogram(jnp.asarray(y), 1000.0, _j(cplx),
                                       1024))


# ---------------------------------------------------------------------------
# tests/test_extended_modes.py's cases, through the port and the routes'
# models
# ---------------------------------------------------------------------------

def _hann(mode="psd", **kw):
    return SpecConfig(nperseg=256, hop=128, window="hann", detrend="none",
                      mode=mode, **kw)


def _port_and_model(x64, cfg, fs):
    """The port's spectrogram (freq-major) and the route's model of the
    kernel (freq-major), of a float32 clip."""
    x = x64.astype(np.float32)
    _, _, sxx = tstft.spectrogram(torch.from_numpy(x), fs, cfg)
    out = "psd" if cfg.mode == "psd" else cfg.mode
    model = model_out(x[None], cfg, out, round_f32=True, fs=fs)[0].T
    return sxx.numpy(), model


@pytest.mark.parametrize("case", ["linear_detrend", "nfft_zero_padding",
                                  "magnitude", "spectrum_scaling"])
def test_extended_mode_cases_match_scipy(case):
    fs = 1000.0
    seed = {"linear_detrend": 0, "nfft_zero_padding": 1, "magnitude": 2,
            "spectrum_scaling": 3}[case]
    rng = np.random.RandomState(seed)
    rtol = 1e-4
    if case == "linear_detrend":
        t = np.arange(8192) / fs
        x = rng.randn(8192) + 5.0 * t + 3.0
        cfg = dataclasses.replace(_hann(), detrend="linear")
        rtol = 1e-3
    else:
        x = rng.randn(8192)
        cfg = {"nfft_zero_padding": _hann(nfft=512),
               "magnitude": _hann("magnitude"),
               "spectrum_scaling": _hann(scaling="spectrum")}[case]
    f_ref, ref = _scipy(x, cfg, fs)
    for got in _port_and_model(x, cfg, fs):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=ref.max() * 2e-5)
    if case == "nfft_zero_padding":
        assert ref.shape[0] == 257 == f_ref.size


@pytest.mark.parametrize("scale", [1e-6, 1e-3, 1.0, 1e3, 1e6])
def test_db_error_budget_across_magnitudes(scale):
    """test_extended_modes.py's budget across input magnitudes: the
    port's display within 5e-3 dB of scipy float64 (it holds 1e-3 dB,
    the contract, with its float64 sums)."""
    fs = 16000.0
    x = (np.random.RandomState(4).randn(64000) * scale).astype(np.float32)
    cfg = SpecConfig.north_star(1024, 256, log_scale=True)
    _, ref64 = _scipy(x, cfg, fs)
    norm = np.clip(ref64 / (ref64.max() + 1e-20), 0, 1)
    db = 10 * np.log10(norm + 1e-12)
    rng_db = db.max() - db.min()
    psd = stft_cuda.stft_psd(torch.from_numpy(x), fs, cfg)
    img = normalize(psd.T, log_scale=True).numpy()
    err_db = np.abs(img - (db - db.min()) / rng_db).max() * rng_db
    assert err_db <= 1e-3, (scale, err_db)
