"""The slice end to end: the port's batched_spectrogram_fn on the CPU (the
kernels' plain versions) held against the JAX package's
batched_spectrogram_fn(use_matmul=True) and pallas_pipeline_fn on the same
clips.

Tolerances:
- psd within 5e-6 of each clip's max (the JAX side's float32 GEMMs against
  the port's float64);
- image error times the clip's dB range within 5e-3 dB, the budget the
  JAX package's own golden test gives its matmul route against scipy
  float64 on the CPU (test_stft_golden.py::test_db_pipeline_error_budget).
  At the deepest bin of white noise every float32 engine carries ~1e-3 dB,
  set by the summation order: on two 1 s clips at 1024/256 the JAX matmul
  route sits 3.2e-3 dB from scipy, its pallas route 6e-4, and the port,
  in float64, below 1e-5;
- rgb_packed >= 99.9% identical words and never more than one LUT index
  apart (a pixel near a 1/256 bin edge may cross it);
- finite equal exactly.
"""

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
from spectral_tpu.ops import stft_pallas  # noqa: E402
from spectral_tpu.parallel import sharding as jsharding  # noqa: E402
from spectral_tpu.render.lut import get_lut  # noqa: E402
from spectral_tpu_torch import SpecConfig  # noqa: E402
from spectral_tpu_torch.parallel import sharding  # noqa: E402

FS = 16000.0
PSD_TOL = 5e-6
DB_TOL = 5e-3
SAME_WORDS = 0.999
NS_256 = SpecConfig.north_star(256, 64, log_scale=True)


def _jax(cfg):
    """The JAX package's twin of a port config."""
    return jconfig.SpecConfig.from_json(cfg.to_json())


def jax_pipeline(fs, cfg, **kw):
    return jsharding.batched_spectrogram_fn(fs, _jax(cfg), **kw)


def pallas_pipeline_fn(fs, cfg, **kw):
    return stft_pallas.pallas_pipeline_fn(fs, _jax(cfg), **kw)


def batched_spectrogram_fn(fs, cfg, device="cpu", **kw):
    """The port's pipeline, on the CPU unless the test says otherwise."""
    return sharding.batched_spectrogram_fn(fs, cfg, device=device, **kw)


def _clips(seed, n_clips=2, n=16000):
    return np.random.RandomState(seed).randn(n_clips, n).astype(np.float32)


def _index_range(words):
    """First and last LUT index of each packed jet word (duplicate words
    of the table are neighbours)."""
    lut = get_lut("jet").astype(np.uint32)
    table = lut[:, 0] | (lut[:, 1] << 8) | (lut[:, 2] << 16) | (255 << 24)
    first = {w: i for i, w in reversed(list(enumerate(table.tolist())))}
    last = {w: i for i, w in enumerate(table.tolist())}
    uniq, inv = np.unique(words.ravel(), return_inverse=True)
    return (np.array([first[w] for w in uniq.tolist()])[inv],
            np.array([last[w] for w in uniq.tolist()])[inv])


def _assert_same_display(port, ref):
    psd, psd_r = port["psd"].numpy(), np.asarray(ref["psd"])
    scale = psd_r.max(axis=(1, 2))
    assert np.all(np.abs(psd - psd_r).max(axis=(1, 2)) <= PSD_TOL * scale)
    p64 = psd_r.astype(np.float64)
    rng_db = 10 * np.log10(p64.max(axis=(1, 2)) / p64.min(axis=(1, 2)))
    img, img_r = port["image"].numpy(), np.asarray(ref["image"])
    assert img.shape == img_r.shape
    err_db = np.abs(img - img_r).max(axis=(1, 2)) * rng_db
    assert np.all(err_db <= DB_TOL), err_db
    words, words_r = port["rgb_packed"].numpy(), np.asarray(ref["rgb_packed"])
    assert words.dtype == np.uint32 and words.shape == words_r.shape
    lo, hi = _index_range(words)
    lo_r, hi_r = _index_range(words_r)
    step = np.maximum(0, np.maximum(lo - hi_r, lo_r - hi)).max()
    assert (words == words_r).mean() >= SAME_WORDS and step <= 1
    assert np.array_equal(port["finite"].numpy(), np.asarray(ref["finite"]))


@pytest.mark.parametrize("share_max", [False, True])
@pytest.mark.parametrize("flip_image", [True, False])
def test_slice_matches_jax_pipeline(flip_image, share_max):
    x = _clips(0)
    ref = jax.jit(jax_pipeline(FS, NS_256, use_matmul=True,
                               flip_image=flip_image,
                               share_max=share_max))(jnp.asarray(x))
    port = batched_spectrogram_fn(FS, NS_256, flip_image=flip_image,
                                  share_max=share_max)(torch.from_numpy(x))
    _assert_same_display(port, ref)


@pytest.mark.parametrize("cfg", [
    NS_256,
    SpecConfig.north_star(1024, 256, log_scale=True),
    SpecConfig.scipy_default(1024, log_scale=True),
], ids=["north_star_256_64", "north_star_1024_256", "scipy_1024"])
def test_slice_matches_pallas_pipeline(cfg):
    """pallas_pipeline_fn's layout: image unflipped, packed words flipped.
    At 1024 the JAX matmul route on the CPU sums in an order that sits
    3.2e-3 dB from scipy on these clips (the pallas route 6e-4), enough to
    move more than 0.1% of the words; the pallas route is the reference
    there."""
    x = _clips(1)
    ref = jax.jit(pallas_pipeline_fn(FS, cfg))(jnp.asarray(x))
    port = batched_spectrogram_fn(FS, cfg)(x)
    _assert_same_display(port, ref)


def test_flip_conventions():
    """image is flipped only under flip_image; packed words always put the
    highest frequency in row 0; psd is frame-major and never flipped."""
    t = np.arange(16000) / FS
    tone = np.sin(2 * np.pi * 100.0 * t).astype(np.float32)[None]
    flipped = batched_spectrogram_fn(FS, NS_256, flip_image=True)(tone)
    plain = batched_spectrogram_fn(FS, NS_256, flip_image=False)(tone)
    assert torch.equal(flipped["psd"], plain["psd"])
    assert flipped["psd"].shape == (1, 247, 129)
    assert torch.equal(flipped["image"], plain["image"].flip(1))
    assert torch.equal(flipped["rgb_packed"], plain["rgb_packed"])
    # a 100 Hz tone is energetic at bin 1-2 of 129: the bottom of the PNG
    energy = plain["image"][0].mean(dim=1)
    assert int(torch.argmax(energy)) <= 2
    red = (flipped["rgb_packed"][0].numpy() & 0xFF).astype(int).mean(axis=1)
    assert np.argmax(red) >= 129 - 10


def test_finite_flags_match_both_jax_pipelines():
    rs = np.random.RandomState(4)
    nan = rs.randn(4096).astype(np.float32)
    nan[1000] = np.nan
    x = np.stack([rs.randn(4096), nan, 1e-25 * rs.randn(4096),
                  np.zeros(4096), np.full(4096, 0.25),
                  1e19 * rs.randn(4096)]).astype(np.float32)
    want = [True, False, False, True, True, False]
    port = batched_spectrogram_fn(FS, NS_256)(torch.from_numpy(x))
    assert port["finite"].tolist() == want
    for ref in (jax_pipeline(FS, NS_256, use_matmul=True),
                pallas_pipeline_fn(FS, NS_256)):
        assert np.asarray(jax.jit(ref)(jnp.asarray(x))["finite"]).tolist() \
            == want


def test_zero_frames_like_pallas_pipeline():
    cfg = SpecConfig.north_star(1024, 256, log_scale=True)
    ref = jax.jit(pallas_pipeline_fn(FS, cfg))(jnp.zeros((2, 100)))
    port = batched_spectrogram_fn(FS, cfg)(torch.zeros(2, 100))
    for key in ("psd", "image", "rgb_packed", "finite"):
        assert tuple(port[key].shape) == ref[key].shape
    assert port["finite"].tolist() == np.asarray(ref["finite"]).tolist()


def test_colormap_none_and_input_coercion():
    x = (_clips(5) * 1000).astype(np.int16)
    out = batched_spectrogram_fn(FS, NS_256, colormap=None,
                                 device="cpu")(x)
    assert set(out) == {"psd", "image", "finite"}
    assert out["psd"].dtype == torch.float32
    with pytest.raises(ValueError, match=r"\(B, n\)"):
        batched_spectrogram_fn(FS, NS_256)(np.zeros(4096, np.float32))


def test_unsupported_configs_raise_on_build():
    """The extended modes still raise when the pipeline is built; the mel
    and band configs that [band-mel] refused now compute (their outputs
    are held to JAX in test_torch_band.py)."""
    for cfg, item in ((SpecConfig.scipy_default(16384), r"\[ext-modes\]"),):
        with pytest.raises(NotImplementedError, match=item):
            batched_spectrogram_fn(FS, cfg)
    x = _clips(0, n=4096)
    mel = batched_spectrogram_fn(
        FS, SpecConfig.north_star(256, 64, n_mels=32))(x)
    assert tuple(mel["mel"].shape) == (2, 61, 32)
    assert tuple(mel["psd"].shape) == (2, 61, 129)
    band = batched_spectrogram_fn(
        FS, SpecConfig.scipy_default(256, fmax=100.0))(x)
    assert tuple(band["psd"].shape) == (2, 18, 2)    # bins 0 and 62.5 Hz
    assert tuple(band["image"].shape) == (2, 2, 18)


def test_device_is_explicit(monkeypatch):
    from spectral_tpu_torch.utils import device as dev
    assert dev.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        dev.resolve_device(None)
    with pytest.raises(ValueError):
        dev.resolve_device("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        dev.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        batched_spectrogram_fn(FS, NS_256, device="cuda")
    # the card is the default: without one, building the pipeline raises
    with pytest.raises(RuntimeError, match="is_available"):
        sharding.batched_spectrogram_fn(FS, NS_256)


def _index_bytes(words, width):
    from spectral_tpu_torch.ops.colormap import unpack_indices
    return unpack_indices(words, width).astype(int)


@pytest.mark.parametrize("flip_image", [True, False])
def test_palette_matches_jax_index_pack(flip_image):
    """palette=True: the JAX package's colormap_index_packed of its image
    (row 0 the highest frequency, width padded to a multiple of 4), held
    to the packed-word rule in index units, on the clips of
    test_slice_matches_jax_pipeline. Index units see every step that the
    deepest bin's float32 error moves the dB scale by (99.84-99.997%
    identical over five seeds against either JAX route), where RGBA words
    hide the steps between the jet table's duplicate entries."""
    from spectral_tpu.ops.colormap import colormap_index_packed
    x = _clips(0)                            # T = 247: one byte of pad
    ref = jax.jit(jax_pipeline(FS, NS_256, use_matmul=True,
                               flip_image=flip_image))(jnp.asarray(x))
    want = np.asarray(colormap_index_packed(ref["image"],
                                            flip_rows=not flip_image))
    port = batched_spectrogram_fn(FS, NS_256, flip_image=flip_image,
                                  palette=True)(x)
    assert set(port) == {"psd", "image", "index_packed", "finite"}
    got = port["index_packed"]
    T = port["psd"].shape[1]
    assert got.dtype == torch.uint32 and tuple(got.shape) == want.shape
    assert want.shape == (2, 129, -(-T // 4)) and T % 4
    a, b = _index_bytes(got, T), _index_bytes(want, T)
    assert (a == b).mean() >= SAME_WORDS and np.abs(a - b).max() <= 1
    # the pad bytes past T are zero, as jnp.pad leaves them
    pad = got.numpy().view(np.uint8).reshape(2, 129, -1)[..., T:]
    assert not pad.any()
    # the same pixels as the RGBA words of the same run
    rgb = batched_spectrogram_fn(FS, NS_256, flip_image=flip_image)(x)
    assert torch.equal(rgb["image"], port["image"])


@pytest.mark.parametrize("palette", [True, False])
def test_without_image_keeps_the_words(palette):
    """with_image=False (the dataset export's call) leaves the float image
    out and returns the same words, PSD and flags."""
    x = _clips(0)
    key = "index_packed" if palette else "rgb_packed"
    full = batched_spectrogram_fn(FS, NS_256, flip_image=True,
                                  palette=palette)(x)
    lean = batched_spectrogram_fn(FS, NS_256, flip_image=True,
                                  palette=palette, with_image=False)(x)
    assert set(lean) == {"psd", key, "finite"}
    for k in lean:
        assert torch.equal(lean[k], full[k])


def test_slice_at_scipy_2048_matches_pallas_pipeline():
    """The f64 route end to end at a frequency-tiled size, on noise + 3.
    The port's PSD is held to the JAX Pallas kernel at that kernel's own
    tolerance (tests/test_stft_pallas.py:120) and its image to scipy in
    float64 at 1e-3 dB: the float32 Pallas route is the less accurate of
    the two here, so its packed words are no reference (99.84% identical
    on these clips)."""
    from torch_precision import scipy_display
    cfg = SpecConfig.scipy_default(2048, log_scale=True)
    x = _clips(7, n=8 * 2048) + np.float32(3.0)
    ref = jax.jit(pallas_pipeline_fn(FS, cfg))(jnp.asarray(x))
    port = batched_spectrogram_fn(FS, cfg)(x)
    psd_r = np.asarray(ref["psd"])
    np.testing.assert_allclose(port["psd"].numpy(), psd_r, rtol=3e-4,
                               atol=float(psd_r.max()) * 1e-6)
    assert port["finite"].tolist() == np.asarray(ref["finite"]).tolist()
    for clip, img in zip(x.astype(np.float64), port["image"].numpy()):
        oracle, rng_db = scipy_display(clip, cfg, FS)
        assert np.abs(img - oracle).max() * rng_db <= 1e-3


# ---------------------------------------------------------------------------
# the band mask and the mel branch (the JAX function's sharding.py:33-138)
# ---------------------------------------------------------------------------

BAND_CFGS = {
    "band": dict(nperseg=256, hop=64, window="hann", detrend="none",
                 fmin=300.0, fmax=3000.0),
    "mel": dict(nperseg=256, hop=64, window="hann", detrend="none",
                n_mels=40),
    "band_mel": dict(nperseg=256, hop=64, window="hann", detrend="none",
                     n_mels=40, fmin=500.0, fmax=5000.0),
}


def _assert_same_shown(port, ref, log_scale):
    """The displayed rows (the banded PSD, or the mel rows) and what lies
    beside them against the JAX function: psd and mel within PSD_TOL of
    each clip's max, the image within DB_TOL dB (log) or PSD_TOL (linear),
    the words as _assert_same_display, finite exactly."""
    for key in ("psd", "mel"):
        assert (key in port) == (key in ref)
        if key in port:
            got, want = port[key].numpy(), np.asarray(ref[key])
            assert got.shape == want.shape
            scale = want.max(axis=(1, 2))
            assert np.all(np.abs(got - want).max(axis=(1, 2))
                          <= PSD_TOL * scale), key
    shown = np.asarray(ref["mel"] if "mel" in ref else ref["psd"])
    img, img_r = port["image"].numpy(), np.asarray(ref["image"])
    assert img.shape == img_r.shape
    err = np.abs(img - img_r).max(axis=(1, 2))
    if log_scale:
        s64 = shown.astype(np.float64)
        err = err * 10 * np.log10(s64.max(axis=(1, 2)) / s64.min(axis=(1, 2)))
        assert np.all(err <= DB_TOL), err
    else:
        assert np.all(err <= PSD_TOL), err
    if "rgb_packed" in ref:
        words, words_r = (port["rgb_packed"].numpy(),
                          np.asarray(ref["rgb_packed"]))
        assert words.shape == words_r.shape
        lo, hi = _index_range(words)
        lo_r, hi_r = _index_range(words_r)
        step = np.maximum(0, np.maximum(lo - hi_r, lo_r - hi)).max()
        assert (words == words_r).mean() >= SAME_WORDS and step <= 1
    assert np.array_equal(port["finite"].numpy(), np.asarray(ref["finite"]))


@pytest.mark.parametrize("log_scale", [True, False])
@pytest.mark.parametrize("share_max", [False, True])
@pytest.mark.parametrize("flip_image", [False, True])
@pytest.mark.parametrize("kind", sorted(BAND_CFGS))
def test_band_and_mel_match_jax_pipeline(kind, flip_image, share_max,
                                         log_scale):
    """Ports of tests/test_parallel.py:69 and :938-999 and
    tests/test_freq_major.py:143-240 against the JAX function itself: the
    band, the mel branch and both, each with and without flip_image,
    share_max and log_scale."""
    cfg = SpecConfig(log_scale=log_scale, **BAND_CFGS[kind])
    x = _clips(6, n=8192)
    x[1] *= 40.0                                 # share_max sees the loud one
    ref = jax.jit(jax_pipeline(FS, cfg, use_matmul=True,
                               flip_image=flip_image,
                               share_max=share_max))(jnp.asarray(x))
    port = batched_spectrogram_fn(FS, cfg, flip_image=flip_image,
                                  share_max=share_max)(torch.from_numpy(x))
    T = 125
    if kind == "band":
        assert port["psd"].shape == (2, T, 44) and "mel" not in port
    else:
        assert port["psd"].shape == (2, T, 129)   # full band, pre-mel
        assert port["mel"].shape[:2] == (2, T)
    _assert_same_shown(port, ref, log_scale)


def test_band_mask_is_mask_then_normalize():
    """Port of tests/test_parallel.py:938: the banded image equals the
    full-band PSD's rows masked, then normalized (PlotEngine.py:114-127),
    under both flip senses, and the psd output is the band, frame-major,
    unflipped."""
    from spectral_tpu_torch.core.scale import normalize
    from spectral_tpu_torch.core.stft import (band_row_slice, freq_axis,
                                              mask_band_rows)
    fs = 1000.0
    cfg = SpecConfig.scipy_default(256, fmin=5.0, fmax=80.0, log_scale=True)
    full_cfg = SpecConfig.scipy_default(256, log_scale=True)
    x = np.random.RandomState(3).randn(4, 6000).astype(np.float32)
    full = batched_spectrogram_fn(fs, full_cfg)(x)["psd"]
    f = freq_axis(cfg, fs)
    want = []
    for i in range(4):
        f_m, sxx_m = mask_band_rows(f, full[i].T, cfg.fmin, cfg.fmax)
        want.append(normalize(sxx_m, True))
    want = torch.stack(want)
    assert (f_m >= 5.0).all() and (f_m <= 80.0).all() and len(f_m) < len(f)
    for flip in (False, True):
        out = batched_spectrogram_fn(fs, cfg, flip_image=flip)(x)
        got = out["image"].flip(1) if flip else out["image"]
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 2e-6
        assert out["psd"].shape == (4, full.shape[1], len(f_m))
        lo, hi = band_row_slice(f, cfg.fmin, cfg.fmax)
        assert torch.equal(out["psd"], full[..., lo:hi])


def test_mel_flip_is_the_row_flip_and_mel_is_psd_times_fb():
    """Port of tests/test_freq_major.py:143 and :211: under flip_image the
    mel image is exactly the row flip of the unflipped one, mel is
    unflipped, and mel is the psd output times the filterbank."""
    from spectral_tpu_torch.core.mel import mel_filterbank
    fs = 1000.0
    x = np.random.RandomState(5).randn(3, 4000).astype(np.float32)
    cfg = SpecConfig.north_star(256, 64, log_scale=True, n_mels=24)
    flipped = batched_spectrogram_fn(fs, cfg, colormap=None,
                                     flip_image=True)(x)
    plain = batched_spectrogram_fn(fs, cfg, colormap=None)(x)
    assert torch.equal(flipped["image"], plain["image"].flip(1))
    assert torch.equal(flipped["mel"], plain["mel"])
    fb = mel_filterbank(24, 129, fs)
    want = plain["psd"].double().numpy() @ fb.T
    got = plain["mel"].numpy()
    assert got.shape == want.shape == (3, 59, 24)
    assert np.abs(got - want).max() <= 1e-7 * want.max()


def test_band_finite_flag_reads_the_displayed_rows():
    """A clip whose only non-finite bins lie outside the band (a 400 Hz tone
    at 1e19, whose power overflows float32 there alone) is healthy under
    the 0-30 Hz band and not over the full band; under the mel branch the
    full-band PSD's inf meets zero weights, so every mel row is NaN and
    the clip is not healthy. All three against the JAX function."""
    fs = 1000.0
    t = np.arange(8000) / fs
    loud = (1e19 * np.sin(2 * np.pi * 400.0 * t)).astype(np.float32)
    x = np.stack([np.random.RandomState(6).randn(8000).astype(np.float32),
                  loud])
    cases = ((SpecConfig.scipy_default(256, fmin=0.0, fmax=30.0), True),
             (SpecConfig.scipy_default(256), False),
             (SpecConfig.scipy_default(256, n_mels=16, fmin=0.0,
                                       fmax=100.0), False))
    for cfg, healthy in cases:
        port = batched_spectrogram_fn(fs, cfg)(x)
        ref = jax.jit(jax_pipeline(fs, cfg, use_matmul=True))(jnp.asarray(x))
        assert port["finite"].tolist() == [True, healthy]
        assert np.asarray(ref["finite"]).tolist() == [True, healthy]


def test_band_and_mel_refuse_on_build_like_jax():
    """An empty band raises when the pipeline is built, with the JAX
    package's text (tests/test_parallel.py:994); so does an empty band on
    the mel-centre axis, and a band of a two-sided spectrum."""
    with pytest.raises(ValueError, match="no frequency rows"):
        batched_spectrogram_fn(
            1000.0, SpecConfig.scipy_default(256, fmin=600.0, fmax=700.0))
    with pytest.raises(ValueError, match="no frequency rows"):
        batched_spectrogram_fn(FS, SpecConfig.north_star(
            256, 64, n_mels=16, fmin=9000.0, fmax=9500.0))
    two = SpecConfig(nperseg=64, hop=16, onesided=False, detrend="none",
                     window="hann", fmin=0.0, fmax=100.0)
    with pytest.raises(ValueError, match="one-sided"):
        batched_spectrogram_fn(1000.0, two)
    with pytest.raises(ValueError, match="one-sided"):
        jax.jit(jax_pipeline(1000.0, two, use_matmul=True))(
            jnp.zeros((1, 512)))
