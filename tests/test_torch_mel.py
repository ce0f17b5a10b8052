"""The port's mel branch on the CPU: its copy of the JAX package's mel
filterbank (spectral_tpu_torch.core.mel), the plain projection apply_mel
and the mel kernel's wrapper (spectral_tpu_torch.ops.mel_cuda), held
against the JAX package on the same seeded inputs.

Tolerances:
- the filterbank, its centres and the Hz/mel maps: bitwise (the same numpy
  float64 code);
- apply_mel against JAX's float32 product: 1e-6 of the largest mel value
  (the port sums in float64), NaN and inf in the same places;
- the kernel's arithmetic, transcribed in numpy (span sums in float64 and
  the non-finite rule), against apply_mel: within 1 float32 ulp, NaN and
  inf in the same places, as chip_smoke.py holds the kernel on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spectral_tpu.core import mel as jmel  # noqa: E402
from spectral_tpu_torch.core import mel as tmel  # noqa: E402
from spectral_tpu_torch.ops import build, mel_cuda  # noqa: E402

FS = 16000.0
MEL_TOL = 1e-6

FILTERBANKS = [
    (128, 513, 16000.0, 0.0, None, False),
    (64, 257, 16000.0, 0.0, None, True),
    (40, 513, 22050.0, 300.0, 8000.0, False),
    (24, 129, 1000.0, 0.0, 200.0, True),
    (8, 257, 8000.0, 50.0, 4000.0, False),
    (600, 513, 16000.0, 0.0, None, False),    # rows with no weight
    (128, 4097, 48000.0, 20.0, 20000.0, True),
]


@pytest.mark.parametrize("args", FILTERBANKS,
                         ids=[f"{a[0]}x{a[1]}_{a[2]:g}_{'htk' if a[5] else 'slaney'}"
                              for a in FILTERBANKS])
def test_filterbank_copy_is_bitwise_the_original(args):
    n_mels, n_freqs, fs, fmin, fmax, htk = args
    for norm in (True, False):
        got = tmel.mel_filterbank(n_mels, n_freqs, fs, fmin, fmax, htk, norm)
        want = jmel.mel_filterbank(n_mels, n_freqs, fs, fmin, fmax, htk, norm)
        assert got.dtype == np.float64 and np.array_equal(got, want)
    assert np.array_equal(tmel.mel_centers(n_mels, fs, fmin, fmax, htk),
                          jmel.mel_centers(n_mels, fs, fmin, fmax, htk))


@pytest.mark.parametrize("htk", [False, True])
def test_hz_mel_maps_are_bitwise_the_originals(htk):
    f = np.concatenate([np.linspace(0.0, 24000.0, 997), [999.999, 1000.0,
                                                          1000.001]])
    assert np.array_equal(tmel.hz_to_mel(f, htk), jmel.hz_to_mel(f, htk))
    m = tmel.hz_to_mel(f, htk)
    assert np.array_equal(tmel.mel_to_hz(m, htk), jmel.mel_to_hz(m, htk))
    assert np.array_equal(tmel.hz_to_mel(440.0, htk),
                          jmel.hz_to_mel(440.0, htk))


@pytest.mark.parametrize("bad", [dict(fmin=-1.0), dict(fmin=500.0, fmax=400.0),
                                 dict(fmax=9000.0)])
def test_filterbank_refuses_like_the_original(bad):
    with pytest.raises(ValueError) as want:
        jmel.mel_filterbank.__wrapped__(16, 257, FS, **bad)
    with pytest.raises(ValueError, match=str(want.value).replace(
            "(", r"\(").replace(")", r"\)")):
        tmel.mel_filterbank.__wrapped__(16, 257, FS, **bad)


def _psd(seed, shape, F):
    return np.random.RandomState(seed).exponential(1e-3, shape + (F,)) \
        .astype(np.float32)


def _inject(psd, fb):
    """An inf bin inside the widest triangle (frame 0, 1), an inf bin at
    Nyquist, where no filter has weight (frame 0, 2), a NaN bin (frame 1,
    0) and a silent frame (frame 1, 3)."""
    m = int(np.argmax((fb > 0).sum(axis=1)))
    nz = np.flatnonzero(fb[m])
    psd[0, 1, nz[len(nz) // 2]] = np.inf
    psd[0, 2, -1] = np.inf
    psd[1, 0, 7] = np.nan
    psd[1, 3] = 0.0
    return m


@pytest.mark.parametrize("n_mels,F,htk", [(128, 513, False), (32, 129, True),
                                          (600, 513, False)])
def test_apply_mel_matches_jax_nan_and_inf_included(n_mels, F, htk):
    fb = tmel.mel_filterbank(n_mels, F, FS, 0.0, None, htk)
    psd = _psd(0, (2, 9), F)
    m = _inject(psd, fb)
    got = tmel.apply_mel(torch.from_numpy(psd), fb).numpy()
    want = np.asarray(jmel.apply_mel(jnp.asarray(psd), fb))
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    assert np.isinf(got[0, 1, m]) and np.isnan(got[0, 1]).any()
    # the Nyquist bin: NaN but in a row with weight there (a rounding
    # tail of the last triangle, at HTK), which it makes inf
    assert np.array_equal(np.isnan(got[0, 2]), fb[:, -1] == 0)
    assert np.isnan(got[1, 0]).all()
    assert (got[1, 3] == 0).all()
    ok = np.isfinite(want)
    scale = np.abs(want[ok]).max()
    assert np.abs(got[ok] - want[ok]).max() <= MEL_TOL * scale


def test_mel_spectrogram_matches_jax():
    psd = _psd(1, (3, 11), 257)
    for kw in (dict(), dict(fmin=100.0, fmax=6000.0, htk=True)):
        got = tmel.mel_spectrogram(torch.from_numpy(psd), FS, 40, **kw)
        want = np.asarray(jmel.mel_spectrogram(jnp.asarray(psd), FS, 40,
                                               **kw))
        assert got.shape == want.shape == (3, 11, 40)
        assert np.abs(got.numpy() - want).max() <= MEL_TOL * want.max()


@pytest.mark.parametrize("args", FILTERBANKS[:6],
                         ids=[f"{a[0]}x{a[1]}" for a in FILTERBANKS[:6]])
def test_span_table_holds_every_weight(args):
    """Each row's span, first to last nonzero weight, scattered back gives
    the filterbank bitwise; a row with no weight has length 0."""
    fb = tmel.mel_filterbank(*args)
    start, length, offset, weights = mel_cuda.span_table(fb)
    back = np.zeros_like(fb)
    for m in range(len(fb)):
        back[m, start[m]:start[m] + length[m]] = \
            weights[offset[m]:offset[m] + length[m]]
        assert (length[m] == 0) == (not fb[m].any())
    assert np.array_equal(back, fb)
    assert start.dtype == length.dtype == offset.dtype == np.int32
    assert length.max() < fb.shape[1]


def _kernel_model(psd, fb):
    """csrc/mel.cu's arithmetic in numpy: each frame's first and last
    non-finite bin; each mel row's span summed in float64 from its first
    bin, rounded once to float32; NaN where a non-finite bin lies outside
    the span; the partials the row's NaN-propagating min and max."""
    start, length, offset, weights = mel_cuda.span_table(fb)
    rows = psd.reshape(-1, psd.shape[-1]).astype(np.float64)
    out = np.empty((len(rows), len(fb)), np.float32)
    for r, p in enumerate(rows):
        bad = np.flatnonzero(~np.isfinite(p))
        first = bad[0] if bad.size else len(p)
        last = bad[-1] if bad.size else -1
        for m in range(len(fb)):
            s, n = start[m], length[m]
            acc = 0.0
            w = weights[offset[m]:offset[m] + n]
            with np.errstate(invalid="ignore"):
                for k in range(n):
                    acc = w[k] * p[s + k] + acc
            if first < s or last >= s + n:
                acc = np.nan
            out[r, m] = acc
    mel = out.reshape(psd.shape[:-1] + (len(fb),))
    return mel, np.stack([mel.min(axis=-1), mel.max(axis=-1)])[:, None]


def _ulps(a, b):
    def ordered(t):
        i = t.astype(np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    ok = np.isfinite(a) & np.isfinite(b)
    return int(np.abs(ordered(a) - ordered(b))[ok].max()) if ok.any() else 0


@pytest.mark.parametrize("n_mels,F,band", [(128, 513, None), (40, 257, (5, 33)),
                                           (600, 513, None), (8, 129, (2, 7))])
def test_kernel_model_matches_the_plain_version(n_mels, F, band):
    """The kernel's span sums and its non-finite rule give the dense
    product's answer: NaN and inf in the same places, the rest within one
    float32 ulp (on the card chip_smoke.py holds the kernel to the same)."""
    fb = tmel.mel_filterbank(n_mels, F, FS)
    if band is not None:
        fb = fb[band[0]:band[1]]
    psd = _psd(2, (2, 5), F)
    _inject(psd, fb)
    model, model_parts = _kernel_model(psd, fb)
    spans = mel_cuda.mel_spans(fb, "cpu")
    plain, parts = mel_cuda.mel_project(torch.from_numpy(psd), spans)
    plain, parts = plain.numpy(), parts.numpy()
    for a, b in ((model, plain), (model_parts, parts)):
        assert a.shape == b.shape
        assert np.array_equal(np.isnan(a), np.isnan(b))
        assert np.array_equal(np.isinf(a), np.isinf(b))
        assert _ulps(a, b) <= 1


def test_mel_project_plain_version_and_zero_frames():
    fb = tmel.mel_filterbank(16, 65, FS)[3:12]
    spans = mel_cuda.mel_spans(fb, "cpu")
    assert spans.rows.dtype == torch.float64 and spans.rows.shape == (9, 65)
    psd = torch.from_numpy(_psd(3, (2, 4), 65))
    mel, parts = mel_cuda.mel_project(psd, spans)
    assert torch.equal(mel, tmel.apply_mel(psd, fb))
    assert torch.equal(parts[0, 0], mel.amin(dim=-1))
    assert torch.equal(parts[1, 0], mel.amax(dim=-1))
    empty, parts0 = mel_cuda.mel_project(psd[:, :0], spans)
    assert empty.shape == (2, 0, 9) and parts0.shape == (2, 1, 2, 0)
    assert mel_cuda.launches == {"mel": 0}


def test_mel_kernel_failure_propagates(monkeypatch):
    """A tensor off the CPU (meta stands in for the card) takes the kernel;
    a kernel that cannot be built raises, and the plain version never
    runs."""
    def broken(name):
        raise RuntimeError(f"cannot build {name}")

    def plain(*a, **k):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(build, "load_library", broken)
    monkeypatch.setattr(mel_cuda, "_LIB", [])
    monkeypatch.setattr(mel_cuda, "mel_project_reference", plain)
    spans = mel_cuda.mel_spans(tmel.mel_filterbank(8, 65, FS), "meta")
    with pytest.raises(RuntimeError, match="cannot build mel"):
        mel_cuda.mel_project(torch.empty((2, 3, 65), device="meta"), spans)
