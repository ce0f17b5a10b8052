"""The port's own host modules held against the JAX package's: SpecConfig
(spectral_tpu_torch.config), the windows (core/windows.py), the colormap
tables (render/lut.py), the PNG encoders (render/png.py), the WAV reader
(io/wav.py), the sklearn-exact k-means (models/kmeans.py) and the GUI's
controllers (gui/controller.py, a byte copy). All of them
are exact: fields, JSON, window samples, LUT bytes, decoded pixels and
k-means centres, labels and inertia compare equal, never within a
tolerance.
"""

import dataclasses
import json
import os
import struct

import numpy as np
import pytest

from spectral_tpu import config as jconfig
from spectral_tpu.core import windows as jwin
from spectral_tpu.gui import controller as jcontroller
from spectral_tpu.io import wav as jwav
from spectral_tpu.models import kmeans as jkmeans
from spectral_tpu.render import lut as jlut
from spectral_tpu.render import png as jpng
from spectral_tpu_torch import config as tconfig
from spectral_tpu_torch.core import windows as twin
from spectral_tpu_torch.gui import controller as tcontroller
from spectral_tpu_torch.io import wav as twav
from spectral_tpu_torch.models import kmeans as tkmeans
from spectral_tpu_torch.render import lut as tlut
from spectral_tpu_torch.render import png as tpng

CONFIGS = [
    lambda m: m.SpecConfig(),
    lambda m: m.SpecConfig.scipy_default(8192, log_scale=True),
    lambda m: m.SpecConfig.north_star(1024, 256, log_scale=True),
    lambda m: m.SpecConfig.scipy_default(256, fmin=0.0, fmax=30.0),
    lambda m: m.SpecConfig(nperseg=512, hop=100, nfft=1024,
                           window=("kaiser", 14.0), detrend="linear",
                           scaling="spectrum", mode="magnitude",
                           center=True, pad_mode="constant", n_mels=64,
                           mel_fmin=20.0, mel_fmax=4000.0, mel_htk=True,
                           precision="fast"),
]


def test_spec_config_fields_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.SpecConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.SpecConfig)]
    assert tf == jf


@pytest.mark.parametrize("make", CONFIGS)
def test_spec_config_json_round_trip_across_packages(make):
    t, j = make(tconfig), make(jconfig)
    assert t.to_json() == j.to_json()
    assert tconfig.SpecConfig.from_json(j.to_json()) == t
    assert jconfig.SpecConfig.from_json(t.to_json()) == j
    for prop in ("hop_", "nfft_", "n_freqs", "noverlap_"):
        assert getattr(t, prop) == getattr(j, prop)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("bad", [dict(detrend="median"), dict(scaling="x"),
                                 dict(mode="power"), dict(nperseg=0),
                                 dict(precision="quick"), dict(window="nope"),
                                 dict(window=("kaiser", None)), dict(hop=0),
                                 dict(nperseg=256, nfft=128), dict(n_mels=0),
                                 dict(n_mels=8, mel_fmin=100.0,
                                      mel_fmax=50.0)])
def test_spec_config_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError) as want:
        jconfig.SpecConfig(**bad)
    with pytest.raises(ValueError) as got:
        tconfig.SpecConfig(**bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("window", ["hann", "hamming", "blackman", "bartlett",
                                    "boxcar", "blackmanharris", "nuttall",
                                    "flattop", ("tukey", 0.25), "tukey:0.5",
                                    ("tukey", 0.0), ("tukey", 1.0),
                                    ("kaiser", 14.0)])
@pytest.mark.parametrize("M", [1, 2, 7, 256, 8192])
def test_windows_bitwise_equal(window, M):
    for periodic in (True, False):
        assert np.array_equal(twin.get_window(window, M, periodic),
                              jwin.get_window(window, M, periodic))


@pytest.mark.parametrize("name", ["jet", "gray", "hot"])
def test_lut_bytes_identical(name):
    assert tlut.available_colormaps() == jlut.available_colormaps()
    assert tlut.get_lut(name).tobytes() == jlut.get_lut(name).tobytes()
    assert tlut.get_lut(name, 64).tobytes() == jlut.get_lut(name,
                                                            64).tobytes()
    assert tlut.get_lut_f32(name).tobytes() == jlut.get_lut_f32(
        name).tobytes()
    with pytest.raises(ValueError):
        tlut.get_lut("viridis")


def _rgba(seed, h=33, w=47):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 4), np.uint8)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_rgba_decodes_to_the_same_pixels(channels, tmp_path):
    pytest.importorskip("PIL")
    arr = _rgba(0)[..., :channels]
    arr = arr[..., 0] if channels == 1 else arr
    for name, enc in (("port", tpng.encode_png), ("jax", jpng.encode_png)):
        enc(arr, str(tmp_path / f"{name}.png"), 3)
    got = tpng.decode_png(str(tmp_path / "port.png"))
    assert np.array_equal(got, jpng.decode_png(str(tmp_path / "jax.png")))
    assert np.array_equal(got, arr)
    # the stdlib encoders are the same code: the same bytes
    assert tpng.encode_png_pure(arr, 3) == jpng.encode_png_pure(arr, 3)
    assert np.array_equal(tpng.decode_png(tpng.encode_png_pure(arr)), arr)


def test_png_palette_decodes_to_the_same_pixels(tmp_path):
    pytest.importorskip("PIL")
    idx = np.random.RandomState(1).randint(0, 256, (40, 29)).astype(np.uint8)
    pal = tlut.get_lut("jet")
    tpng.encode_png_palette(idx, pal, str(tmp_path / "port.png"), 3,
                            fsync=True)
    jpng.encode_png_palette(idx, jlut.get_lut("jet"),
                            str(tmp_path / "jax.png"), 3)
    got = tpng.decode_png(str(tmp_path / "port.png"))
    assert np.array_equal(got, jpng.decode_png(str(tmp_path / "jax.png")))
    assert np.array_equal(got, pal[idx])
    pure = tpng._encode_png_palette_pure(idx, pal, 3)
    assert pure == jpng._encode_png_palette_pure(idx, pal, 3)
    assert np.array_equal(tpng.decode_png(pure), pal[idx])
    with pytest.raises(ValueError, match="PLTE"):
        tpng.encode_png_palette(idx, np.zeros((300, 3), np.uint8))
    with pytest.raises(TypeError):
        tpng.encode_png(idx.astype(np.float32))


def test_stale_tmp_sweep_like_jax(tmp_path):
    """Temps of a dead pid go; this process's, foreign names and finished
    files stay, in both packages."""
    import subprocess
    import sys
    dead = subprocess.run([sys.executable, "-c", "import os; print("
                           "os.getpid())"], capture_output=True,
                          text=True).stdout.strip()
    for mod, sub in ((tpng, "port"), (jpng, "jax")):
        d = tmp_path / sub
        d.mkdir()
        names = [f"a.png.tmp.{dead}.0", f"b.png.tmp.{os.getpid()}.1",
                 "c.png", "d.png.tmp.x.2", "e.png.tmp.١٢.3"]
        for n in names:
            (d / n).write_bytes(b"x")
        assert mod.clean_stale_tmp(str(d)) == 1
        assert sorted(p.name for p in d.iterdir()) == sorted(names[1:])
    assert tpng.clean_stale_tmp(str(tmp_path / "missing")) == 0


def _float_wav(path, x, fs):
    payload = np.asarray(x, "<f4").tobytes()
    with open(path, "wb") as fh:
        fh.write(struct.pack("<4sI4s", b"RIFF", 36 + len(payload), b"WAVE"))
        fh.write(struct.pack("<4sIHHIIHH", b"fmt ", 16, 3, 1, int(fs),
                             int(fs) * 4, 4, 32))
        fh.write(struct.pack("<4sI", b"data", len(payload)))
        fh.write(payload)


def test_wav_reader_matches_jax(tmp_path):
    rs = np.random.RandomState(2)
    mono, stereo, flt = (str(tmp_path / n) for n in ("m.wav", "s.wav",
                                                     "f.wav"))
    twav.write_wav(mono, 0.5 * rs.randn(3000).clip(-1, 1), 8000.0)
    jwav.write_wav(stereo, 0.3 * rs.randn(2000, 2).clip(-1, 1), 16000.0)
    _float_wav(flt, rs.randn(1000), 22050.0)
    for path in (mono, stereo, flt):
        for fn in ("read_wav", "wav_info"):
            got, want = getattr(twav, fn)(path), getattr(jwav, fn)(path)
            assert json.dumps(np.asarray(got[0]).tolist()) == json.dumps(
                np.asarray(want[0]).tolist())
            assert got[1:] == want[1:]
    x, fs = twav.read_wav_int16(mono)
    assert x.dtype == np.dtype("<i2") and fs == 8000.0
    assert np.array_equal(x, jwav.read_wav_int16(mono)[0])
    assert np.array_equal(x / 32768.0, twav.read_wav(mono)[0])
    for bad in (flt, str(tmp_path / "missing.wav")):
        with pytest.raises((ValueError, OSError)):
            twav.read_wav_int16(bad)
    (tmp_path / "junk.wav").write_bytes(b"RIFX0000WAVE")
    with pytest.raises(ValueError, match="RIFF"):
        twav.read_wav(str(tmp_path / "junk.wav"))


def test_kmeans_copy_is_the_original_text():
    with open(jkmeans.__file__, "rb") as a, open(tkmeans.__file__, "rb") as b:
        assert a.read() == b.read()


def test_gui_controller_copy_is_the_original_text():
    with open(jcontroller.__file__, "rb") as a, open(tcontroller.__file__,
                                                     "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("trial", range(6))
def test_kmeans_copy_bit_exact_with_jax_and_sklearn(trial):
    """The copy against the JAX package's module and sklearn's KMeans
    bit for bit, inertia included, with sklearn's OpenMP pool at one
    thread: at its default the pool's threaded inertia sum moves in the
    last digits (ROADMAP queue 3), which decides nothing of the centres
    here; trial 5 is test_hmmlearn_parity.py's 9-feature case."""
    from sklearn.cluster import KMeans
    from threadpoolctl import threadpool_limits
    rng = np.random.RandomState(trial)
    if trial == 5:
        X = np.round(rng.randn(200, 9) * 50.0 + 1000.0, 1)
        k = 4
    else:
        X = rng.randn(int(rng.randint(40, 400)), int(rng.randint(1, 5)))
        X[: len(X) // 3] += 4.0 * (trial % 2)
        k = int(rng.choice([2, 3, 4, 5]))
    got = tkmeans.kmeans_fit(X, k, seed=42 + trial, n_init=10)
    want = jkmeans.kmeans_fit(X, k, seed=42 + trial, n_init=10)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with threadpool_limits(1):
        sk = KMeans(n_clusters=k, random_state=42 + trial, n_init=10).fit(X)
    np.testing.assert_array_equal(got[0], sk.cluster_centers_)
    np.testing.assert_array_equal(got[1], sk.labels_)
    assert got[2] == sk.inertia_
