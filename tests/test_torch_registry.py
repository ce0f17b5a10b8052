"""The port's registry sources and the pieces around them, held to the JAX
package's: the copies of io/registry.py, io/abf.py, io/nix.py, io/wav.py
and render/figure.py are the originals' text with the package name
changed; the same WAV, NPZ, ABF and NIX files register equal SweepEntrys
in both packages; registry_first_fs and registry_clip_source give the
same rates and clips; apply_colormap and apply_colormap_rgba give the same
bytes at every one of the 256 levels, NaN and the flips; ViewSettings has
the same fields and defaults; the torch waveform raster gives JAX's masks
and bytes. All exact: nothing here compares within a tolerance.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spectral_tpu import config as jconfig  # noqa: E402
from spectral_tpu.io import abf as jabf  # noqa: E402
from spectral_tpu.io import nix as jnix  # noqa: E402
from spectral_tpu.io import registry as jreg  # noqa: E402
from spectral_tpu.io import wav as jwav  # noqa: E402
from spectral_tpu.ops import colormap as jcmap  # noqa: E402
from spectral_tpu.parallel import pipeline as jpipe  # noqa: E402
from spectral_tpu.render import figure as jfigure  # noqa: E402
from spectral_tpu.render import waveform as jwave  # noqa: E402
from spectral_tpu_torch import config as tconfig  # noqa: E402
from spectral_tpu_torch.io import abf as tabf  # noqa: E402
from spectral_tpu_torch.io import nix as tnix  # noqa: E402
from spectral_tpu_torch.io import registry as treg  # noqa: E402
from spectral_tpu_torch.io import wav as twav  # noqa: E402
from spectral_tpu_torch.ops import colormap as tcmap  # noqa: E402
from spectral_tpu_torch.parallel import pipeline as tpipe  # noqa: E402
from spectral_tpu_torch.render import figure as tfigure  # noqa: E402
from spectral_tpu_torch.render import waveform as twave  # noqa: E402


def _text(module):
    with open(module.__file__, encoding="utf-8") as fh:
        return fh.read()


@pytest.mark.parametrize("pair", [(jreg, treg), (jabf, tabf), (jnix, tnix),
                                  (jwav, twav), (jfigure, tfigure)],
                         ids=["registry", "abf", "nix", "wav", "figure"])
def test_copies_are_the_originals_text(pair):
    j, t = pair
    want = _text(j).replace("from spectral_tpu.io",
                            "from spectral_tpu_torch.io")
    assert _text(t) == want
    assert "spectral_tpu." not in _text(t).replace("spectral_tpu_torch.", "")


def test_view_settings_fields_and_defaults():
    jf = [(f.name, f.default) for f in dataclasses.fields(
        jconfig.ViewSettings)]
    tf = [(f.name, f.default) for f in dataclasses.fields(
        tconfig.ViewSettings)]
    assert tf == jf
    assert dataclasses.asdict(tconfig.ViewSettings(combine=True)) == \
        dataclasses.asdict(jconfig.ViewSettings(combine=True))


def _entries(reg):
    out = {}
    for name, e in reg.data.items():
        d = dataclasses.asdict(e)
        for k in ("raw", "processed"):
            a = d[k]
            d[k] = None if a is None else (a.dtype.str, a.shape, a.tobytes())
        out[name] = d
    return out


def _files(tmp_path):
    """One recording of each registry format, written by the JAX
    package's fixture writers from seeded data."""
    rs = np.random.RandomState(5)
    paths = []
    p = str(tmp_path / "mono.wav")
    jwav.write_wav(p, 0.4 * rs.randn(3000).clip(-2, 2) / 2, 8000.0)
    paths.append(p)
    p = str(tmp_path / "stereo.wav")
    jwav.write_wav(p, 0.3 * rs.randn(1500, 2).clip(-3, 3) / 3, 8000.0)
    paths.append(p)
    p = str(tmp_path / "arr.npz")
    np.savez(p, raw=rs.randn(3, 700).astype(np.float32),
             processed=rs.randn(3, 700), fs=np.float64(8000.0))
    paths.append(p)
    p = str(tmp_path / "rec.abf")
    jabf.write_abf2_fixture(p, rs.randn(4, 900) * 0.5, 8000.0)
    paths.append(p)
    p = str(tmp_path / "two.abf")
    jabf.write_abf2_fixture(p, rs.randn(2, 600), 8000.0, n_channels=2)
    paths.append(p)
    pytest.importorskip("h5py")
    p = str(tmp_path / "nixrec.h5")
    jnix.write_nix_fixture(p, [
        {"raw_ch0": rs.randn(500), "proc_ch0": rs.randn(500)},
        {"only_raw": np.ones(300)},
        {"mystery": rs.randn(200)}], fs=8000.0)
    paths.append(p)
    return paths


def _signal(reg, name, processed):
    """get_signal's (bytes, fs), or the KeyError's text."""
    try:
        x, fs = reg.get_signal(name, processed)
    except KeyError as e:
        return str(e)
    return np.asarray(x).tobytes(), fs


def test_the_same_files_register_the_same_entries(tmp_path):
    paths = _files(tmp_path)
    # the port's writers give the JAX writers' bytes
    t_abf = str(tmp_path / "port.abf")
    tabf.write_abf2_fixture(t_abf, np.random.RandomState(5).randn(4, 900)
                            * 0.5, 8000.0)
    j_abf = str(tmp_path / "jax.abf")
    jabf.write_abf2_fixture(j_abf, np.random.RandomState(5).randn(4, 900)
                            * 0.5, 8000.0)
    with open(t_abf, "rb") as a, open(j_abf, "rb") as b:
        assert a.read() == b.read()
    jr, tr = jreg.SweepRegistry(), treg.SweepRegistry()
    for p in paths:
        assert tr.load_file(p) == jr.load_file(p)
    assert _entries(tr) == _entries(jr)
    for name in tr.names():
        for processed in (False, True):
            assert _signal(tr, name, processed) == _signal(jr, name,
                                                           processed)
    assert tr.register_combined(["rec_sweep0", "rec_sweep1"]) == \
        jr.register_combined(["rec_sweep0", "rec_sweep1"])
    assert _entries(tr) == _entries(jr)
    with pytest.raises(ValueError, match="Unsupported"):
        tr.load_file(str(tmp_path / "x.txt"))
    assert treg.split_display_name("a/rec_sweep12") == \
        jreg.split_display_name("a/rec_sweep12") == ("rec", "12")


def test_registry_pipeline_sources_match_jax(tmp_path):
    paths = _files(tmp_path)
    for p in paths:
        assert tpipe.registry_first_fs(p) == jpipe.registry_first_fs(p)
    got = list(tpipe.registry_clip_source(paths, 8000.0))
    want = list(jpipe.registry_clip_source(paths, 8000.0))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    # a second rate: raised or skipped alike
    other = str(tmp_path / "fast.wav")
    jwav.write_wav(other, np.zeros(100), 16000.0)
    with pytest.raises(ValueError, match="single-rate"):
        list(tpipe.registry_clip_source([other], 8000.0))
    assert list(tpipe.registry_clip_source(
        [other, str(tmp_path / "missing.wav")], 8000.0,
        on_error="skip")) == []


def _levels():
    """Every LUT level at its edge and its middle, both ends past [0, 1],
    and NaN."""
    k = np.arange(256, dtype=np.float32)
    v = np.concatenate([k / 256, (k + 0.5) / 256,
                        [0.0, 1.0, 1.0 - 2 ** -24, -0.5, 1.5, np.nan]])
    return v.astype(np.float32).reshape(2, -1)


@pytest.mark.parametrize("flip_rows", [False, True])
@pytest.mark.parametrize("name", ["jet", "hot", "gray"])
def test_apply_colormap_bytes_equal_jax(name, flip_rows):
    img = _levels()
    want = np.asarray(jcmap.apply_colormap(jnp.asarray(img), name=name,
                                           flip_rows=flip_rows))
    got = tcmap.apply_colormap(torch.from_numpy(img), name=name,
                               flip_rows=flip_rows)
    assert got.dtype == torch.uint8 and got.numpy().tobytes() == \
        want.tobytes() and got.shape == want.shape
    lut = jcmap.get_lut(name, 64)
    want = np.asarray(jcmap.apply_colormap(jnp.asarray(img), lut=lut))
    assert tcmap.apply_colormap(torch.from_numpy(img), lut=lut).numpy(
        ).tobytes() == want.tobytes()
    # with alpha: none, a 2-D mask and a mask with the channel axis
    a2 = np.linspace(0.0, 1.0, img.size, dtype=np.float32).reshape(img.shape)
    for alpha in (None, a2, a2[..., None]):
        want = np.asarray(jcmap.apply_colormap_rgba(
            jnp.asarray(img), None if alpha is None else jnp.asarray(alpha),
            name=name, flip_rows=flip_rows))
        got = tcmap.apply_colormap_rgba(
            torch.from_numpy(img),
            None if alpha is None else torch.from_numpy(alpha), name=name,
            flip_rows=flip_rows).numpy()
        assert got.shape == want.shape and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("case", range(3))
def test_waveform_masks_and_bytes_equal_jax(case):
    """The truncation at the requested window, NaN padding (empty columns
    stay empty), the per-signal y-limit over the whole signal, and a
    shared one. The alpha channel is the line mask."""
    rs = np.random.RandomState(case)
    n = int(rs.randint(50, 4000))
    x = (rs.randn(2, n) * [[1.0], [0.01]]).astype(np.float32)
    if case == 0:
        x[0, rs.randint(0, n)] = np.nan
    H, W = int(rs.randint(5, 90)), int(rs.randint(7, 250))
    y_limit = None if case == 1 else float(np.nanmax(np.abs(x)) * 1.5)
    nvis = (None, n // 3, 2 * n + 1)[case]
    want = np.asarray(jwave.waveform_rgba(jnp.asarray(x), H, W, y_limit,
                                          nvis, transparent=case != 2,
                                          color=(200, 10, 0)))
    got = twave.waveform_rgba(torch.from_numpy(x), H, W, y_limit, nvis,
                              transparent=case != 2, color=(200, 10, 0))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert got.numpy().tobytes() == want.tobytes()
    assert torch.equal(twave.waveform_image(torch.from_numpy(x), H, W,
                                            y_limit, nvis),
                       torch.from_numpy(want[..., 3] == 255)
                       if case != 2 else got[..., 0] == 200)
