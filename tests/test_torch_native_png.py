"""The port's native PNG encoder (spectral_tpu_torch/native) against the
JAX package's: the copied sources are the originals, the port builds its
own library under build/spectral_tpu_torch/ and never loads the JAX
package's, and both packages write the same PNG bytes for gray, RGB, RGBA
and palette images at every compress level tried. Exact throughout: bytes
compare equal, never within a tolerance.
"""

import ctypes
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spectral_tpu.native import build as jbuild  # noqa: E402
from spectral_tpu.native import png_native as jnative  # noqa: E402
from spectral_tpu.render import png as jpng  # noqa: E402
from spectral_tpu_torch.native import build as tbuild  # noqa: E402
from spectral_tpu_torch.native import png_native as tnative  # noqa: E402
from spectral_tpu_torch.ops import build as ops_build  # noqa: E402
from spectral_tpu_torch.render import png as tpng  # noqa: E402

NAME = "libspectpu_png.so"


def _text(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_sources_are_the_originals():
    jdir = os.path.dirname(jbuild.__file__)
    tdir = os.path.dirname(tbuild.__file__)
    assert _text(os.path.join(tdir, "png_encoder.cpp")) == _text(
        os.path.join(jdir, "png_encoder.cpp"))
    assert _text(tnative.__file__) == _text(jnative.__file__).replace(
        b"from spectral_tpu.native", b"from spectral_tpu_torch.native")
    assert tbuild.TARGETS == jbuild.TARGETS


def test_library_lives_in_the_ports_build_dir():
    if not (tnative.available() and jnative.available()):
        pytest.skip("no C++ toolchain with zlib here")
    path = tbuild.lib_path(NAME)
    assert os.path.dirname(path) == str(ops_build.BUILD_DIR)
    assert os.path.basename(path).startswith("libspectpu_png_")
    assert os.path.isfile(path)
    assert os.path.realpath(path) != os.path.realpath(jbuild.lib_path(NAME))
    # the loaded library is the port's file, not the JAX package's
    assert tnative._load()._name == path
    assert jnative._load()._name != path


def _images(seed):
    rs = np.random.RandomState(seed)
    smooth = np.add.outer(np.arange(37), np.arange(53)) % 256
    return {
        "gray": rs.randint(0, 256, (29, 41)).astype(np.uint8),
        "rgb": np.stack([smooth, smooth[::-1], smooth // 2],
                        -1).astype(np.uint8),
        "rgba": rs.randint(0, 256, (300, 400, 4)).astype(np.uint8),
        "indices": rs.randint(0, 256, (40, 29)).astype(np.uint8),
    }


@pytest.mark.parametrize("level", [0, 1, 4, 6])
def test_png_bytes_equal_the_jax_packages(level):
    """Byte-identical PNGs wherever both packages have the native encoder
    (the 300 x 400 RGBA image was 480,513 bytes through the JAX package
    and 480,980 through the port before the port had the encoder)."""
    if not (tnative.available() and jnative.available()):
        pytest.skip("no C++ toolchain with zlib here")
    imgs = _images(level)
    for key in ("gray", "rgb", "rgba"):
        got = tpng.encode_png(imgs[key], compress_level=level)
        assert got == jpng.encode_png(imgs[key], compress_level=level), key
        assert np.array_equal(tpng.decode_png(got).reshape(
            imgs[key].shape), imgs[key])
    from spectral_tpu_torch.render.lut import get_lut
    pal = get_lut("jet")
    got = tpng.encode_png_palette(imgs["indices"], pal, compress_level=level)
    assert got == jpng.encode_png_palette(imgs["indices"], pal,
                                          compress_level=level)
    assert np.array_equal(tpng.decode_png(got), pal[imgs["indices"]])


def test_stdlib_bytes_are_not_the_native_bytes_at_level_0():
    """Why the native encoder stays ahead of the stdlib one: at compress
    level 0 zlib sizes each stored block by the output space it is given,
    and the stdlib's growing output buffer cuts the blocks elsewhere than
    the native encoder's one deflateBound buffer. Same pixels, other bytes;
    the port's encode_png gives the JAX package's."""
    if not (tnative.available() and jnative.available()):
        pytest.skip("no C++ toolchain with zlib here")
    rgba = _images(0)["rgba"]
    idx = _images(0)["indices"]
    pal = np.random.RandomState(1).randint(0, 256, (256, 3)).astype(np.uint8)
    big = np.tile(idx, (50, 100))
    for ours, stdlib, theirs in (
            (tpng.encode_png(rgba, compress_level=0),
             tpng.encode_png_pure(rgba, 0),
             jpng.encode_png(rgba, compress_level=0)),
            (tpng.encode_png_palette(big, pal, compress_level=0),
             tpng._encode_png_palette_pure(big, pal, 0),
             jpng.encode_png_palette(big, pal, compress_level=0))):
        assert ours == theirs and stdlib != ours
        assert np.array_equal(tpng.decode_png(stdlib), tpng.decode_png(ours))


@pytest.fixture
def fresh_binding(monkeypatch):
    """Each test re-resolves the lazy binding and the backend choice."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_load_attempted", False)
    monkeypatch.setattr(tpng, "_native", None)
    monkeypatch.setattr(tpng, "_native_checked", False)
    return tnative


def test_build_failure_means_unavailable(fresh_binding, monkeypatch):
    monkeypatch.setattr(tnative._build, "build", lambda name: False)
    assert tnative.available() is False
    with pytest.raises(RuntimeError, match="unavailable"):
        tnative.encode(np.zeros((2, 2, 4), np.uint8))
    with pytest.raises(RuntimeError, match="unavailable"):
        tnative.encode_palette(np.zeros((2, 2), np.uint8),
                               np.zeros((4, 3), np.uint8))
    assert tpng._get_native() is None


def test_cdll_load_failure_means_unavailable(fresh_binding, monkeypatch):
    monkeypatch.setattr(tnative._build, "build", lambda name: True)

    def no_dlopen(path):
        raise OSError("not a shared object")
    monkeypatch.setattr(ctypes, "CDLL", no_dlopen)
    assert tnative.available() is False
    assert tnative._load_attempted is True and tnative._lib is None


def test_failed_compile_leaves_nothing(monkeypatch, tmp_path, capsys):
    """A compiler that fails leaves no library and no temp file, reports
    its message under verbose, and the build says False."""
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path)
    fake = tmp_path / "bin"
    fake.mkdir()
    gxx = fake / "g++"
    gxx.write_text("#!/bin/sh\necho 'zlib.h: No such file' >&2\nexit 1\n")
    gxx.chmod(0o755)
    monkeypatch.setenv("PATH", f"{fake}{os.pathsep}{os.environ['PATH']}")
    assert tbuild.build(NAME, verbose=True) is False
    assert "zlib.h: No such file" in capsys.readouterr().err
    assert list(tmp_path.iterdir()) == [fake]


def test_backend_order_is_the_originals(fresh_binding, monkeypatch):
    """native first, then PIL, then the stdlib encoder, as
    spectral_tpu/render/png.py orders them (tests/test_render.py's
    fallback test on the port's copy); each tier decodes to the same
    pixels."""
    pytest.importorskip("PIL")
    if not tnative.available():
        pytest.skip("no C++ toolchain with zlib here")
    rng = np.random.default_rng(3)
    arrs = (rng.integers(0, 256, (5, 7), np.uint8),
            rng.integers(0, 256, (5, 7, 3), np.uint8),
            rng.integers(0, 256, (5, 7, 4), np.uint8))
    idx = rng.integers(0, 256, (6, 9), np.uint8)
    pal = rng.integers(0, 256, (256, 3), np.uint8)

    def all_encoded():
        return ([tpng.encode_png(a) for a in arrs]
                + [tpng.encode_png_palette(idx, pal)])

    assert tpng._get_native() is tnative
    native = all_encoded()
    assert native == [tnative.encode(tpng._normalize_array(a), 6)
                      for a in arrs] + [tnative.encode_palette(idx, pal, 6)]
    monkeypatch.setattr(tpng, "_get_native", lambda: None)
    pil = all_encoded()
    real_import = __import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("forced for the fallback test")
        return real_import(name, *a, **k)
    monkeypatch.setattr("builtins.__import__", no_pil)
    pure = all_encoded()
    monkeypatch.setattr("builtins.__import__", real_import)
    assert pure[:3] == [tpng.encode_png_pure(a) for a in arrs]
    assert pure[3] == tpng._encode_png_palette_pure(idx, pal)
    for nat, p, q in zip(native, pil, pure):
        assert np.array_equal(tpng.decode_png(nat), tpng.decode_png(p))
        assert np.array_equal(tpng.decode_png(nat), tpng.decode_png(q))
