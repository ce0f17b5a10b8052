"""The port's dataset export (spectral_tpu_torch.parallel.pipeline) on the
CPU, held against the JAX package's export_spectrograms on the same clips
and WAVs.

Tolerance: decoded pixels >= 99.9% identical and never more than one LUT
index apart. The JAX export's default route is XLA's dense matmul, which
sums in another order than the port's plain path, and a pixel near a 1/256
bin edge may cross it; everything else (which PNGs, their sizes, the
counts, resume, the NaN skip, int16 staging) is held exactly.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

from spectral_tpu import config as jconfig  # noqa: E402
from spectral_tpu.io import wav as jwav  # noqa: E402
from spectral_tpu.parallel import pipeline as jpipe  # noqa: E402
from spectral_tpu.render.lut import get_lut  # noqa: E402
from spectral_tpu_torch import SpecConfig  # noqa: E402
from spectral_tpu_torch.io.wav import write_wav  # noqa: E402
from spectral_tpu_torch.parallel import pipeline as tpipe  # noqa: E402

FS = 16000.0
N = 4096
CFG = SpecConfig.north_star(256, 64, log_scale=True)
SAME = 0.999


def _jax(cfg):
    return jconfig.SpecConfig.from_json(cfg.to_json())


def _clips(n_clips=5, seed=0):
    rs = np.random.RandomState(seed)
    return [(f"c{i}", rs.randn(N).astype(np.float32)) for i in range(n_clips)]


def _export_both(tmp_path, clips, cfg=CFG, **kw):
    dirs = {}
    stats = {}
    for name, fn, cfg in (("port", tpipe.export_spectrograms, cfg),
                          ("jax", jpipe.export_spectrograms, _jax(cfg))):
        d = str(tmp_path / name)
        extra = {"device": "cpu"} if name == "port" else {}
        stats[name] = fn(list(clips), FS, cfg, d, clip_samples=N, batch=2,
                         encode_workers=2, **extra, **kw)
        dirs[name] = d
    return dirs, stats


def _indices(path):
    """LUT index image of a PNG: palette PNGs carry it; RGBA PNGs map each
    pixel's colour back to its first LUT entry."""
    img = Image.open(path)
    if img.mode == "P":
        return np.asarray(img).astype(int)
    rgb = np.asarray(img)[..., :3]
    lut = get_lut("jet").astype(int)
    key = lambda a: (a[..., 0] << 16) | (a[..., 1] << 8) | a[..., 2]  # noqa
    first = {}
    for i, k in enumerate(key(lut).tolist()):
        first.setdefault(k, i)
    return np.vectorize(first.__getitem__)(key(rgb.astype(int)))


def _assert_same_pngs(dirs):
    names = sorted(os.listdir(dirs["jax"]))
    assert sorted(os.listdir(dirs["port"])) == names and names
    for name in names:
        a = _indices(os.path.join(dirs["port"], name))
        b = _indices(os.path.join(dirs["jax"], name))
        assert a.shape == b.shape
        assert (a == b).mean() >= SAME and np.abs(a - b).max() <= 1, name


def _counts(stats):
    return {k: getattr(stats, k) for k in (
        "clips", "batches", "pngs_written", "seconds_audio", "failed",
        "nonfinite", "skipped", "tmp_cleaned")}


@pytest.mark.parametrize("pixel_format", ["palette", "rgba", "rgb"])
def test_export_matches_jax(tmp_path, pixel_format):
    clips = _clips()
    clips.append(("short", clips[0][1][:3000]))      # zero-padded, 3000 real
    dirs, stats = _export_both(tmp_path, clips, pixel_format=pixel_format)
    _assert_same_pngs(dirs)
    assert _counts(stats["port"]) == _counts(stats["jax"])
    assert stats["port"].seconds_audio == (5 * N + 3000) / FS
    mode = {"palette": "P", "rgba": "RGBA", "rgb": "RGB"}[pixel_format]
    img = Image.open(os.path.join(dirs["port"], "c0.png"))
    assert img.mode == mode and img.size == (61, 129)
    if pixel_format == "palette":
        pal = np.asarray(img.getpalette(), np.uint8).reshape(-1, 3)
        assert np.array_equal(pal[:256], get_lut("jet"))
    assert set(stats["port"].breakdown()) == set(stats["jax"].breakdown())


def test_export_wavs_stage_int16_like_jax(tmp_path):
    """16-bit PCM WAVs stage as raw int16 and normalize on the device: the
    same PNGs as the float32 decode of the same files, and as JAX's."""
    wav_dir = tmp_path / "wav"
    wav_dir.mkdir()
    rs = np.random.RandomState(3)
    paths = []
    for i in range(3):
        p = str(wav_dir / f"w{i}.wav")
        write_wav(p, np.clip(0.3 * rs.randn(N), -1, 1), FS)
        paths.append(p)
    staged = list(tpipe.wav_clip_source(paths))
    assert [n for n, _ in staged] == ["w0", "w1", "w2"]
    assert all(x.dtype == np.int16 for _, x in staged)
    for (n, a), (m, b) in zip(staged, jpipe.wav_clip_source(paths)):
        assert n == m and np.array_equal(a, b)
    batches = list(tpipe._batched(iter(staged), 4, N))
    assert batches[0][2].dtype == np.int16 and batches[0][1] == [N] * 3
    dirs, stats = _export_both(tmp_path, staged)
    _assert_same_pngs(dirs)
    floats = [(n, jwav.read_wav(p)[0]) for n, p in zip(["w0", "w1", "w2"],
                                                       paths)]
    out = str(tmp_path / "float")
    tpipe.export_spectrograms(floats, FS, CFG, out, clip_samples=N,
                              batch=2, device="cpu")
    for name in os.listdir(out):
        a = Image.open(os.path.join(out, name))
        b = Image.open(os.path.join(dirs["port"], name))
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_batched_matches_jax():
    rs = np.random.RandomState(4)
    clips = [("a", rs.randn(100).astype(np.float32)),
             ("b", (rs.randn(300) * 1000).astype(np.int16)),
             ("c", rs.randn(500)), ("d", (rs.randn(50) * 10).astype(np.int16))]
    for b in (1, 3, 4):
        got = list(tpipe._batched(iter(clips), b, 200))
        want = list(jpipe._batched(iter(clips), b, 200))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g[0] == w[0] and g[1] == w[1]
            assert g[2].dtype == w[2].dtype and np.array_equal(g[2], w[2])


def test_nan_clip_skips_or_raises_like_jax(tmp_path):
    clips = _clips(3)
    clips[1][1][100] = np.nan
    dirs, stats = _export_both(tmp_path, clips, on_error="skip")
    assert sorted(os.listdir(dirs["port"])) == ["c0.png", "c2.png"]
    assert stats["port"].nonfinite == stats["port"].failed == 1
    assert _counts(stats["port"]) == _counts(stats["jax"])
    msgs = []
    for fn, cfg, extra in ((jpipe.export_spectrograms, _jax(CFG), {}),
                           (tpipe.export_spectrograms, CFG,
                            {"device": "cpu"})):
        with pytest.raises(ValueError) as err:
            fn(clips, FS, cfg, str(tmp_path / "raise"), clip_samples=N,
               batch=2, **extra)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "'c1'" in msgs[1]


def test_resume_atomic_and_stale_tmp(tmp_path):
    out = tmp_path / "out"
    clips = _clips(4)
    first = tpipe.export_spectrograms(clips, FS, CFG, str(out),
                                      clip_samples=N, batch=3, device="cpu",
                                      durable=True)
    assert first.pngs_written == 4 and first.skipped == 0
    before = {p.name: p.read_bytes() for p in out.iterdir()}
    (out / "c2.png").unlink()
    (out / "c9.png.tmp.999999999.0").write_bytes(b"stale")
    again = tpipe.export_spectrograms(clips, FS, CFG, str(out),
                                      clip_samples=N, batch=3, device="cpu",
                                      resume=True)
    assert (again.pngs_written, again.skipped, again.tmp_cleaned,
            again.clips) == (1, 3, 1, 1)
    assert {p.name: p.read_bytes() for p in out.iterdir()} == before


def test_process_pool_and_errors(tmp_path):
    out = str(tmp_path / "p")
    stats = tpipe.export_spectrograms(_clips(2), FS, CFG, out, clip_samples=N,
                                      batch=2, device="cpu",
                                      encode_executor="process",
                                      encode_workers=1, pixel_format="rgba")
    assert stats.pngs_written == 2 and sorted(os.listdir(out)) == [
        "c0.png", "c1.png"]
    # an unwritable output path fails the clip, not the export, under skip
    (tmp_path / "q").mkdir()
    (tmp_path / "q" / "c0.png").mkdir()
    skip = tpipe.export_spectrograms(_clips(2), FS, CFG, str(tmp_path / "q"),
                                     clip_samples=N, batch=2, device="cpu",
                                     on_error="skip")
    assert (skip.pngs_written, skip.failed, skip.nonfinite) == (1, 1, 0)
    for bad in (dict(pixel_format="jpeg"), dict(on_error="ignore"),
                dict(encode_executor="gpu"), dict(encode_workers=0),
                dict(prefetch=-1)):
        with pytest.raises(ValueError):
            tpipe.export_spectrograms(_clips(1), FS, CFG, out,
                                      clip_samples=N, device="cpu", **bad)


def test_configs_the_kernels_cannot_compute_raise(tmp_path):
    """A transform past 32,768 raises before anything is written (one past
    8192, [large-nperseg], exports: test_torch_large_nperseg.py holds its
    PNGs to JAX's); the mel
    and band configs that [band-mel] refused now export (their PNGs are
    held to JAX's in test_export_band_and_mel_match_jax), and so do nfft >
    nperseg (held to JAX's in tests/test_torch_nfft.py) and, since
    [ext-modes], centered and magnitude configs (held to JAX's in
    tests/test_torch_ext_modes.py)."""
    for cfg, item in ((SpecConfig.scipy_default(65536),
                       r"\[large-nperseg\]"),):
        with pytest.raises(NotImplementedError, match=item):
            tpipe.export_spectrograms(_clips(1), FS, cfg, str(tmp_path),
                                      clip_samples=N, device="cpu")
    assert list(tmp_path.iterdir()) == []
    for name, cfg in (("mel", SpecConfig.north_star(256, 64, n_mels=16)),
                      ("band", SpecConfig.scipy_default(256, fmin=0.0,
                                                        fmax=50.0)),
                      ("nfft", SpecConfig(nperseg=256, hop=64, nfft=512)),
                      ("center", SpecConfig.north_star(256, 64,
                                                       center=True)),
                      ("magnitude", SpecConfig.north_star(
                          256, 64, mode="magnitude"))):
        stats = tpipe.export_spectrograms(_clips(1), FS, cfg,
                                          str(tmp_path / name),
                                          clip_samples=N, device="cpu")
        assert stats.pngs_written == 1


def test_fast_precision_runs_at_the_contract(tmp_path):
    import dataclasses
    out = {}
    for precision in ("accurate", "fast"):
        cfg = dataclasses.replace(CFG, precision=precision)
        d = tmp_path / precision
        tpipe.export_spectrograms(_clips(2), FS, cfg, str(d), clip_samples=N,
                                  batch=2, device="cpu")
        out[precision] = {p.name: p.read_bytes() for p in d.iterdir()}
    assert out["fast"] == out["accurate"]


def test_wav_source_skips_like_jax(tmp_path):
    good = str(tmp_path / "g.wav")
    write_wav(good, np.zeros(100), FS)
    stereo = str(tmp_path / "s.wav")
    write_wav(stereo, np.full((100, 2), 0.25), FS)
    junk = str(tmp_path / "j.wav")
    with open(junk, "wb") as fh:
        fh.write(b"not a wav")
    paths = [good, junk, stereo]
    got = list(tpipe.wav_clip_source(paths, on_error="skip"))
    want = list(jpipe.wav_clip_source(paths, on_error="skip"))
    assert [n for n, _ in got] == [n for n, _ in want] == ["g", "s"]
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError):
        list(tpipe.wav_clip_source(paths))
    (tmp_path / "out").mkdir()
    (tmp_path / "out" / "g.png").write_bytes(b"done")
    assert [n for n, _ in tpipe.wav_clip_source(
        [good, stereo], skip_existing_in=str(tmp_path / "out"))] == ["s"]


@pytest.mark.parametrize("pixel_format", ["palette", "rgba"])
@pytest.mark.parametrize("kind,cfg,height", [
    ("band", SpecConfig.north_star(256, 64, log_scale=True, fmin=300.0,
                                   fmax=3000.0), 44),
    ("mel", SpecConfig.north_star(256, 64, log_scale=True, n_mels=32), 32),
    ("band_mel", SpecConfig.north_star(256, 64, log_scale=True, n_mels=32,
                                       fmin=500.0, fmax=5000.0), None),
], ids=["band", "mel", "band_mel"])
def test_export_band_and_mel_match_jax(tmp_path, kind, cfg, height,
                                       pixel_format):
    """Band and mel configs export as the JAX export does through its
    batched_spectrogram_fn: the same PNGs, the band's or the mel rows'
    height, the counts equal; a NaN clip skipped in both."""
    clips = _clips(3, seed=4)
    bad = clips[1][1].copy()
    bad[100] = np.nan
    clips.append(("nan", bad))
    dirs, stats = _export_both(tmp_path, clips, cfg=cfg, on_error="skip",
                               pixel_format=pixel_format)
    _assert_same_pngs(dirs)
    assert _counts(stats["port"]) == _counts(stats["jax"])
    assert stats["port"].nonfinite == 1 and stats["port"].pngs_written == 3
    img = Image.open(os.path.join(dirs["port"], "c0.png"))
    if height is not None:
        assert img.size == (61, height)
