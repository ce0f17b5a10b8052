"""The port's dataset commands (grid, stream, export-specs, export-batch of
spectral_tpu_torch/cli.py) held against the JAX package's CLI, each side
with ``--cpu`` on the same files into its own directory.

Tolerances:
- exit codes and stdout texts equal (paths differ only by the output
  directory), event lines and CSV bytes equal, waveform PNG bytes equal;
- PSDs (grid and stream npz): each side within PSD_REL = 2e-5 of the
  reference's max against scipy float64 (the PSD contract), axes equal;
- spectrogram PNG pixels: tests/test_torch_cli.py's rule (99.9% the same
  LUT index, none more than one apart);
- band powers within 2e-5, the total power within 2e-5 relative.
"""

import json
import os
import sys

import numpy as np
import pytest
import scipy.signal

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from spectral_tpu_torch.io.wav import read_wav, write_wav  # noqa: E402
from test_torch_cli import both, same_pixels  # noqa: E402
from test_torch_session import _bursty  # noqa: E402

PSD_REL = 2e-5
BAND_TOL = 2e-5


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    d = tmp_path_factory.mktemp("rec")
    path = str(d / "long.wav")
    write_wav(path, _bursty(fs=1000.0, dur=30.0) * 0.5, 1000.0)
    return path


def _scipy(x, fs, nperseg, hop, window, detrend, nfft=None):
    _f, _t, sxx = scipy.signal.spectrogram(
        np.asarray(x, np.float64), fs=fs, window=window, nperseg=nperseg,
        noverlap=nperseg - hop, nfft=nfft or nperseg, scaling="density",
        detrend=False if detrend == "none" else detrend, mode="psd")
    return sxx.T


def _close(got, ref):
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= PSD_REL * np.abs(ref).max()


def test_grid_npz_within_the_psd_contract(tmp_path, capsys, rec):
    got = both(["grid", rec, "-o", "{d}/g.npz", "--n-ffts", "256,512",
                "--windows", "hann,hamming", "--clip-seconds", "20"],
               capsys, tmp_path)
    assert got["torch"] == got["jax"] and got["torch"][0] == 0
    zt, zj = (np.load(tmp_path / k / "g.npz") for k in ("torch", "jax"))
    assert sorted(zt.files) == sorted(zj.files)
    x, fs = read_wav(rec)
    x = x[:20000]
    for key in zt.files:
        if key.startswith("psd_"):
            _, n, w = key.split("_")
            ref = _scipy(x, fs, int(n), int(n) // 4, w, "none").T
            _close(zt[key], ref)
            _close(zj[key], ref)
        else:
            assert np.array_equal(zt[key], zj[key]), key


@pytest.mark.parametrize("extra", [
    ["--nperseg", "512", "--hop", "128", "--chunk-seconds", "5"],
    ["--nperseg", "512", "--hop", "128", "--chunk-seconds", "5", "--scan"],
    ["--nperseg", "512", "--hop", "128", "--chunk-seconds", "5", "--scan",
     "--mesh"],
    ["--scipy-compat", "--nperseg", "256", "--fmin", "0", "--fmax", "30",
     "--chunk-seconds", "2"],
    ["--nperseg", "256", "--nfft", "1024", "--chunk-seconds", "4"],
], ids=["stream", "scan", "mesh_one_device", "band", "nfft"])
def test_stream_npz_within_the_psd_contract(tmp_path, capsys, rec, extra):
    """stream -o x.npz: the streamed PSD (--scan: the block scan; --mesh
    with one device: the single-device scan, as the JAX package does on
    one device) against scipy float64, rows masked to the band."""
    got = both(["stream", rec, "-o", "{d}/p.npz", *extra], capsys, tmp_path)
    assert got["torch"] == got["jax"] and got["torch"][0] == 0
    zt, zj = (np.load(tmp_path / k / "p.npz") for k in ("torch", "jax"))
    for key in ("f", "t", "fs"):
        assert np.array_equal(zt[key], zj[key]), key
    x, fs = read_wav(rec)
    if "--scipy-compat" in extra:
        ref = _scipy(x, fs, 256, 224, ("tukey", 0.25),
                     "constant")[:, :zt["f"].size]     # rows from 0 Hz
    else:
        nfft = int(extra[extra.index("--nfft") + 1]) if "--nfft" in extra \
            else None
        hop = int(extra[extra.index("--hop") + 1]) if "--hop" in extra \
            else int(extra[1]) // 4
        ref = _scipy(x, fs, int(extra[1]), hop, "hann", "none", nfft)
    _close(zt["psd"], ref)
    _close(zj["psd"], ref)


def test_stream_png_bands_and_detect(tmp_path, capsys, rec):
    spec = ["--scipy-compat", "--nperseg", "256", "--fmin", "0", "--fmax",
            "30", "--chunk-seconds", "5"]
    got = both(["stream", rec, "-o", "{d}/p.png", *spec, "--scan", "--log"],
               capsys, tmp_path)
    assert got["torch"] == got["jax"] and got["torch"][0] == 0
    same_pixels(str(tmp_path / "torch" / "p.png"),
                str(tmp_path / "jax" / "p.png"))
    got = both(["stream", rec, "--bands", *spec], capsys, tmp_path)
    assert got["torch"][0] == got["jax"][0] == 0
    (bt, tt), (bj, tj) = (
        (json.loads(got[k][1].rsplit("\n", 2)[0]),
         float(got[k][1].rsplit(": ", 1)[1])) for k in ("torch", "jax"))
    assert list(bt) == list(bj)
    assert max(abs(bt[k] - bj[k]) for k in bt) <= BAND_TOL
    assert abs(tt - tj) <= BAND_TOL * abs(tj)
    got = both(["stream", rec, "--detect", "--csv", "{d}/s.csv", *spec],
               capsys, tmp_path)
    assert got["torch"] == got["jax"] and got["torch"][0] == 0
    assert got["torch"][1].count("\t") >= 2
    with open(tmp_path / "torch" / "s.csv", "rb") as a, \
            open(tmp_path / "jax" / "s.csv", "rb") as b:
        assert a.read() == b.read()


def test_export_specs_pngs_resume_and_skip(tmp_path, capsys):
    fs = 8000.0
    paths = []
    for i in range(3):
        p = str(tmp_path / f"c{i}.wav")
        write_wav(p, np.clip(0.3 * np.random.RandomState(i).randn(8000),
                             -1, 1).astype(np.float32), fs)
        paths.append(p)
    spec = ["--clip-seconds", "1", "--nperseg", "256", "--hop", "64",
            "--log", "--batch", "2"]
    got = both(["export-specs", *paths, "-o", "{d}/specs", *spec,
                "--stats-json", "{d}/st.json"], capsys, tmp_path)
    assert got["torch"] == got["jax"] and got["torch"][0] == 0
    for name in ("c0.png", "c1.png", "c2.png"):
        same_pixels(str(tmp_path / "torch" / "specs" / name),
                    str(tmp_path / "jax" / "specs" / name))
    st, sj = (json.load(open(tmp_path / k / "st.json"))
              for k in ("torch", "jax"))
    assert set(st) == set(sj) and set(st["breakdown"]) == set(sj["breakdown"])
    assert {k: st[k] for k in st if k != "breakdown"} == \
        {k: sj[k] for k in sj if k != "breakdown"}
    # --resume: every PNG exists, nothing is redone, the same counts
    got = both(["export-specs", *paths, "-o", "{d}/specs", *spec,
                "--resume"], capsys, tmp_path)
    assert got["torch"] == got["jax"]
    assert "(resume: 3 already existed)" in got["torch"][1]
    # --on-error skip: an undecodable file is skipped on both sides
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as fh:
        fh.write(b"not a wav")
    got = both(["export-specs", paths[0], bad, "-o", "{d}/skip", *spec,
                "--on-error", "skip"], capsys, tmp_path)
    assert got["torch"] == got["jax"] and "Exported 1" in got["torch"][1]
    assert os.listdir(tmp_path / "torch" / "skip") == ["c0.png"]


def test_export_batch_bytes(tmp_path, capsys):
    fs = 1000.0
    wav = str(tmp_path / "sig.wav")
    write_wav(wav, np.sin(np.linspace(0, 60, 6000)).astype(np.float32), fs)
    for extra in ([], ["--window-seconds", "0"]):
        got = both(["export-batch", wav, "-o", "{d}/b", *extra], capsys,
                   tmp_path)
        assert got["torch"] == got["jax"] and got["torch"][0] == 0
        with open(tmp_path / "torch" / "b" / "sig_sweep0.png", "rb") as a, \
                open(tmp_path / "jax" / "b" / "sig_sweep0.png", "rb") as b:
            assert a.read() == b.read()
