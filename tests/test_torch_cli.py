"""The port's command line (spectral_tpu_torch/cli.py) held against the
JAX package's (spectral_tpu/cli.py): the same command lines through
``spectral_tpu.cli.main(["--cpu", ...])`` and
``spectral_tpu_torch.cli.main(["--cpu", ...])`` on the same files, each
into its own directory, the results compared. The dataset commands
(grid, stream, export-specs, export-batch) are in
tests/test_torch_cli_data.py, serve in tests/test_torch_serve.py.

Tolerances:
- parser, exit codes, stdout and stderr texts, event lines and CSV bytes:
  equal (paths differ only by the output directory);
- PNG pixels: the same shape, at least 99.9% the same LUT index and none
  more than one index apart (tests/test_torch_export.py's rule: the JAX
  side's float32 transforms and the port's float64 agree within 5e-3 dB,
  so a pixel may cross one 1/256 edge);
- band powers: each within 2e-5 (the PSD contract, on ratios of sums),
  after both CLIs round them to 6 decimals.
"""

import argparse
import itertools
import os
import shlex
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from spectral_tpu import cli as jcli  # noqa: E402
from spectral_tpu.render import png as jpng  # noqa: E402
from spectral_tpu_torch import cli as tcli  # noqa: E402
from spectral_tpu_torch.render import png as tpng  # noqa: E402
from spectral_tpu_torch.io.wav import write_wav  # noqa: E402
from test_torch_export import _indices  # noqa: E402
from test_torch_session import _bursty  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAND_TOL = 2e-5
SAME = 0.999


def run(mod, argv, capsys):
    """mod.main(argv): (exit code, or the SystemExit's text; stdout;
    stderr)."""
    try:
        rc = mod.main(list(argv))
    except SystemExit as e:
        rc = e.code
    out, err = capsys.readouterr()
    return rc, out, err


def both(argv, capsys, tmp_path, cpu=True):
    """Run argv through both CLIs, "{d}" in an argument standing for each
    side's own output directory; returns {"jax": ..., "torch": ...} of
    run()'s triples with each side's directory written back as "{d}"."""
    got = {}
    for name, mod, png in (("jax", jcli, jpng), ("torch", tcli, tpng)):
        d = str(tmp_path / name)
        os.makedirs(d, exist_ok=True)
        # a PNG's temporary name counts the process's PNG writes, which
        # depend on the tests run before in this process: start both
        # sides' counts at 0, so an error message naming it compares
        png._tmp_counter = itertools.count()
        args = (["--cpu"] if cpu else []) + [a.replace("{d}", d)
                                             for a in argv]
        rc, out, err = run(mod, args, capsys)
        if isinstance(rc, str):
            rc = rc.replace(d, "{d}")
        got[name] = (rc, out.replace(d, "{d}"), err.replace(d, "{d}"))
    return got


def same_pixels(a, b):
    ia, ib = _indices(a), _indices(b)
    assert ia.shape == ib.shape
    assert (ia == ib).mean() >= SAME and np.abs(ia - ib).max() <= 1


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    """A 60 s bursty EEG-rate recording (two 6 Hz bursts) as a WAV."""
    d = tmp_path_factory.mktemp("rec")
    path = str(d / "sig.wav")
    write_wav(path, _bursty(fs=1000.0, dur=60.0) * 0.5, 1000.0)
    return path


# ---- the parser ----------------------------------------------------------

def _spec(parser):
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            out["<commands>"] = {name: _spec(p)
                                 for name, p in a.choices.items()}
        elif not isinstance(a, argparse._HelpAction):
            out[a.dest] = (tuple(a.option_strings), a.default, a.nargs,
                           a.required, a.choices, a.type, a.const,
                           type(a).__name__)
    return out


def test_parser_takes_the_jax_command_lines():
    """The same subcommands, option strings, defaults, types and choices;
    --cpu before the subcommand; only prog and help texts differ."""
    port, ref = tcli.build_parser(), jcli.build_parser()
    assert _spec(port) == _spec(ref)
    assert port.prog == "spectral-tpu-torch" and ref.prog == "spectral-tpu"
    assert sorted(_spec(port)["<commands>"]) == sorted([
        "render", "detect", "learn", "bands", "export-batch", "grid",
        "stream", "export-specs", "info", "serve", "doctor", "gui", "bench"])
    helps = " ".join(a.help or "" for p in port._subparsers._group_actions[0]
                     .choices.values() for a in p._actions)
    assert "lax.scan" not in helps and "vmapped" not in helps
    assert "bf16" not in helps


def _readme_lines():
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as fh:
        text = fh.read()
    lines = []
    in_code = False
    for line in text.splitlines():
        if line.strip().startswith("```"):
            in_code = not in_code
            continue
        s = line.split("#", 1)[0].strip()
        if in_code and (s.startswith("spectral-tpu-torch ")
                        or s.startswith("python -m spectral_tpu_torch.cli ")):
            lines.append(s)
    return lines


def test_readme_command_lines_parse():
    lines = _readme_lines()
    assert len(lines) >= 12
    prefixes = set()
    for line in lines:
        tokens = shlex.split(line)
        skip = 1 if tokens[0] == "spectral-tpu-torch" else 3
        prefixes.add(skip)
        tcli.build_parser().parse_args(tokens[skip:])
    assert prefixes == {1, 3}


def test_module_entry_point_runs(tmp_path):
    import subprocess
    r = subprocess.run([sys.executable, "-m", "spectral_tpu_torch.cli",
                        "--cpu", "info", str(tmp_path / "none.wav")],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 1 and "file not found" in r.stderr


# ---- one-shot commands ---------------------------------------------------

def test_info_lines_match(tmp_path, capsys, rec):
    from spectral_tpu_torch.io.abf import write_abf2_fixture
    npz = str(tmp_path / "two.npz")
    np.savez(npz, fs=500.0, raw=np.random.RandomState(0).randn(2, 700)
             .astype(np.float32))
    abf = str(tmp_path / "a.abf")
    write_abf2_fixture(abf, np.random.RandomState(1).randn(3, 2000)
                       .astype(np.float32), 2000.0)
    got = both(["info", rec, npz, abf], capsys, tmp_path)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 0 and got["torch"][1].count("\n") == 6


@pytest.mark.parametrize("extra", [
    ["--nperseg", "512", "--log"],
    ["--scipy-compat", "--fmin", "0", "--fmax", "30"],
    ["--scipy-compat", "--mels", "32", "--log"],
    ["--nperseg", "256", "--nfft", "512"],
], ids=["log", "scipy_band", "mels", "nfft"])
def test_render_pngs_match(tmp_path, capsys, rec, extra):
    got = both(["render", rec, "-o", "{d}/o.png", *extra], capsys, tmp_path)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 0 and "Successfully" in got["torch"][1]
    same_pixels(str(tmp_path / "torch" / "o.png"),
                str(tmp_path / "jax" / "o.png"))


def test_nfft_below_nperseg_refused_with_the_same_text(tmp_path, capsys,
                                                       rec):
    got = both(["render", rec, "-o", "{d}/o.png", "--nperseg", "512",
                "--nfft", "256"], capsys, tmp_path)
    assert got["torch"] == got["jax"] and "nfft" in got["torch"][0]
    assert not os.path.exists(tmp_path / "torch" / "o.png")


def test_detect_and_learn_events_and_csv_bytes(tmp_path, capsys, rec):
    spec = ["--scipy-compat", "--nperseg", "1024", "--fmin", "0", "--fmax",
            "30"]
    for argv in (["detect", rec, *spec, "--csv", "{d}/o.csv"],
                 ["learn", rec, "--roi", "10:16", "--roi", "35:42", *spec,
                  "--csv", "{d}/o.csv"]):
        got = both(argv, capsys, tmp_path)
        assert got["torch"] == got["jax"]
        assert got["torch"][0] == 0 and got["torch"][1].count("\t") >= 2
        with open(tmp_path / "torch" / "o.csv", "rb") as a, \
                open(tmp_path / "jax" / "o.csv", "rb") as b:
            assert a.read() == b.read()


def test_bands_json_within_the_contract(tmp_path, capsys, rec):
    import json
    got = both(["bands", rec, "--nperseg", "512"], capsys, tmp_path)
    t, j = (json.loads(got[k][1]) for k in ("torch", "jax"))
    assert list(t) == list(j) and got["torch"][0] == got["jax"][0] == 0
    assert max(abs(t[k] - j[k]) for k in t) <= BAND_TOL
    assert t["Theta (θ)"] > 0.5


def test_detect_each_batched_is_the_sequential_flow(tmp_path, capsys):
    """--each --batched on the port gives each sweep the sequential flow's
    events exactly (float64 from the features on), which are the JAX
    package's sequential events; the combined CSV bytes match."""
    fs = 1000.0
    paths = []
    for nm, dur, bursts, seed in (("a", 60.0, ((10, 15),), 1),
                                  ("b", 60.0, ((20, 26), (40, 45)), 2),
                                  ("c", 40.0, ((5, 9),), 3)):
        p = str(tmp_path / f"{nm}.wav")
        write_wav(p, _bursty(fs=fs, dur=dur, bursts=bursts, seed=seed) * 0.5,
                  fs)
        paths.append(p)
    argv = ["detect", *paths, "--each", "--scipy-compat", "--nperseg", "1024",
            "--fmin", "0", "--fmax", "30", "--csv", "{d}/each.csv"]
    seq = both(argv, capsys, tmp_path)
    assert seq["torch"] == seq["jax"] and seq["torch"][0] == 0
    with open(tmp_path / "torch" / "each.csv", "rb") as a, \
            open(tmp_path / "jax" / "each.csv", "rb") as b:
        assert a.read() == b.read()
    d = str(tmp_path / "torch")
    rc, out, err = run(tcli, ["--cpu", *(a.replace("{d}", d) for a in argv),
                              "--batched"], capsys)
    assert (rc, out.replace(d, "{d}")) == seq["torch"][:2]
    assert {ln.split("\t")[0] for ln in out.splitlines()[:-1]} == {
        "a_sweep0", "b_sweep0", "c_sweep0"}


def test_error_arms_exit_like_jax(tmp_path, capsys):
    """The error arms of tests/test_api.py (test_cli_error_arms_exit_
    cleanly, test_cli_learn_and_grid_error_arms, test_cli_error_paths_
    exit_nonzero and the flag refusals): the same exit codes and texts,
    and no traceback."""
    fs = 1000.0
    wav = str(tmp_path / "sig.wav")
    write_wav(wav, _bursty(fs=fs, dur=20.0) * 0.5, fs)
    other = str(tmp_path / "other.wav")
    write_wav(other, np.zeros(4000, np.float32), 2000.0)
    quiet = str(tmp_path / "quiet.wav")
    write_wav(quiet, np.ones(8000, np.float32) * 0.01, fs)
    bad = str(tmp_path / "bad.abf")
    with open(bad, "wb") as fh:
        fh.write(b"NOPE" + b"\x00" * 600)
    empty = str(tmp_path / "empty.npz")
    np.savez(empty, fs=1000.0, raw=np.zeros((0, 100), np.float32))
    txt = str(tmp_path / "x.txt")
    with open(txt, "w") as fh:
        fh.write("nope")
    folder = str(tmp_path / "dir.wav")
    os.makedirs(folder)
    nope = str(tmp_path / "nope.wav")
    cases = [
        ["detect", nope], ["detect", nope, "--each"],
        ["bands", str(tmp_path / "nope.h5")],
        ["detect", quiet, "--each", "--csv", "{d}/e.csv", "--nperseg", "512"],
        ["detect", bad], ["detect", bad, "--each"],
        ["detect", empty], ["detect", empty, "--each"],
        ["learn", wav, "--roi", "8-17"],
        ["grid", wav, "-o", "{d}/g.npz", "--channel", "7"],
        ["grid", wav, "-o", "{d}/g.npz", "--n-ffts", "abc"],
        ["grid", wav, "-o", "{d}/g.npz", "--n-ffts", ""],
        ["grid", wav, "-o", "{d}/g.npz", "--n-ffts", "1048576"],
        ["grid", nope, "-o", "{d}/g.npz"],
        ["render", wav, "-o", "{d}/no/such/dir/x.png"],
        ["render", wav, other, "--combine", "-o", "{d}/o.png"],
        ["render", wav, "-o", "{d}/o.png", "--transparent"],
        ["render", wav, "-o", "{d}/o.png", "--scipy-compat", "--window",
         "hann"],
        ["detect", wav, "--batched"],
        ["stream", txt, "--bands"],
        ["stream", nope, "--bands"],
        ["stream", wav],
        ["stream", wav, "--channel", "3", "--bands"],
        ["stream", wav, "-o", "{d}/s.npz", "--fmin", "900", "--fmax",
         "950", "--nperseg", "256"],
        ["info", folder],
        ["export-specs", str(tmp_path / "x.abf"), "-o", "{d}/s"],
    ]
    for argv in cases:
        got = both(argv, capsys, tmp_path)
        assert got["torch"] == got["jax"], argv
        rc = got["torch"][0]
        assert rc != 0, argv
        assert "Traceback" not in str(rc) + got["torch"][2], argv


def test_notices_and_gui_without_pyqt(tmp_path, capsys):
    fs = 1000.0
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    write_wav(a, _bursty(fs=fs, dur=5.0) * 0.5, fs)
    write_wav(b, _bursty(fs=fs, dur=5.0, seed=1) * 0.5, fs)
    got = both(["bands", a, b], capsys, tmp_path)
    assert got["torch"][2] == got["jax"][2] and "analyzing only" in \
        got["torch"][2]
    try:
        import PyQt5  # noqa: F401
        pytest.skip("PyQt5 present: gui would open a window")
    except ImportError:
        pass
    got = both(["gui"], capsys, tmp_path)
    assert got["torch"] == got["jax"] and got["torch"][0] == 2
    assert "requires PyQt5" in got["torch"][2]


def test_decorated_render_writes_the_figure(tmp_path, capsys, rec):
    pytest.importorskip("matplotlib")
    from spectral_tpu_torch.render.png import decode_png
    got = both(["render", rec, "-o", "{d}/d.png", "--decorated", "--nperseg",
                "512", "--log"], capsys, tmp_path)
    assert got["torch"] == got["jax"] and got["torch"][0] == 0
    assert decode_png(str(tmp_path / "torch" / "d.png")).shape == \
        decode_png(str(tmp_path / "jax" / "d.png")).shape


def test_doctor_on_the_cpu_reports_like_jax(tmp_path, capsys):
    import json
    got = both(["doctor", "--json", "--probe-link"], capsys, tmp_path)
    t, j = (json.loads(got[k][1]) for k in ("torch", "jax"))
    assert got["torch"][0] == got["jax"][0] == 0
    assert set(j) <= set(t) and t["ok"] and t["backend"] == "cpu"
    for key in ("sanity", "sanity_tone_peak_hz", "native_encoder",
                "gui_client"):
        assert t[key] == j[key], key
    assert t["n_devices"] == 1       # the JAX side counts its 8 virtual CPUs
    rc, out, _ = run(tcli, ["--cpu", "doctor", "--probe-link"], capsys)
    assert rc == 0 and "kernel build:" in out and "all good" in out
    assert "dispatch floor:" in out and "d2h bandwidth:" in out


# ---- no quiet fallback to the CPU ----------------------------------------

DEVICE_COMMANDS = [
    ["render", "{w}", "-o", "{d}/o.png"],
    ["render", "{w}", "-o", "{d}/o.png", "--decorated"],
    ["detect", "{w}", "--csv", "{d}/o.csv"],
    ["detect", "{w}", "--each", "--batched"],
    ["learn", "{w}", "--roi", "1:2"],
    ["bands", "{w}"],
    ["grid", "{w}", "-o", "{d}/g.npz"],
    ["stream", "{w}", "-o", "{d}/s.npz"],
    ["stream", "{w}", "--bands"],
    ["export-specs", "{w}", "-o", "{d}/specs"],
    ["export-batch", "{w}", "-o", "{d}/batch"],
    ["serve"],
    ["serve", "--tcp", "0"],
    ["gui"],
]


@pytest.mark.parametrize("argv", DEVICE_COMMANDS,
                         ids=lambda a: "-".join(x for x in a[:3]
                                                if "{" not in x))
def test_device_commands_refuse_without_a_card(tmp_path, capsys, argv,
                                               monkeypatch):
    """Without --cpu and without a card, a command that touches the device
    exits nonzero naming CUDA before it reads or writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = str(tmp_path / "in" / "w.wav")
    os.makedirs(os.path.dirname(w))
    write_wav(w, np.zeros(8000, np.float32), 1000.0)
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    args = [a.replace("{w}", w).replace("{d}", str(out_dir)) for a in argv]
    rc, out, err = run(tcli, args, capsys)
    assert isinstance(rc, str) and rc.startswith("error: ")
    assert "CUDA" in rc and "--cpu" in rc and out == ""
    assert list(out_dir.iterdir()) == []


def test_doctor_without_a_card_exits_1(capsys, monkeypatch):
    import json
    rc, out, _ = run(tcli, ["doctor", "--init-timeout", "60"], capsys)
    assert rc == 1 and "UNREACHABLE" in out and "PROBLEMS FOUND" in out
    assert "is_available() is False" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, _ = run(tcli, ["doctor", "--json", "--init-timeout", "0"],
                     capsys)
    assert rc == 1 and json.loads(out)["backend"] == "UNREACHABLE"
    # the probe is bounded: a hung init reports after the timeout
    import subprocess

    def hang(*a, **k):
        raise subprocess.TimeoutExpired(cmd="x", timeout=5.0)

    monkeypatch.setattr(subprocess, "run", hang)
    assert tcli._probe_backend_reachable(5.0) == (
        False, "CUDA init still blocked after 5s")


def test_info_runs_without_a_card(capsys, rec, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, _ = run(tcli, ["info", rec], capsys)
    assert rc == 0 and out.startswith("sig_sweep0: fs=1000")


def test_bench_refused_without_loading_bench_py(capsys):
    rc, out, _ = run(tcli, ["--cpu", "bench", "--batch", "8"], capsys)
    assert isinstance(rc, str) and "[bench]" in rc
    assert "spectral_tpu_bench" not in sys.modules and out == ""


def test_every_command_passes_the_device(tmp_path, capsys, monkeypatch,
                                         rec):
    """--cpu reaches every entry point a command calls as device='cpu',
    and without it they get 'cuda' (recorded, not run)."""
    from spectral_tpu_torch.api import session
    seen = []
    real = session.AnalysisSession

    class Recording(real):
        def __init__(self, *a, **kw):
            seen.append(kw.get("device"))
            super().__init__(*a, **kw)

    monkeypatch.setattr(session, "AnalysisSession", Recording)
    assert run(tcli, ["--cpu", "bands", rec], capsys)[0] == 0
    assert run(tcli, ["--cpu", "detect", rec, "--each"], capsys)[0] == 0
    assert seen == ["cpu", "cpu"]
    assert all(d == "cpu" for d in seen)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(session.AnalysisSession, "plot_sweeps",
                        lambda self, *a, **k: (_ for _ in ()).throw(
                            ValueError("stop")))
    rc, _, _ = run(tcli, ["bands", rec], capsys)
    assert rc == "error: stop" and seen[-1] == "cuda"
