"""The port's serve worker (spectral_tpu_torch/cli.py::_serve, _serve_tcp,
_make_serve_loop) held against the JAX package's: the same request lines
through both workers on the CPU (the port's with device='cpu'), the
replies compared; the guards (LRU, request size, timeout, RSS) after
tests/test_api.py; serve --tcp 0 through the port's ServeClient.

Tolerances: replies equal, but for band powers (each within 2e-5, the
PSD contract on ratios of sums; the total power within 2e-5 relative)
and rendered PNGs (tests/test_torch_cli.py's pixel rule); a config the
kernels cannot compute (nperseg past 32,768) answers ok: false naming
ROADMAP [large-nperseg] on the port.
"""

import io
import json
import os
import re
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from spectral_tpu import cli as jcli  # noqa: E402
from spectral_tpu_torch import cli as tcli  # noqa: E402
from spectral_tpu_torch.io.wav import write_wav  # noqa: E402
from test_torch_cli import same_pixels  # noqa: E402
from test_torch_session import _bursty  # noqa: E402

BAND_TOL = 2e-5


def serve_both(lines, **guards):
    """The same request lines through both stdio workers: (jax replies,
    port replies), one JSON object per line."""
    text = "\n".join(ln if isinstance(ln, str) else json.dumps(ln)
                     for ln in lines) + "\n"
    out = []
    for serve, kw in ((jcli._serve, {}), (tcli._serve, {"device": "cpu"})):
        stdout = io.StringIO()
        assert serve(io.StringIO(text), stdout, **guards, **kw) == 0
        out.append([json.loads(ln) for ln in stdout.getvalue().splitlines()])
    return out


def same_bands(a, b):
    assert a["ok"] and b["ok"] and list(a["bands"]) == list(b["bands"])
    assert max(abs(a["bands"][k] - b["bands"][k]) for k in a["bands"]) \
        <= BAND_TOL
    assert abs(a["total_power"] - b["total_power"]) <= BAND_TOL * abs(
        b["total_power"])


def float_wav(path, x, fs):
    """An IEEE-float32 WAV (format tag 3; write_wav writes 16-bit PCM,
    which cannot carry overflow-scale amplitudes)."""
    import struct
    payload = np.asarray(x, "<f4").tobytes()
    fmt = struct.pack("<HHIIHH", 3, 1, int(fs), int(fs) * 4, 4, 32)
    path.write_bytes(
        struct.pack("<4sI4s", b"RIFF", 20 + len(fmt) + len(payload), b"WAVE")
        + struct.pack("<4sI", b"fmt ", len(fmt)) + fmt
        + struct.pack("<4sI", b"data", len(payload)) + payload)


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    path = str(d / "sig.wav")
    write_wav(path, _bursty(fs=1000.0, dur=60.0) * 0.5, 1000.0)
    return path


def test_replies_match_jax(tmp_path, wav):
    """tests/test_api.py::test_cli_serve_jsonl's requests: ping, bands,
    detect, render, learn, an unknown command, a missing file, shutdown."""
    pngs = {k: str(tmp_path / f"{k}.png") for k in ("jax", "torch")}
    reqs = [
        {"cmd": "ping"},
        {"cmd": "bands", "files": [wav],
         "config": {"nperseg": 512, "fmin": 0.0, "fmax": 30.0}},
        {"cmd": "detect", "files": [wav],
         "config": {"nperseg": 1024, "fmin": 0.0, "fmax": 30.0}},
        {"cmd": "render", "files": [wav], "out": "{png}",
         "config": {"nperseg": 512, "log_scale": True}},
        {"cmd": "learn", "files": [wav], "rois": [[8, 17], [28, 40]],
         "config": {"nperseg": 1024, "fmin": 0.0, "fmax": 30.0}},
        {"cmd": "nonsense"},
        {"cmd": "detect", "files": ["/does/not/exist.wav"]},
        {"cmd": "stats"},
        {"cmd": "shutdown"},
    ]
    outs = []
    for key, serve, kw in (("jax", jcli._serve, {}),
                           ("torch", tcli._serve, {"device": "cpu"})):
        text = "\n".join(json.dumps(r).replace("{png}", pngs[key])
                         for r in reqs) + "\n"
        stdout = io.StringIO()
        assert serve(io.StringIO(text), stdout, **kw) == 0
        outs.append([json.loads(ln) for ln in
                     stdout.getvalue().replace(pngs[key], "{png}")
                     .splitlines()])
    j, t = outs
    assert len(t) == len(j) == len(reqs)
    same_bands(t[1], j[1])
    assert t[2] == j[2] and len(t[2]["events"]) == 2
    assert t[3] == j[3] and t[3]["ok"]
    same_pixels(pngs["torch"], pngs["jax"])
    assert t[4] == j[4] and len(t[4]["events"]) >= 2
    for i in (0, 5, 6, 8):
        assert t[i] == j[i], reqs[i]
    rss = t[7].pop("rss_mb"), j[7].pop("rss_mb")
    assert t[7] == j[7] and min(rss) > 0
    assert t[7]["errors"] == 2 and t[7]["sessions_cached"] == 1


def test_fuzz_lines_answered_like_jax(tmp_path, wav):
    """tests/test_api.py::test_cli_serve_protocol_fuzz's lines: one strict
    JSON reply each, the worker never dies, and every reply the JAX
    worker's."""
    rng = np.random.RandomState(7)
    lines = [
        "{not json", "[1, 2, 3]", '"just a string"', "null", '{"cmd": 42}',
        '{"cmd": "render"}',
        '{"cmd": "render", "files": 17, "out": "x.png"}',
        f'{{"cmd": "render", "files": ["{wav}"]}}',
        f'{{"cmd": "detect", "files": ["{wav}"], "config": {{"nperseg": -4}}}}',
        f'{{"cmd": "detect", "files": ["{wav}"], '
        '"config": {"bogus_field": 1}}',
        f'{{"cmd": "learn", "files": ["{wav}"], "rois": "zzz"}}',
        f'{{"cmd": "learn", "files": ["{wav}"], "rois": [[1]]}}',
        f'{{"cmd": "render_batch", "files": [], "out_dir": "{tmp_path}/d"}}',
        '{"cmd": "bands", "files": []}',
        '{"cmd": "detect_batch"}',
        '{"cmd": "detect_batch", "files": "x"}',
        '{"cmd": "stream_bands", "files": []}',
        f'{{"cmd": "stream_bands", "files": ["{wav}"], "channel": 99}}',
        f'{{"cmd": "stream_bands", "files": ["{wav}"], '
        '"chunk_seconds": "soon"}',
        f'{{"cmd": "stream_bands", "files": ["{wav}"], '
        '"config": {"center": true}}',
    ]
    for _ in range(20):
        n = int(rng.randint(1, 60))
        lines.append("".join(chr(rng.randint(0x20, 0x7F)) for _ in range(n)))
    lines.append('{"cmd": "shutdown"}')
    j, t = serve_both(lines)
    assert len(t) == len(j) == len(lines)
    for a, b, line in zip(t, j, lines):
        assert a == b, line
    assert t[-1] == {"ok": True, "bye": True}
    assert not any(r["ok"] for r in t[:-1])


@pytest.mark.parametrize("config", [{"mode": "complex"},
                                    {"mode": "magnitude"},
                                    {"center": True},
                                    {"nperseg": 16384}],
                         ids=["complex", "magnitude", "center", "16384"])
def test_configs_the_kernels_cannot_compute_answer_ok_false(wav, config):
    """Requests naming the extended modes are answered as the JAX worker
    answers them: the magnitude and centered configs computed (detect's
    events equal, band powers within BAND_TOL), the complex mode refused
    with the JAX package's ValueError (it has no power spectrogram); a
    transform past 8192 (nperseg 16384, [large-nperseg]) computed as the
    JAX worker computes it, and one past 32,768 gets the port's refusal as
    one ok: false reply naming [large-nperseg]. The worker keeps
    serving."""
    lines = [{"cmd": cmd, "files": [wav], "config": config}
             for cmd in ("render", "detect", "bands")]
    lines[0]["out"] = "/nonexistent/x.png"
    lines += [{"cmd": "ping"}, {"cmd": "shutdown"}]
    if config.get("nperseg") == 16384:
        past = [dict(r, config={"nperseg": 65536}) for r in lines]
        stdout = io.StringIO()
        tcli._serve(io.StringIO("\n".join(json.dumps(r) for r in past)
                                + "\n"), stdout, device="cpu")
        out = [json.loads(ln) for ln in stdout.getvalue().splitlines()]
        for r in out[:3]:
            assert not r["ok"] and "[large-nperseg]" in r["error"], r
            assert r["error"].startswith("NotImplementedError: ")
        assert out[3] == {"ok": True, "pong": True}
    j, t = serve_both(lines)
    assert len(t) == len(j) == len(lines)

    def tmp_free(r):
        # the render's failed write names its temporary file, whose
        # counter depends on the writes before it in the process
        return json.loads(re.sub(r"\.tmp\.\d+\.\d+", ".tmp",
                                 json.dumps(r)))

    assert tmp_free(t[0]) == tmp_free(j[0]) and t[1] == j[1]
    if config.get("nperseg") == 16384:
        same_bands(t[2], j[2])
        assert t[3] == j[3] == {"ok": True, "pong": True}
        return
    if config.get("mode") == "complex":
        for r in t[:3]:
            assert not r["ok"] and r["error"].startswith(
                "ValueError: mode='complex' has no power spectrogram"), r
        assert t[2] == j[2]
    else:
        assert t[1]["ok"] and len(t[1]["events"]) >= 1
        same_bands(t[2], j[2])
    assert t[3] == j[3] == {"ok": True, "pong": True}


def test_batch_and_stream_requests_match_jax(tmp_path):
    """render_batch (the export pipeline), detect_batch (the fleet flow,
    an overflowing sweep isolated as its error) and stream_bands (the
    streaming fold)."""
    fs = 1000.0
    clips = []
    for i in range(3):
        p = str(tmp_path / f"clip{i}.wav")
        write_wav(p, np.clip(0.3 * np.random.RandomState(i).randn(10000),
                             -1, 1), fs)
        clips.append(p)
    good = str(tmp_path / "g.wav")
    write_wav(good, _bursty(fs=fs, dur=15.0, bursts=((4, 8),)) * 0.5, fs)
    bad = tmp_path / "b.wav"
    float_wav(bad, 1e19 * np.random.default_rng(0).standard_normal(15000),
              fs)
    dirs = {k: str(tmp_path / k) for k in ("jax", "torch")}
    reqs = [{"cmd": "render_batch", "files": clips, "out_dir": "{d}",
             "clip_seconds": 10.0,
             "config": {"nperseg": 256, "hop": 64, "window": "hann",
                        "detrend": "none", "log_scale": True}},
            {"cmd": "detect_batch", "files": [good, str(bad)],
             "config": {"nperseg": 256, "fmin": 0.0, "fmax": 30.0}},
            {"cmd": "stream_bands", "files": [good], "chunk_seconds": 5.0,
             "config": {"nperseg": 256}},
            {"cmd": "shutdown"}]
    outs = []
    for key, serve, kw in (("jax", jcli._serve, {}),
                           ("torch", tcli._serve, {"device": "cpu"})):
        text = "\n".join(json.dumps(r).replace("{d}", dirs[key])
                         for r in reqs) + "\n"
        stdout = io.StringIO()
        serve(io.StringIO(text), stdout, **kw)
        outs.append([json.loads(ln) for ln in stdout.getvalue().splitlines()])
    j, t = outs
    assert t[0] == j[0] and t[0]["written"] == 3
    for name in sorted(os.listdir(dirs["jax"])):
        same_pixels(os.path.join(dirs["torch"], name),
                    os.path.join(dirs["jax"], name))
    assert t[1] == j[1] and t[1]["results"]["g_sweep0"]["events"]
    assert "rescale" in t[1]["results"]["b_sweep0"]["error"]
    same_bands(t[2], j[2])
    assert t[2]["sweep"] == j[2]["sweep"] == "g_sweep0"


def test_lru_eviction_and_guards(tmp_path, monkeypatch):
    """After tests/test_api.py::test_cli_serve_lru_eviction_and_guards:
    the LRU bound, the request size, the timeout with recovery and
    timeout 0 meaning none."""
    import time as _time
    from spectral_tpu_torch.api import session as sess_mod
    fs = 1000.0
    paths = []
    for i in range(6):
        p = str(tmp_path / f"s{i}.wav")
        write_wav(p, _bursty(fs=fs, dur=20.0, seed=i) * 0.5, fs)
        paths.append(p)
    loads = []
    orig = sess_mod.AnalysisSession

    class Counting(orig):
        def load(self, path):
            loads.append(path)
            if "slow" in str(path):
                _time.sleep(1.0)
            return super().load(path)

    monkeypatch.setattr(sess_mod, "AnalysisSession", Counting)
    reqs = [{"cmd": "bands", "files": [p],
             "config": {"nperseg": 256, "fmin": 0.0, "fmax": 30.0}}
            for p in paths]
    reqs += [reqs[0], reqs[5], {"cmd": "stats"}, {"cmd": "shutdown"}]
    stdout = io.StringIO()
    assert tcli._serve(io.StringIO("\n".join(json.dumps(r) for r in reqs)
                                   + "\n"), stdout, max_sessions=2,
                       device="cpu") == 0
    out = [json.loads(ln) for ln in stdout.getvalue().splitlines()]
    assert all(o["ok"] for o in out)
    assert loads == paths + [paths[0]]
    assert out[-2]["sessions_cached"] == 2

    big = json.dumps({"cmd": "bands", "files": [paths[0]],
                      "pad": "x" * 4096})
    stdout = io.StringIO()
    tcli._serve(io.StringIO(big + "\n" + json.dumps({"cmd": "ping"}) + "\n"),
                stdout, max_request_bytes=1024, device="cpu")
    out = [json.loads(ln) for ln in stdout.getvalue().splitlines()]
    assert not out[0]["ok"] and "max_request_bytes" in out[0]["error"]
    assert out[1] == {"ok": True, "pong": True}

    slow = str(tmp_path / "slow.wav")
    write_wav(slow, _bursty(fs=fs, dur=5.0) * 0.5, fs)
    marker = json.dumps({"cmd": "bands", "files": [slow]})
    for timeout, first_ok in ((0.2, False), (0, True), (None, True)):
        stdout = io.StringIO()
        tcli._serve(io.StringIO(marker + "\n" + json.dumps({"cmd": "stats"})
                                + "\n"), stdout, request_timeout=timeout,
                    device="cpu")
        out = [json.loads(ln) for ln in stdout.getvalue().splitlines()]
        assert out[0]["ok"] is first_ok, (timeout, out[0])
        if not first_ok:
            assert "Timeout" in out[0]["error"]
            assert out[1]["timeouts"] == 1 and out[1]["sessions_cached"] == 0


def test_timeout_gives_the_next_requests_a_new_cache_and_stream(
        tmp_path, monkeypatch):
    """On a card each cache runs its requests on a CUDA stream of its own
    (here a stand-in): after a timeout the abandoned request keeps the old
    cache and stream, and the requests after it run on a new one."""
    import contextlib
    import time as _time
    from spectral_tpu_torch.api import session as sess_mod
    made, used = [], []

    class FakeStream:
        def __init__(self):
            made.append(self)

    @contextlib.contextmanager
    def on(stream):
        used.append(stream)
        yield

    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "stream", on)
    orig = sess_mod.AnalysisSession

    class Slow(orig):
        def load(self, path):
            _time.sleep(1.0)
            raise ValueError("stopped")

    monkeypatch.setattr(sess_mod, "AnalysisSession", Slow)
    reqs = [{"cmd": "bands", "files": ["a.wav"]}, {"cmd": "ping"},
            {"cmd": "stats"}]
    stdout = io.StringIO()
    tcli._serve(io.StringIO("\n".join(json.dumps(r) for r in reqs) + "\n"),
                stdout, request_timeout=0.2, device="cuda")
    out = [json.loads(ln) for ln in stdout.getvalue().splitlines()]
    assert not out[0]["ok"] and out[1]["ok"] and out[2]["timeouts"] == 1
    assert len(made) == 2 and used == [made[0], made[1], made[1]]


def test_tcp_worker_with_the_ports_client(tmp_path, wav):
    """serve --tcp 0 (the port's _serve_tcp on the CPU) through the port's
    ServeClient: typed replies, the same values the stdio worker gives,
    ServeError on ok: false, shutdown on request."""
    from spectral_tpu_torch.client import ServeClient, ServeError
    box, ready = {}, threading.Event()
    th = threading.Thread(target=lambda: box.update(rc=tcli._serve_tcp(
        "127.0.0.1", 0, device="cpu", ready=lambda p: (
            box.update(port=p), ready.set()))), daemon=True)
    th.start()
    assert ready.wait(30.0)
    cfg = {"nperseg": 256, "fmin": 0.0, "fmax": 30.0}
    with ServeClient.tcp(box["port"]) as c:
        assert c.ping()
        events = c.detect([wav], config=cfg)
        assert events and all(isinstance(e, tuple) for e in events)
        bands, total = c.bands([wav], config=cfg)
        out = str(tmp_path / "c.png")
        assert "Successfully" in c.render([wav], out, config=cfg)
        assert c.detect_batch([wav], config=cfg)["sig_sweep0"]["events"] \
            == [list(e) for e in events]
        assert c.learn([wav], rois=[(8.0, 17.0)], config=cfg)
        sb, stot = c.stream_bands([wav], chunk_seconds=5.0,
                                  config={"nperseg": 256})
        assert set(sb) == set(bands) and stot > 0
        with pytest.raises(ServeError, match="unknown cmd"):
            c.request({"cmd": "nonsense"})
        st = c.stats()
        assert st["requests"] == 9 and st["errors"] == 1
    stdout = io.StringIO()
    tcli._serve(io.StringIO(json.dumps({"cmd": "detect", "files": [wav],
                                        "config": cfg}) + "\n"), stdout,
                device="cpu")
    assert [tuple(e) for e in json.loads(stdout.getvalue())["events"]] \
        == events
    with ServeClient.tcp(box["port"]) as c2:
        c2.close(shutdown=True)
    th.join(30.0)
    assert not th.is_alive() and box["rc"] == 0


def test_serve_subcommand_reads_stdin_on_the_cpu(monkeypatch, capsys):
    lines = json.dumps({"cmd": "ping"}) + "\n" + json.dumps(
        {"cmd": "shutdown"}) + "\n"
    monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
    assert tcli.main(["--cpu", "serve", "--max-sessions", "2"]) == 0
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert out == [{"ok": True, "pong": True}, {"ok": True, "bye": True}]
