"""Command-line interface of the port, on the card.

Counterpart of ``spectral_tpu/cli.py``: the same subcommands, options,
defaults, exit texts and exit codes, over the port's modules. Every
command that computes runs on the card (CUDA) unless ``--cpu`` is given
before the subcommand; without a card such a command exits nonzero naming
CUDA before it reads or writes anything, and never carries on on the CPU.
``info`` touches no device; ``doctor`` reports a card it cannot reach.
Subcommands mirror the reference app's actions:

  render      file(s) -> spectrogram PNG
  detect      file -> burst events (unsupervised), optional CSV
  learn       file + ROI list -> refined detection, optional CSV
  bands       file -> EEG band powers
  grid        parameter-sweep grid -> one .npz of PSDs per combo
  stream      long recording -> streamed PSD / dB image / band powers
  export-specs  WAV dataset -> spectrogram PNGs (overlapped pipeline)
  export-batch  files -> per-sweep waveform PNGs
  serve       long-lived JSONL worker (warm constants + sessions)
  info        file -> registered sweeps
  doctor      environment self-check
  gui         the Qt window
  bench       refused until bench.py has a path for the port

    spectral-tpu-torch render rec.wav -o s.png --scipy-compat --log
    python -m spectral_tpu_torch.cli --cpu detect rec.wav --csv b.csv
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import sys
from typing import List, Optional

import numpy as np

# commands that touch no device: everything else needs the card unless
# --cpu is given (doctor reports an unreachable card itself)
_HOST_COMMANDS = ("info", "doctor", "bench")


def _device(args) -> str:
    """The device every entry point of the command gets."""
    return "cpu" if getattr(args, "cpu", False) else "cuda"


def _require_device(args) -> None:
    """Exit with a clean error naming CUDA when the command needs the card
    and there is none (no quiet fallback to the CPU)."""
    if getattr(args, "cpu", False):
        return
    from spectral_tpu_torch.utils.device import require_cuda
    try:
        require_cuda()
    except RuntimeError as e:
        sys.exit(f"error: {e}; pass --cpu (before the subcommand) to run "
                 "on the host CPU")


def _visible_devices(device: str) -> int:
    """The devices a multi-device flag would spread over: the visible CUDA
    cards, or the one host CPU."""
    if device == "cpu":
        return 1
    import torch
    return torch.cuda.device_count()


def _make_config(args) -> "SpecConfig":
    from spectral_tpu_torch.config import SpecConfig
    precision = "fast" if getattr(args, "fast", False) else "accurate"
    if args.scipy_compat:
        if getattr(args, "window", None):
            # silently rendering Tukey while the user asked for hann would
            # be worse than refusing
            sys.exit("error: --scipy-compat fixes the window to "
                     "tukey(0.25) (the reference's scipy default); "
                     "drop --window or drop --scipy-compat")
        cfg = SpecConfig.scipy_default(
            nperseg=args.nperseg, fmin=args.fmin, fmax=args.fmax,
            log_scale=args.log, precision=precision)
        if getattr(args, "mels", 0):
            # --mels composes with the scipy framing (every subcommand,
            # not just export-specs)
            import dataclasses
            cfg = dataclasses.replace(cfg, n_mels=args.mels)
        return _with_nfft(cfg, args)
    return _with_nfft(SpecConfig.north_star(
        n_fft=args.nperseg, hop=args.hop or args.nperseg // 4,
        window=args.window or "hann", fmin=args.fmin, fmax=args.fmax,
        log_scale=args.log, precision=precision,
        n_mels=args.mels if getattr(args, "mels", 0) else None), args)


def _with_nfft(cfg, args):
    """Apply --nfft (zero-padded transform length, scipy's nfft arg)."""
    nfft = getattr(args, "nfft", None)
    if not nfft:
        return cfg
    import dataclasses
    try:
        return dataclasses.replace(cfg, nfft=nfft)
    except ValueError as e:   # nfft < nperseg
        sys.exit(f"error: {e}")


def _session_for(paths: List[str], args):
    from spectral_tpu_torch.api.session import AnalysisSession
    from spectral_tpu_torch.config import ViewSettings
    # warm_detection=False: these are one-shot commands; the process
    # either detects at once (and loads the HMM kernels then) or never
    s = AnalysisSession(warm_detection=False, device=_device(args))
    names = []
    for p in paths:
        try:
            names += s.load(p)
        except FileNotFoundError:
            sys.exit(f"error: file not found: {p}")
        except ValueError as e:
            sys.exit(f"error: {e}")
    if not names:
        sys.exit("no sweeps loaded")
    sel = names if args.combine else names[:1]
    if len(names) > 1 and not args.combine:
        # the non-combine path analyzes the first sweep only (reference
        # PlotEngine.py:203-206); say so instead of silently dropping data
        print(f"note: {len(names)} sweeps loaded; analyzing only "
              f"{sel[0]} (pass --combine to concatenate them)",
              file=sys.stderr)
    s.plot_sweeps(sel, _make_config(args),
                  ViewSettings(combine=args.combine, mode_proc="Spectrogram",
                               mode_raw="Spectrogram"))
    return s, names


def _add_spec_args(p, combine: bool = True):
    p.add_argument("--nperseg", type=int, default=1024)
    p.add_argument("--hop", type=int, default=None,
                   help="frame hop (default nperseg//4; scipy mode ignores)")
    p.add_argument("--nfft", type=int, default=None,
                   help="zero-padded transform length (scipy's nfft; "
                        "default nperseg, must be >= nperseg)")
    p.add_argument("--window", default=None,
                   help="window function (default hann; invalid with "
                        "--scipy-compat, which fixes tukey 0.25)")
    p.add_argument("--scipy-compat", action="store_true",
                   help="reference-exact mode: Tukey(0.25), hop=nperseg-nperseg//8")
    p.add_argument("--fmin", type=float, default=None)
    p.add_argument("--fmax", type=float, default=None)
    p.add_argument("--log", action="store_true", help="dB display scale")
    p.add_argument("--fast", action="store_true",
                   help="the display-only precision tier; the port runs it "
                        "at the contract precision today (1e-3 dB)")
    if combine:  # meaningless for single-recording / clip-dataset commands
        p.add_argument("--combine", action="store_true",
                       help="concatenate all sweeps (reference combine mode)")


def _detect_each_batched(s, names, base_cfg, device):
    """Fleet mode: group same-(length, fs) sweeps — the normal shape of a
    multi-sweep ABF/NIX recording — and run each group's STFT as one
    kernel launch and its EM fit + escape patch + Viterbi as one launch
    each of the HMM kernels (models/batch.py) on ``device``, instead of
    one round trip per sweep. Returns {name: events | error}. Shared by
    `detect --each --batched` and serve's `detect_batch`.

    Same flow per clip as the sequential path (proc-preferred source,
    authoritative entry fs, cfg.fmin/fmax feature band, short-signal
    config shrink, the session's PSD), in float64 from the features on,
    so each sweep's events are the sequential flow's."""
    import torch
    from spectral_tpu_torch.core import events as ev_mod
    from spectral_tpu_torch.core.stft import (effective_config, freq_axis,
                                              time_axis)
    from spectral_tpu_torch.models.batch import batch_unsupervised_detect
    from spectral_tpu_torch.ops.stft_cuda import stft_psd
    from spectral_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    groups, sigs = {}, {}
    out = {}
    for name in names:
        e = s.registry.data[name]
        sig = e.processed if e.processed is not None else e.raw
        if sig is None:
            out[name] = ValueError("no signal data")
            continue
        x = np.asarray(sig, np.float32)
        sigs[name] = x
        groups.setdefault((len(x), e.fs), []).append(name)
    for (n, fs), group in groups.items():
        cfg = effective_config(base_cfg, n)
        f = freq_axis(cfg, fs)
        t = time_axis(cfg, fs, n)
        try:
            if t.size == 0:
                raise ValueError("Not enough data to train the model. "
                                 "Signal may be too short.")
            xb = torch.as_tensor(np.stack([sigs[nm] for nm in group]),
                                 device=dev)
            psd = stft_psd(xb, fs, cfg)
            fmin = cfg.fmin if cfg.fmin is not None else 0.0
            fmax = cfg.fmax if cfg.fmax is not None else float(f[-1])
            feats = ev_mod.features_from_psd(f, psd, fmin, fmax)
            # per-clip fault isolation: a NaN/Inf feature row (overflowed
            # f32 power, non-finite samples) skips THAT sweep with the
            # sequential path's message instead of failing the group —
            # batch_unsupervised_detect refuses whole batches otherwise
            finite = torch.isfinite(feats.reshape(len(group), -1)).all(
                dim=1).cpu().numpy()
            bad_err = ValueError(
                "features contain NaN/Inf; if the input waveform is "
                "finite, its power overflows float32 analysis — rescale "
                "the signal (the analysis is scale-invariant)")
            for nm in (nm for nm, ok in zip(group, finite) if not ok):
                out[nm] = bad_err
            group = [nm for nm, ok in zip(group, finite) if ok]
            if not group:
                continue
            keep = torch.as_tensor(finite, device=dev)
            results = batch_unsupervised_detect(t, feats[keep],
                                                device=str(dev))
        except ValueError as e:
            for nm in group:
                out[nm] = e
            continue
        for nm, evs in zip(group, results):
            out[nm] = evs
    return out


def _detect_each(args) -> int:
    """Per-sweep unsupervised detection: a fresh HMM per sweep (the
    reference's persistent model only makes sense within one plot), printed
    as `sweep<TAB>start<TAB>end` lines plus an optional combined CSV in the
    reference's schema (ExportManager.py:43-50 columns; IBI restarts per
    sweep; sweep index parsed as the reference does). --batched runs
    same-length groups as one launch of each kernel."""
    from spectral_tpu_torch.api.session import AnalysisSession
    from spectral_tpu_torch.config import ViewSettings
    from spectral_tpu_torch.io.registry import split_display_name
    s = AnalysisSession(warm_detection=False, device=_device(args))
    names = []
    for p in args.files:
        try:
            names += s.load(p)
        except FileNotFoundError:
            sys.exit(f"error: file not found: {p}")
        except ValueError as e:
            sys.exit(f"error: {e}")
    if not names:
        sys.exit("no sweeps loaded")
    batched = (_detect_each_batched(s, names, _make_config(args),
                                    _device(args))
               if args.batched else None)
    rows = []
    for name in names:
        if batched is not None:
            got = batched.get(name)
            if isinstance(got, Exception) or got is None:
                print(f"{name}\tskipped: {got}", file=sys.stderr)
                continue
            events = got
        else:
            s.reset_model()
            try:
                # plot inside the per-sweep guard: a sweep whose PSD
                # overflows f32 (session overflow check) must skip like
                # any other per-sweep failure, not abort the whole fleet
                s.plot_sweeps([name], _make_config(args),
                              ViewSettings(mode_proc="Spectrogram",
                                           mode_raw="Spectrogram"))
                events = s.unsupervised_detect()
            except ValueError as e:       # e.g. sweep too short to train on
                print(f"{name}\tskipped: {e}", file=sys.stderr)
                continue
        base, sweep_idx = split_display_name(name)
        prev_end = None
        for a, b in events:
            print(f"{name}\t{a:.4f}\t{b:.4f}")
            ibi = float("nan") if prev_end is None else a - prev_end
            rows.append((base, sweep_idx if sweep_idx is not None else "",
                         a, b, ibi))
            prev_end = b
    if args.csv:
        if not rows:
            # consistent with the non---each path's export_events_csv:
            # zero events is an error, not a header-only "success"
            print("Error: No burst data to export.")
            return 1
        import csv as _csv
        # utf-8 regardless of locale (Source File carries arbitrary
        # names; surrogateescape round-trips ASCII-locale fsdecode)
        with open(args.csv, "w", newline="", encoding="utf-8",
                  errors="surrogateescape") as fh:
            w = _csv.writer(fh)
            w.writerow(["Burst ID", "Source File", "Sweep",
                        "Start Time (s)", "End Time (s)",
                        "Inter Burst Interval (s)"])
            for i, (base, idx, a, b, ibi) in enumerate(rows, 1):
                w.writerow([i, base, idx, a, b, ibi])
        print(f"Successfully exported {len(rows)} events to {args.csv}")
    return 0


def _probe_backend_reachable(timeout: float):
    """(reachable, detail): ``torch.cuda.is_available()`` run in a fresh
    subprocess killed after ``timeout`` seconds, so a driver that hangs
    in its initialisation cannot block the diagnosis. detail is '' when a
    card answered, else why not."""
    import subprocess
    code = ("import sys, torch; ok = torch.cuda.is_available(); "
            "print('ok' if ok else 'torch.cuda.is_available() is False'); "
            "sys.exit(0 if ok else 3)")
    try:
        r = subprocess.run([sys.executable, "-c", code], timeout=timeout,
                           capture_output=True, text=True)
    except subprocess.TimeoutExpired:
        return False, f"CUDA init still blocked after {timeout:.0f}s"
    if r.returncode == 0 and "ok" in r.stdout:
        return True, ""
    lines = ((r.stdout or "") + (r.stderr or "")).strip().splitlines()
    return False, lines[-1] if lines else "unknown init failure"


def _serve(stdin, stdout, *, max_sessions: int = 16,
           request_timeout: Optional[float] = None,
           max_request_bytes: int = 1 << 20,
           max_rss_mb: float = 8192.0, device: str = "cuda") -> int:
    """JSONL request/response worker over a stream pair.

    See _make_serve_loop for the protocol; this is the stdin/stdout
    entry (one stream pair, EOF or shutdown ends the worker)."""
    _make_serve_loop(max_sessions=max_sessions,
                     request_timeout=request_timeout,
                     max_request_bytes=max_request_bytes,
                     max_rss_mb=max_rss_mb, device=device)(stdin, stdout)
    return 0


def _serve_tcp(host: str, port: int, *, ready=None,
               max_sessions: int = 16,
               request_timeout: Optional[float] = None,
               max_request_bytes: int = 1 << 20,
               max_rss_mb: float = 8192.0,
               idle_timeout: Optional[float] = None,
               device: str = "cuda") -> int:
    """The same JSONL worker over TCP (no pipe relay needed): clients
    connect, speak the protocol, and disconnect; the warm state — the
    kernels' constants AND the LRU session cache — persists across
    connections, which is the point of a serving process. Connections
    are served one at a time (the device is a serial resource; requests
    from a second client queue in the TCP backlog). {"cmd": "shutdown"}
    stops the server; a client dropping mid-response does not.

    Binds host (default loopback — the protocol has no auth; front it
    with a real proxy for anything beyond a trusted host). port 0 picks
    an ephemeral port; `ready(actual_port)` is called once listening
    (tests and supervisors use it to learn the port)."""
    import socket
    run = _make_serve_loop(max_sessions=max_sessions,
                           request_timeout=request_timeout,
                           max_request_bytes=max_request_bytes,
                           max_rss_mb=max_rss_mb, device=device)
    srv = socket.create_server((host, port))
    actual = srv.getsockname()[1]
    print(f"serving on {host}:{actual}", file=sys.stderr)
    if ready is not None:
        ready(actual)
    try:
        while True:
            conn, _addr = srv.accept()
            outcome = "eof"
            with conn:
                if idle_timeout:
                    # connections are served ONE at a time, so a client
                    # that connects and then stalls mid-line would hold
                    # the server forever; a read/write past the idle
                    # bound raises TimeoutError (an OSError) below and
                    # the connection is dropped — the next client is
                    # served by the same warm worker
                    conn.settimeout(idle_timeout)
                fin = conn.makefile("r", encoding="utf-8", errors="replace")
                fout = conn.makefile("w", encoding="utf-8",
                                     errors="replace")
                try:
                    outcome = run(fin, fout)
                except (BrokenPipeError, ConnectionResetError, OSError):
                    continue          # client vanished/stalled; keep serving
            if outcome == "shutdown":
                return 0
    finally:
        srv.close()


class _SessionCache(collections.OrderedDict):
    """The serve worker's LRU session cache and the CUDA stream its
    requests run on. After a timeout the worker starts a new cache on a
    new stream, so the abandoned request, which may still be launching
    kernels, shares no session, tensor or stream with the requests that
    follow."""

    def __init__(self, device: str):
        super().__init__()
        self.stream = None
        if device != "cpu":
            import torch
            self.stream = torch.cuda.Stream()

    def running(self):
        """A context in which the current stream is this cache's."""
        if self.stream is None:
            return contextlib.nullcontext()
        import torch
        return torch.cuda.stream(self.stream)


def _make_serve_loop(*, max_sessions: int = 16,
                     request_timeout: Optional[float] = None,
                     max_request_bytes: int = 1 << 20,
                     max_rss_mb: float = 8192.0, device: str = "cuda"):
    """Build the JSONL worker loop (the serving shape for deployments:
    one warm process amortizes kernel builds, constants and session state
    across requests instead of paying them per CLI invocation). Every
    request computes on ``device``.

    Request:  one JSON object per line:
      {"cmd": "render"|"detect"|"learn"|"bands",
       "files": [...], "out": "x.png"?, "rois": [[a,b],...]?,
       "config": {SpecConfig fields}?, "combine": bool?}
      {"cmd": "render_batch", "files": [...], "out_dir": ...,
       "clip_seconds": 10.0?, "config": {...}?} — N clips rendered through
      the overlapped export pipeline, one launch of each kernel a batch,
      not N session round-trips.
      {"cmd": "detect_batch", "files": [...], "config": {...}?} — every
      sweep of the files, same-(length, fs) groups each detected in one
      launch of each kernel (`detect --each --batched` as a warm
      request); response {"results": {name: {events} | {error}}}.
      {"cmd": "stream_bands", "files": [...], "channel": 0?,
       "chunk_seconds": 60?, "config": {...}?} — hour-scale band-power
      analytics through the bounded-memory device fold (stream --bands
      as a warm request; the PSD is never materialized).
      {"cmd": "ping"} -> liveness; {"cmd": "stats"} -> worker health
      (requests/errors/timeouts/cache-trims served, cached sessions,
      RSS); {"cmd": "shutdown"} -> exit 0.
    Response: one JSON object per line: {"ok": true, ...result} or
      {"ok": false, "error": "..."}; errors never kill the worker. A
      config the kernels cannot compute (nperseg past 32,768) answers ok:
      false naming ROADMAP [large-nperseg].

    Robustness guards (each surfaces as an error response, never a crash):
      * sessions are cached per file-set with LRU eviction at
        `max_sessions`, so memory stays flat across many distinct inputs;
      * `request_timeout` bounds each request's wall clock. The stuck
        request runs on a daemon thread (it cannot block interpreter
        exit), and on timeout the WHOLE session cache is replaced, with
        a new CUDA stream — the abandoned thread keeps only orphaned
        state, so it can never race the replacement worker on a shared
        session, tensor, stream or the LRU dict;
      * lines over `max_request_bytes` are rejected before parsing;
      * `max_rss_mb` (0 = disabled) bounds process memory: when RSS
        crosses it, every cached constant and cached session is dropped
        (utils/memory.py — each config keeps its kernel operands, so a
        worker serving ever-new configs grows without a backstop).
    """
    import json as _json
    import threading as _threading
    from spectral_tpu_torch.api.session import AnalysisSession
    from spectral_tpu_torch.config import SpecConfig, ViewSettings
    from spectral_tpu_torch.utils.memory import maybe_trim_caches

    # The cache is passed INTO each request handler (not read from the
    # enclosing scope at call time) so that after a timeout the main loop
    # can swap in a fresh one: the abandoned thread holds a reference to
    # the old, orphaned one and cannot corrupt the live cache.
    sessions = _SessionCache(device)

    def get_session(files, cache):
        key = tuple(files)
        if key in cache:
            cache.move_to_end(key)
            return cache[key]
        s = AnalysisSession(warm_detection=False, device=device)
        for p in files:
            s.load(p)
        cache[key] = s
        while len(cache) > max_sessions:      # evict least-recently used
            cache.popitem(last=False)
        return s

    counters = {"requests": 0, "errors": 0, "timeouts": 0, "trims": 0}

    def handle(req, cache):
        cmd = req.get("cmd")
        if cmd == "ping":
            return {"ok": True, "pong": True}
        if cmd == "stats":
            # operational introspection for supervisors/monitoring: the
            # worker's own view of its health, no side effects
            from spectral_tpu_torch.utils.memory import rss_mb
            return {"ok": True, "requests": counters["requests"],
                    "errors": counters["errors"],
                    "timeouts": counters["timeouts"],
                    "cache_trims": counters["trims"],
                    "sessions_cached": len(cache),
                    "rss_mb": round(rss_mb(), 1)}
        if cmd == "render_batch":
            from spectral_tpu_torch.io.wav import wav_info
            from spectral_tpu_torch.parallel.pipeline import (
                export_spectrograms, registry_clip_source, registry_first_fs,
                wav_clip_source)
            files = req["files"]
            cfg = SpecConfig(**req.get("config", {}))
            all_wav = all(f.lower().endswith(".wav") for f in files)
            if all_wav:
                fs = wav_info(files[0])[2]   # header-only: no full decode
                source = wav_clip_source(files)
            else:    # ABF/NIX/NPZ datasets, one clip per sweep
                fs = registry_first_fs(files[0])
                source = registry_clip_source(files, fs)
            clip_s = float(req.get("clip_seconds", 10.0))
            stats = export_spectrograms(
                source, fs, cfg, req["out_dir"],
                clip_samples=int(clip_s * fs),
                batch=min(len(files), int(req.get("batch", 64))),
                compress_level=int(req.get("compress_level", 1)),
                device=device)
            return {"ok": True, "written": stats.pngs_written,
                    "seconds_audio": stats.seconds_audio}
        if cmd == "stream_bands":
            # long-recording analytics over serve: the device-resident
            # fold (stream_band_powers) — bounded working memory, no PSD
            # materialization — instead of the session's monolithic plot.
            # Same overflow/underflow refusal contract as `stream --bands`
            from spectral_tpu_torch.io.registry import SweepRegistry
            from spectral_tpu_torch.parallel.streaming import (
                stream_band_powers)
            r = SweepRegistry()
            names: list = []
            for p in req["files"]:
                names += r.load_file(p)
            ch = int(req.get("channel", 0))
            if not 0 <= ch < len(names):
                raise ValueError(f"channel {ch} out of range "
                                 f"({len(names)} sweep(s))")
            sig, fs = r.get_signal(names[ch], processed=True)
            cfg = SpecConfig(**req.get("config", {}))
            hop = cfg.hop_
            chunk = max(-(-cfg.nperseg // hop) * hop,
                        int(float(req.get("chunk_seconds", 60.0)) * fs)
                        // hop * hop)
            sig = np.asarray(sig, np.float32)
            bp, total = stream_band_powers(sig, fs, cfg, chunk,
                                           device=device)
            if ((not np.isfinite(total)
                 or not all(np.isfinite(v) for v in bp.values()))
                    and np.isfinite(sig).all()):
                raise ValueError(
                    "spectral power overflows float32: rescale the "
                    "recording by a power of two (e.g. x * 2**-40)")
            if total == 0.0 and np.isfinite(sig).all():
                adet = float(np.abs(
                    sig - sig.mean(dtype=np.float64)).max())
                if 0.0 < adet < 1e-10:
                    raise ValueError(
                        "spectral power underflows float32: rescale the "
                        "recording by a power of two (e.g. x * 2**80)")
            return {"ok": True, "sweep": names[ch],
                    "bands": {k: float(v) for k, v in bp.items()},
                    "total_power": float(total)}
        if cmd == "detect_batch":
            # fleet detection: every sweep of the cached session's files,
            # same-(length, fs) groups in one launch of each kernel (the
            # serve-side twin of `detect --each --batched`); per-sweep
            # failures isolate as {"error": ...} entries
            s = get_session(req["files"], cache)
            cfg = SpecConfig(**req.get("config", {}))
            results = _detect_each_batched(s, s.registry.names(), cfg,
                                           device)
            return {"ok": True, "results": {
                name: ({"error": str(v)} if isinstance(v, Exception)
                       else {"events": v})
                for name, v in results.items()}}
        if cmd in ("render", "detect", "learn", "bands"):
            s = get_session(req["files"], cache)
            cfg = SpecConfig(**req.get("config", {}))
            names = (s.registry.names() if req.get("combine")
                     else s.registry.names()[:1])
            s.plot_sweeps(names, cfg,
                          ViewSettings(combine=bool(req.get("combine")),
                                       mode_proc="Spectrogram",
                                       mode_raw="Spectrogram"))
            # the exporters swallow failures into "Error ..." status
            # strings (reference ExportManager semantics); ok must reflect
            # them — a client checking "ok" must not treat a failed export
            # as success (same rule as the CLI's _status)
            _ok = lambda m: not str(m).startswith("Error")  # noqa: E731
            if cmd == "render":
                msg = s.export_png(req["out"])
                resp = {"ok": _ok(msg), "message": msg}
            elif cmd == "detect":
                resp = {"ok": True, "events": s.unsupervised_detect()}
            elif cmd == "learn":
                rois = [tuple(r) for r in req["rois"]]
                resp = {"ok": True, "events": s.learn_and_detect(rois)}
            else:
                resp = {"ok": True, "bands": s.calculate_band_powers(),
                        "total_power": s.calculate_absolute_power()}
            if req.get("csv"):
                resp["csv"] = s.export_csv(req["csv"])
                if not _ok(resp["csv"]):
                    resp["ok"] = False
            return resp
        return {"ok": False, "error": f"unknown cmd: {cmd!r}"}

    def handle_on(req, cache):
        """handle() with the cache's stream current."""
        with cache.running():
            return handle(req, cache)

    def handle_with_timeout(req, cache):
        """Run handle() on a daemon thread bounded by request_timeout.
        Returns (resp, timed_out). A daemon thread — unlike a
        ThreadPoolExecutor worker — is not joined by the interpreter's
        atexit hook, so a permanently wedged request can't stop the
        process from exiting after shutdown/EOF."""
        box = {}

        def target():
            try:
                box["resp"] = handle_on(req, cache)
            except Exception as e:
                box["exc"] = e

        th = _threading.Thread(target=target, daemon=True,
                               name="serve-request")
        th.start()
        th.join(request_timeout)
        if th.is_alive():
            return None, True
        if "exc" in box:
            raise box["exc"]
        return box["resp"], False

    def run(stdin, stdout) -> str:
        """Drive one stream pair; returns 'shutdown' or 'eof' so a
        multi-connection server (_serve_tcp) knows whether to keep
        accepting. The warm state (sessions, constants) lives in the
        enclosing scope and survives across calls."""
        nonlocal sessions
        for line in stdin:
            line = line.strip()
            if not line:
                continue
            counters["requests"] += 1
            try:
                nbytes = len(line.encode("utf-8", "surrogatepass"))
                if nbytes > max_request_bytes:  # BYTES, as the name says:
                    # len(str) undercounts non-ASCII payloads by up to 4x
                    raise ValueError(
                        f"request exceeds max_request_bytes "
                        f"({nbytes} > {max_request_bytes})")
                req = _json.loads(line)
                if req.get("cmd") == "shutdown":
                    stdout.write(_json.dumps({"ok": True, "bye": True})
                                 + "\n")
                    stdout.flush()
                    return "shutdown"
                if not request_timeout:      # None or 0 = no timeout
                    resp = handle_on(req, sessions)
                else:
                    resp, timed_out = handle_with_timeout(req, sessions)
                    if timed_out:
                        # Abandon the stuck daemon thread WITH its state:
                        # it keeps the old cache, its stream and whatever
                        # session it was mutating; the live loop starts
                        # fresh.
                        sessions = _SessionCache(device)
                        counters["timeouts"] += 1
                        resp = {"ok": False,
                                "error": "TimeoutError: request exceeded "
                                         f"{request_timeout}s"}
            except Exception as e:  # a bad request must not kill the worker
                resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            if not resp.get("ok"):
                counters["errors"] += 1
            stdout.write(_json.dumps(resp) + "\n")
            stdout.flush()
            # memory backstop: drop cached constants AND cached sessions
            # (their device-resident PSD caches are the other big holder)
            if maybe_trim_caches(max_rss_mb):
                sessions.clear()
                counters["trims"] += 1
        return "eof"

    return run


def build_parser() -> argparse.ArgumentParser:
    """The CLI argument parser (separate from main so tests and the docs
    audit can validate command lines without dispatching them)."""
    ap = argparse.ArgumentParser(
        prog="spectral-tpu-torch",
        description="spectrogram / burst-detection toolkit on an NVIDIA "
                    "card (PyTorch and CUDA)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host CPU (the kernels' plain versions); "
                         "without it every command that computes needs a "
                         "CUDA card")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="spectrogram PNG from a recording")
    p.add_argument("files", nargs="+")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--cmap", default="jet")
    p.add_argument("--mels", type=int, default=0, help="mel bins (0 = linear)")
    p.add_argument("--decorated", action="store_true",
                   help="full figure with axes/colorbar/labels (matplotlib) "
                        "instead of the raw pixel image")
    p.add_argument("--transparent", action="store_true",
                   help="with --decorated: transparent background, legends "
                        "stripped (the reference's PNG export mode, "
                        "ExportManager.py:92-111)")
    p.add_argument("--dpi", type=int, default=150)
    _add_spec_args(p)

    p = sub.add_parser("detect", help="unsupervised burst detection")
    p.add_argument("files", nargs="+")
    p.add_argument("--csv", default=None, help="write burst table here")
    p.add_argument("--each", action="store_true",
                   help="detect every sweep independently (fresh model per "
                        "sweep; one combined table with sweep attribution)")
    p.add_argument("--batched", action="store_true",
                   help="with --each: fleet mode — same-length sweeps run "
                        "as one device dispatch of each kernel per group "
                        "(models/batch.py) instead of a round trip per "
                        "sweep")
    _add_spec_args(p)

    p = sub.add_parser("learn", help="learn-from-examples detection")
    p.add_argument("files", nargs="+")
    p.add_argument("--roi", action="append", required=True,
                   help="start:end seconds (repeatable)")
    p.add_argument("--csv", default=None)
    _add_spec_args(p)

    p = sub.add_parser("bands", help="EEG band powers")
    p.add_argument("files", nargs="+")
    _add_spec_args(p)

    p = sub.add_parser("export-batch", help="per-sweep waveform PNGs")
    p.add_argument("files", nargs="+")
    p.add_argument("-o", "--out-dir", required=True)
    p.add_argument("--proc", action="store_true")
    p.add_argument("--window-seconds", type=float, default=300.0,
                   help="fixed x-window like the reference's 0-300 s "
                        "(ExportManager.py:178); 0 sizes to each signal")

    p = sub.add_parser("grid", help="parameter-sweep grid: PSDs for every "
                                    "n_fft x window combo, one upload and "
                                    "one kernel launch per combo")
    p.add_argument("file")
    p.add_argument("-o", "--out", required=True, help="output .npz")
    p.add_argument("--n-ffts", default="256,1024,2048,4096",
                   help="comma-separated n_fft list (hop = n_fft/4)")
    p.add_argument("--windows", default="hann,hamming,tukey,blackman",
                   help="comma-separated window names")
    p.add_argument("--clip-seconds", type=float, default=0.0,
                   help="analyze only the first N seconds (0 = all)")
    p.add_argument("--channel", type=int, default=0)

    p = sub.add_parser("stream", help="chunked STFT for long recordings "
                                      "(bounded device memory)")
    p.add_argument("file")
    p.add_argument("-o", "--out", default=None,
                   help="output .npz (PSD + axes) or .png (dB image); "
                        "optional with --bands")
    p.add_argument("--chunk-seconds", type=float, default=60.0)
    p.add_argument("--scan", action="store_true",
                   help="device dispatch of 64-chunk blocks, each one "
                        "kernel launch, straight into one output on the "
                        "device")
    p.add_argument("--mesh", action="store_true",
                   help="with --scan: shard the recording's SAMPLE axis "
                        "over all devices (sequence parallelism; ROADMAP "
                        "[multi-device], refused with more than one "
                        "device). Ignored with a single device")
    p.add_argument("--bands", action="store_true",
                   help="fold EEG band powers on device instead of "
                        "materializing the PSD (long-form analytics)")
    p.add_argument("--detect", action="store_true",
                   help="hour-scale unsupervised burst detection in "
                        "bounded memory: features folded on device "
                        "(never materializing the PSD), HMM on the "
                        "chunked kernels for long recordings")
    p.add_argument("--csv", default=None,
                   help="with --detect: write the burst table here")
    p.add_argument("--channel", type=int, default=0,
                   help="sweep/channel index for multi-channel files "
                        "(default 0, the reference's channel heuristic)")
    _add_spec_args(p, combine=False)

    p = sub.add_parser("export-specs",
                       help="high-throughput dataset export: recordings "
                            "(WAV clips, or ABF/NIX/NPZ one clip per "
                            "sweep) -> spectrogram PNGs through the "
                            "overlapped decode/device/encode pipeline")
    p.add_argument("files", nargs="+")
    p.add_argument("-o", "--out-dir", required=True)
    p.add_argument("--clip-seconds", type=float, default=10.0,
                   help="static clip length (shorter padded, longer cut)")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--cmap", default="jet")
    p.add_argument("--mels", type=int, default=0)
    p.add_argument("--pixel-format", choices=("palette", "rgb", "rgba"),
                   default="palette")
    p.add_argument("--compress-level", type=int, default=1)
    p.add_argument("--on-error", choices=("raise", "skip"), default="raise",
                   help="'skip' isolates per-clip decode/encode failures "
                        "instead of failing the whole dataset")
    p.add_argument("--shard", action="store_true",
                   help="shard each batch over ALL local devices (ROADMAP "
                        "[multi-device], refused with more than one "
                        "device; one device runs unsharded)")
    p.add_argument("--resume", action="store_true",
                   help="skip clips whose PNG already exists in the output "
                        "directory (writes are atomic, so after a killed "
                        "process presence proves completeness; survive "
                        "power loss too with --durable) — restartable "
                        "dataset jobs")
    p.add_argument("--durable", action="store_true",
                   help="fsync each PNG before its atomic rename "
                        "(~1.6 ms/file): resume-safe even across power "
                        "loss / kernel crash, not just a killed process")
    p.add_argument("--encode-workers", type=int, default=None,
                   help="parallel PNG encoders (default: one per host "
                        "CPU; scale explicitly when export is "
                        "encode-bound; see OPERATIONS.md)")
    p.add_argument("--encode-executor", choices=("thread", "process"),
                   default="thread",
                   help="'process' sidesteps the GIL for the encoder's "
                        "Python overhead (forkserver pool; wins when "
                        "encode binds and images are small)")
    p.add_argument("--stats-json", metavar="PATH", default=None,
                   help="also write the run's stats + per-stage breakdown "
                        "(device compute, D2H bytes/s, unpack, encode) as "
                        "one JSON object — the ops artifact for tuning "
                        "batch/workers/compression")
    _add_spec_args(p, combine=False)

    p = sub.add_parser("info", help="list sweeps in files")
    p.add_argument("files", nargs="+")

    p = sub.add_parser("serve", help="long-lived worker: read JSONL requests "
                                     "on stdin, answer on stdout (keeps "
                                     "kernel constants and sessions warm)")
    p.add_argument("--max-sessions", type=int, default=16,
                   help="LRU bound on cached per-file-set sessions")
    p.add_argument("--timeout", type=float, default=None,
                   help="per-request wall-clock limit in seconds")
    p.add_argument("--max-request-bytes", type=int, default=1 << 20,
                   help="reject request lines larger than this")
    p.add_argument("--max-rss-mb", type=float, default=8192.0,
                   help="drop cached kernel constants and cached sessions "
                        "when process RSS crosses this (0 disables); keeps "
                        "a worker serving ever-new configs bounded")
    p.add_argument("--tcp", type=int, default=None, metavar="PORT",
                   help="listen on TCP instead of stdin/stdout (same JSONL "
                        "protocol; warm state persists across connections; "
                        "0 picks an ephemeral port). No auth — bind "
                        "loopback (the default) or front with a proxy")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address for --tcp (default loopback)")
    p.add_argument("--idle-timeout", type=float, default=0.0,
                   help="--tcp only: drop a connection whose next "
                        "read/write stalls longer than this (seconds; "
                        "0 disables) — connections are served one at a "
                        "time, so a stalled client otherwise holds the "
                        "server")

    p = sub.add_parser("doctor", help="environment self-check: backend, "
                                      "native components, numerical sanity")
    p.add_argument("--probe-link", action="store_true",
                   help="also measure launch latency and device->host "
                        "bandwidth")
    p.add_argument("--init-timeout", type=float, default=900.0,
                   help="bound CUDA init by probing it in a subprocess "
                        "first (a hung driver otherwise blocks the "
                        "process); 0 disables the probe")
    p.add_argument("--json", action="store_true",
                   help="machine-readable report (one JSON object) for "
                        "fleet supervisors; exit code semantics unchanged")

    p = sub.add_parser("gui", help="launch the Qt GUI client (needs PyQt5)")

    p = sub.add_parser("bench", help="throughput benchmark (refused until "
                                     "bench.py has a path for the port, "
                                     "ROADMAP [bench])")
    p.add_argument("--batch", type=int, default=256)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    # Status lines echo user-supplied paths; under a C/POSIX locale an
    # ascii stdout would raise UnicodeEncodeError on the first non-ASCII
    # name. Degrade the rendering (backslash escapes), never the command.
    for _stream in (sys.stdout, sys.stderr):
        if hasattr(_stream, "reconfigure"):
            try:
                _stream.reconfigure(errors="backslashreplace")
            except (ValueError, OSError):
                pass
    args = build_parser().parse_args(argv)
    try:
        return _dispatch(args)
    except FileNotFoundError as e:
        sys.exit(f"error: file not found: {getattr(e, 'filename', None) or e}")
    except ValueError as e:
        # domain errors (mixed sampling rates, bad --window, unsupported
        # file types, ...) exit cleanly instead of dumping a traceback
        sys.exit(f"error: {e}")
    except OSError as e:
        # filesystem errors on user-supplied paths (a directory named
        # like a recording, name too long, permission denied, ...) are
        # environment problems, not crashes
        sys.exit(f"error: {e}")


def _dispatch(args) -> int:
    if args.cmd not in _HOST_COMMANDS:
        _require_device(args)
    device = _device(args)

    if args.cmd == "info":
        from spectral_tpu_torch.io.registry import SweepRegistry
        r = SweepRegistry()
        for f in args.files:
            names = r.load_file(f)
            if not names:
                # a parseable file with nothing loadable (e.g. a NIX file
                # whose sweeps all lack a sampling rate, or an HDF5 file
                # with no 1-D datasets) must say so, not print nothing
                print(f"{f}: 0 sweeps")
            for n in names:
                e = r.data[n]
                nraw = len(e.raw) if e.raw is not None else 0
                nproc = len(e.processed) if e.processed is not None else 0
                # event-driven ABF sweeps carry an absolute recording time
                t0 = ("" if e.start_seconds is None
                      else f" t0={e.start_seconds:g}s")
                print(f"{n}: fs={e.fs:g} raw={nraw} processed={nproc}{t0}")
        return 0

    def _status(msg: str) -> int:
        """Print an exporter status string; the API swallows failures into
        'Error ...' strings, which must NOT exit 0 from a CLI."""
        print(msg)
        return 1 if msg.startswith("Error") else 0

    if args.cmd == "render":
        s, _ = _session_for(args.files, args)
        if args.decorated:
            from spectral_tpu_torch.render.figure import (
                render_session_figure)
            render_session_figure(s, path=args.out, dpi=args.dpi,
                                  colormap=args.cmap,
                                  transparent=args.transparent)
            print(f"Successfully exported decorated figure to {args.out}")
            return 0
        if args.transparent:
            sys.exit("error: --transparent requires --decorated (the raw "
                     "pixel image has no background to make transparent)")
        return _status(s.export_png(args.out, colormap=args.cmap))

    if args.cmd == "detect":
        if args.batched and not args.each:
            sys.exit("error: --batched requires --each (it batches the "
                     "per-sweep fleet flow)")
        if args.each:
            return _detect_each(args)
        s, _ = _session_for(args.files, args)
        events = s.unsupervised_detect()
        for a, b in events:
            print(f"{a:.4f}\t{b:.4f}")
        if args.csv:
            return _status(s.export_csv(args.csv))
        return 0

    if args.cmd == "learn":
        # parse the cheap string flags BEFORE loading files and computing
        # the spectrogram
        rois = []
        for spec in args.roi:
            try:
                a, b = spec.split(":")
                rois.append((float(a), float(b)))
            except ValueError:
                sys.exit(f"error: --roi expects start:end seconds, got {spec!r}")
        s, _ = _session_for(args.files, args)
        events = s.learn_and_detect(rois)
        for a, b in events:
            print(f"{a:.4f}\t{b:.4f}")
        if args.csv:
            return _status(s.export_csv(args.csv))
        return 0

    if args.cmd == "bands":
        s, _ = _session_for(args.files, args)
        bp = s.calculate_band_powers()
        print(json.dumps({k: round(v, 6) for k, v in bp.items()},
                         ensure_ascii=False, indent=2))
        return 0

    if args.cmd == "grid":
        from spectral_tpu_torch.config import SpecConfig
        from spectral_tpu_torch.core.stft import freq_axis, time_axis
        from spectral_tpu_torch.io.registry import SweepRegistry
        from spectral_tpu_torch.parallel.sweep_grid import sweep_grid
        r = SweepRegistry()
        try:
            names = r.load_file(args.file)
        except FileNotFoundError:
            sys.exit(f"error: file not found: {args.file}")
        if not 0 <= args.channel < len(names):
            sys.exit(f"error: --channel {args.channel} out of range "
                     f"(file has {len(names)} sweep(s))")
        sig, fs = r.get_signal(names[args.channel], processed=True)
        x = np.asarray(sig, np.float32)
        if args.clip_seconds > 0:
            x = x[:int(args.clip_seconds * fs)]
        try:
            n_ffts = [int(v) for v in args.n_ffts.split(",") if v]
            windows = [w.strip() for w in args.windows.split(",") if w]
            configs = [SpecConfig(nperseg=n, hop=max(1, n // 4), window=w,
                                  detrend="none")
                       for n in n_ffts for w in windows]
        except ValueError as e:
            sys.exit(f"error: bad grid spec: {e}")
        if not configs:
            sys.exit("error: empty grid (need at least one n_fft and one "
                     "window)")
        if any(n > len(x) for n in n_ffts):
            sys.exit(f"error: n_fft larger than the signal "
                     f"({len(x)} samples)")
        psds = sweep_grid(x, fs, configs, device=device)
        payload = {}
        for cfg_i, psd in zip(configs, psds):
            w = cfg_i.window if isinstance(cfg_i.window, str) \
                else cfg_i.window[0]
            key = f"psd_{cfg_i.nperseg}_{w}"
            payload[key] = psd.cpu().numpy().T           # freq-major
            payload[f"f_{cfg_i.nperseg}"] = freq_axis(cfg_i, fs)
            payload[f"t_{cfg_i.nperseg}"] = time_axis(cfg_i, fs, len(x))
        np.savez(args.out, fs=fs, **payload)
        print(f"Wrote {len(configs)}-combo grid "
              f"({len(n_ffts)} n_fft x {len(windows)} windows) to "
              f"{args.out}")
        return 0

    if args.cmd == "stream":
        import torch
        from spectral_tpu_torch.core.stft import freq_axis, time_axis
        from spectral_tpu_torch.io.registry import SweepRegistry
        from spectral_tpu_torch.parallel.streaming import (
            scan_spectrogram, stream_band_powers, stream_spectrogram)
        r = SweepRegistry()
        try:
            names = r.load_file(args.file)
        except FileNotFoundError:
            sys.exit(f"error: file not found: {args.file}")
        if not 0 <= args.channel < len(names):
            sys.exit(f"error: --channel {args.channel} out of range "
                     f"(file has {len(names)} sweep(s))")
        try:
            # processed=True: processed-over-raw preference with raw
            # fallback, like every plotting command
            sig, fs = r.get_signal(names[args.channel], processed=True)
        except KeyError as e:
            sys.exit(f"error: {e}")
        cfg = _make_config(args)
        hop = cfg.hop_
        # chunk must be a multiple of hop AND >= nperseg; the floor is
        # ceil(nperseg/hop)*hop — bare nperseg is NEVER a hop multiple in
        # scipy-compat mode (hop = nperseg - nperseg//8)
        chunk = max(-(-cfg.nperseg // hop) * hop,
                    int(args.chunk_seconds * fs) // hop * hop)

        def _overflow_exit(values_finite: bool, any_nonzero: bool = True):
            """Same contract as the session plot path
            (api/session._check_power_health): a FINITE recording whose
            f32 power overflows must refuse with the lossless rescale
            hint instead of emitting inf/NaN analytics or pixels, and a
            tiny-but-real recording whose power UNDERFLOWS f32 to total
            zero must refuse (rescale up) instead of writing all-zero
            analytics/pixels the reference's f64 would not produce;
            non-finite SAMPLES propagate like the reference's math."""
            if not values_finite and np.isfinite(sig).all():
                sys.exit("error: spectral power overflows float32 "
                         f"(waveform amplitude ~{np.abs(sig).max():.3g}): "
                         "rescale the recording by a power of two (e.g. "
                         "x * 2**-40) — relative band powers and the "
                         "normalized display are invariant to the change")
            if not any_nonzero and np.isfinite(sig).all():
                adet = float(np.abs(
                    sig - sig.mean(dtype=np.float64)).max())
                if 0.0 < adet < 1e-10:
                    sys.exit("error: spectral power underflows float32 "
                             f"(waveform amplitude ~{adet:.3g}): rescale "
                             "the recording by a power of two (e.g. "
                             "x * 2**80) — relative band powers and the "
                             "normalized display are invariant to the "
                             "change")

        if args.bands:
            bp, total = stream_band_powers(np.asarray(sig, np.float32), fs,
                                           cfg, chunk, device=device)
            _overflow_exit(np.isfinite(total)
                           and all(np.isfinite(v) for v in bp.values()),
                           any_nonzero=total != 0.0)
            print(json.dumps({k: round(v, 6) for k, v in bp.items()},
                             ensure_ascii=False, indent=2))
            print(f"Total absolute power: {total:.6g}")
            if args.out is None:
                return 0
        if args.detect:
            from spectral_tpu_torch.parallel.streaming import stream_detect
            try:
                events = stream_detect(np.asarray(sig, np.float32), fs,
                                       cfg, chunk, device=device)
            except ValueError as e:
                sys.exit(f"error: {e}")
            for a, b in events:
                print(f"{a:.4f}\t{b:.4f}")
            if args.csv:
                # same exporter/columns as `detect --csv`; the stream flow
                # has no session, so hand it the minimal surface the
                # exporter reads (events + single-source attribution)
                from types import SimpleNamespace
                from spectral_tpu_torch.api.export import export_events_csv
                shim = SimpleNamespace(
                    last_detected_events=events, segment_map=[],
                    currently_plotted_items=[os.path.basename(args.file)])
                status = export_events_csv(args.csv, shim)
                print(status)
                if status.startswith("Error"):
                    return 1
            if args.out is None:
                return 0
        if args.out is None:
            sys.exit("error: -o/--out is required unless --bands or "
                     "--detect is given")
        if args.scan and args.mesh and _visible_devices(device) > 1:
            sys.exit(f"error: stream --scan --mesh over "
                     f"{_visible_devices(device)} devices (the time-sharded "
                     "scan) arrives with ROADMAP [multi-device]; drop --mesh "
                     "to scan on one device")
        # --mesh on one device is the single-device scan, as it is in the
        # JAX package
        streamer = scan_spectrogram if args.scan else stream_spectrogram
        psd = streamer(np.asarray(sig, np.float32), fs, cfg, chunk,
                       device=device)
        # --fmin/--fmax are honored like in render, but the mask (and for
        # PNG output the normalize/colormap too) runs ON DEVICE so only
        # the rows being written are copied back — a 1 h @ 48 kHz
        # full-band PSD is ~1.4 GB, the 0-30 Hz EEG band ~1/8 of that
        f_ax = freq_axis(cfg, fs)
        sxx_d = psd.transpose(-1, -2)                  # freq-major, device
        if cfg.fmin is not None or cfg.fmax is not None:
            from spectral_tpu_torch.core.stft import mask_band_rows
            f_ax, sxx_d = mask_band_rows(f_ax, sxx_d, cfg.fmin, cfg.fmax)
            if f_ax.size == 0:
                sys.exit("error: the requested --fmin/--fmax band contains "
                         "no frequency rows at this sampling rate")
        # one device-side reduction each; the npz/PNG writers below would
        # otherwise persist inf PSDs / laundered dB pixels silently
        _overflow_exit(bool(torch.isfinite(sxx_d).all()),
                       any_nonzero=bool((sxx_d != 0).any()))
        if args.out.endswith(".npz"):
            psd_np = np.ascontiguousarray(sxx_d.cpu().numpy().T)  # (T, Fb)
            np.savez(args.out, psd=psd_np, f=f_ax,
                     t=time_axis(cfg, fs, len(sig)), fs=fs)
            print(f"Wrote PSD {psd_np.shape} to {args.out}")
        else:
            from spectral_tpu_torch.core.scale import normalize
            from spectral_tpu_torch.ops.colormap import (
                apply_colormap_packed, unpack_rgba)
            from spectral_tpu_torch.render.png import encode_png
            # --log is honored like everywhere else
            img = normalize(sxx_d, log_scale=cfg.log_scale)
            packed = apply_colormap_packed(img, flip_rows=True)
            encode_png(unpack_rgba(packed), path=args.out, compress_level=4)
            scale = "dB" if cfg.log_scale else "linear"
            print(f"Wrote {scale} spectrogram image {tuple(img.shape)} to "
                  f"{args.out}")
        return 0

    if args.cmd == "export-specs":
        from spectral_tpu_torch.io.wav import wav_info
        from spectral_tpu_torch.parallel.pipeline import (
            export_spectrograms, registry_clip_source, registry_first_fs,
            wav_clip_source)
        cfg = _make_config(args)      # --mels handled for every mode there
        all_wav = all(f.lower().endswith(".wav") for f in args.files)
        if all_wav:
            # fs from the first file's HEADER (the pipeline is single-rate
            # by design; wav_clip_source decodes every clip anyway)
            fs = wav_info(args.files[0])[2]
        else:
            # ABF/NIX/NPZ datasets (the reference's own formats) go
            # through the registry loaders, one sweep per clip
            try:
                fs = registry_first_fs(args.files[0])
            except (OSError, ValueError, KeyError) as e:
                sys.exit(f"error: {e}")
        if args.shard and _visible_devices(device) > 1:
            sys.exit(f"error: export-specs --shard over "
                     f"{_visible_devices(device)} devices arrives with "
                     "ROADMAP [multi-device]; drop --shard to export on one "
                     "device")
        # --shard on one device runs unsharded
        n_already = 0
        if args.resume and all_wav:
            n_already = sum(
                1 for f in args.files if os.path.exists(os.path.join(
                    args.out_dir,
                    os.path.splitext(os.path.basename(f))[0] + ".png")))
        source = (wav_clip_source(args.files, on_error=args.on_error,
                                  skip_existing_in=(args.out_dir
                                                    if args.resume
                                                    else None))
                  if all_wav else
                  registry_clip_source(args.files, fs,
                                       on_error=args.on_error))
        stats = export_spectrograms(
            source,
            fs, cfg,
            args.out_dir, clip_samples=int(args.clip_seconds * fs),
            batch=args.batch, colormap=args.cmap,
            compress_level=args.compress_level,
            pixel_format=args.pixel_format, on_error=args.on_error,
            resume=args.resume, durable=args.durable,
            encode_workers=args.encode_workers,
            encode_executor=args.encode_executor, device=device)
        if args.stats_json:
            payload = {"clips": stats.clips, "batches": stats.batches,
                       "pngs_written": stats.pngs_written,
                       "failed": stats.failed,
                       "nonfinite": stats.nonfinite,
                       "skipped": stats.skipped,
                       "seconds_audio": round(stats.seconds_audio, 3),
                       "breakdown": stats.breakdown()}
            with open(args.stats_json, "w") as fh:
                json.dump(payload, fh, indent=1)
        suffix = f"; {stats.failed} failed" if stats.failed else ""
        if args.resume:
            # wav datasets know the skip count up front (decode-free file
            # stem check); registry datasets learn it from the pipeline's
            # staging-time recheck
            suffix += (f" (resume: {n_already if all_wav else stats.skipped}"
                       f" already existed)")
        print(f"Exported {stats.pngs_written} spectrogram PNG(s) "
              f"({stats.seconds_audio:.0f} s of audio) to "
              f"{args.out_dir}{suffix}")
        return 0

    if args.cmd == "export-batch":
        from spectral_tpu_torch.api.export import export_batch_signals_png
        from spectral_tpu_torch.io.registry import SweepRegistry
        r = SweepRegistry()
        names = []
        for f in args.files:
            names += r.load_file(f)
        print(export_batch_signals_png(args.out_dir, r, names,
                                       use_proc=args.proc, use_raw=not args.proc,
                                       window_seconds=args.window_seconds,
                                       device=device))
        return 0

    if args.cmd == "serve":
        # Pin the wire protocol to utf-8 regardless of locale: under a
        # C/POSIX locale sys.stdin decodes ascii, so a client sending a
        # non-ASCII path would raise UnicodeDecodeError inside the read
        # loop itself — killing the worker the protocol promises errors
        # never kill. errors="replace" turns malformed bytes into a JSON
        # parse failure -> per-request error response instead.
        guards = dict(max_sessions=args.max_sessions,
                      request_timeout=args.timeout,
                      max_request_bytes=args.max_request_bytes,
                      max_rss_mb=args.max_rss_mb, device=device)
        if args.tcp is not None:
            return _serve_tcp(args.host, args.tcp,
                              idle_timeout=args.idle_timeout or None,
                              **guards)
        for stream in (sys.stdin, sys.stdout):
            if hasattr(stream, "reconfigure"):
                try:
                    stream.reconfigure(encoding="utf-8", errors="replace")
                except (ValueError, OSError):
                    pass   # detached/unsupported stream: keep as-is
        return _serve(sys.stdin, sys.stdout, **guards)

    if args.cmd == "doctor":
        return _doctor(args)

    if args.cmd == "gui":
        from spectral_tpu_torch.gui.app import main as gui_main
        return gui_main(device=device)

    if args.cmd == "bench":
        # bench.py times the JAX package and imports jax, which the
        # card's machine does not have; the port never loads it
        sys.exit("error: the port's bench arrives with ROADMAP [bench] "
                 "(bench.py has no path for the port yet); time the port "
                 "with chip_smoke.py or tools/torch_route_times.py")

    return 1


def _doctor(args) -> int:
    """Environment self-check: the card, the kernels' build directory, the
    native encoder, PyQt5, a pure tone through the STFT kernel and, with
    --probe-link, the launch floor and the device-to-host rate."""
    as_json = getattr(args, "json", False)
    report = {"ok": False}

    def say(line: str) -> None:
        if not as_json:
            print(line)

    def finish(code: int) -> int:
        if as_json:
            print(json.dumps(report))
        return code

    if not args.cpu:
        if args.init_timeout > 0:
            reachable, detail = _probe_backend_reachable(args.init_timeout)
        else:
            import torch
            reachable = torch.cuda.is_available()
            detail = "" if reachable else "torch.cuda.is_available() is False"
        if not reachable:
            say("backend:        UNREACHABLE — CUDA init failed (no card "
                "visible?)")
            say(f"                {detail}")
            say("                rerun with --cpu for host-side checks")
            say("doctor: PROBLEMS FOUND")
            report.update(backend="UNREACHABLE", detail=detail)
            return finish(1)
    import time as _time

    import torch
    from spectral_tpu_torch.config import SpecConfig
    from spectral_tpu_torch.core.stft import freq_axis, power_spectrogram
    from spectral_tpu_torch.native import png_native
    from spectral_tpu_torch.ops.build import BUILD_DIR
    from spectral_tpu_torch.utils.device import resolve_device

    dev = resolve_device(_device(args))
    ok = True
    if dev.type == "cuda":
        names = [torch.cuda.get_device_name(i)
                 for i in range(torch.cuda.device_count())]
    else:
        names = ["cpu"]
    say(f"backend:        {dev.type} ({len(names)} device(s): "
        f"{', '.join(names[:4])}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda})")
    report.update(backend=dev.type, n_devices=len(names),
                  torch=torch.__version__, cuda=torch.version.cuda)
    built = sorted(p.name for p in BUILD_DIR.glob("*.so")) \
        if BUILD_DIR.is_dir() else []
    report["kernel_build"] = str(BUILD_DIR)
    say(f"kernel build:   {BUILD_DIR} ({len(built)} library file(s); "
        "kernels build there at first use)")
    native_ok = png_native.available()
    report["native_encoder"] = bool(native_ok)
    say(f"native encoder: {'ok (C++ zlib)' if native_ok else 'absent (PIL/stdlib fallback)'}")
    try:
        import PyQt5  # noqa: F401
        report["gui_client"] = True
        say("gui client:     PyQt5 available")
    except ImportError:
        report["gui_client"] = False
        say("gui client:     PyQt5 absent (headless CLI only)")

    # numerical sanity: a pure tone must peak at its own bin
    fs_t, f0 = 16000.0, 1000.0
    t = np.arange(16000) / fs_t
    x = np.sin(2 * np.pi * f0 * t).astype(np.float32)
    cfg = SpecConfig.north_star(1024, 256)
    psd = power_spectrogram(torch.as_tensor(x, device=dev), fs_t,
                            cfg).cpu().numpy()
    f = freq_axis(cfg, fs_t)
    peak = float(f[int(psd.mean(axis=0).argmax())])
    sane = abs(peak - f0) <= fs_t / 1024
    ok &= sane
    report["sanity_tone_peak_hz"] = round(peak, 1)
    report["sanity"] = bool(sane)
    say(f"sanity:         1 kHz tone peaks at {peak:.1f} Hz "
        f"({'ok' if sane else 'FAIL'})")

    if getattr(args, "probe_link", False):
        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        # the launch floor explains interactive latency; the D2H rate
        # explains export throughput (the pipeline is readback-bound
        # where the link is slow)
        xz = torch.zeros(600, dtype=torch.int32, device=dev)
        (xz + 1).cpu()                                  # warm the path
        floors = []
        for _ in range(5):
            sync()
            t0 = _time.perf_counter()
            (xz + 1).cpu()
            floors.append((_time.perf_counter() - t0) * 1000)
        report["dispatch_floor_ms"] = round(min(floors), 3)
        say(f"dispatch floor: {min(floors):.3f} ms "
            "(trivial launch + 600-int32 readback, best of 5)")
        base = torch.zeros((8 << 20) // 4, dtype=torch.float32, device=dev)
        (base * 2).cpu()                                # warm the path
        rates = []
        for _ in range(3):
            fresh = base * 2       # a NEW device buffer each round
            sync()
            t0 = _time.perf_counter()
            fresh.cpu()
            rates.append(8.0 / (_time.perf_counter() - t0))
        report["d2h_mb_per_s"] = round(max(rates), 1)
        say(f"d2h bandwidth:  {max(rates):.1f} MB/s "
            "(8 MB f32 fetch, best of 3)")

    report["ok"] = bool(ok)
    say("doctor: " + ("all good" if ok else "PROBLEMS FOUND"))
    return finish(0 if ok else 1)


if __name__ == "__main__":
    sys.exit(main())
