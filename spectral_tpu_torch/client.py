"""Client for the serve worker's JSONL protocol.

The reference has no serving story at all (its only entry point is the
Qt GUI, GUI.py:588-598); `spectral-tpu-torch serve` is this framework's warm
worker (cli.py::_make_serve_loop documents the wire protocol), and this
module is the typed Python side of it, so callers never hand-assemble
protocol lines:

    from spectral_tpu_torch.client import ServeClient

    with ServeClient.tcp(7788) as c:                 # or .spawn(["--cpu"])
        events = c.detect(["rec.wav"], config={"nperseg": 1024})
        c.render(["rec.wav"], out="spec.png")
        print(c.stats())

Every method returns the response payload on ok=true and raises
ServeError (carrying the worker's error string) on ok=false — the
worker itself never dies on a bad request, so the error is always a
clean round trip.
"""

from __future__ import annotations

import json
import socket
import subprocess
import sys
from typing import List, Optional, Sequence, Tuple


class ServeError(RuntimeError):
    """The worker answered ok=false; str() is its error message."""


class ServeClient:
    """One connection to a serve worker (TCP) or an owned worker process
    (stdio). Requests are synchronous and ordered, matching the worker's
    sequential execution model."""

    def __init__(self, reader, writer, *, proc=None, sock=None):
        self._r = reader
        self._w = writer
        self._proc = proc
        self._sock = sock

    # ------------------------------------------------------------------
    # Constructors
    # ------------------------------------------------------------------

    @classmethod
    def tcp(cls, port: int, host: str = "127.0.0.1",
            timeout: Optional[float] = 300.0) -> "ServeClient":
        """Connect to a running `spectral-tpu-torch serve --tcp PORT`."""
        sock = socket.create_connection((host, port), timeout=timeout)
        f = sock.makefile("rw", encoding="utf-8", errors="replace")
        return cls(f, f, sock=sock)

    @classmethod
    def spawn(cls, extra_args: Sequence[str] = (),
              python: Optional[str] = None) -> "ServeClient":
        """Start an owned `spectral-tpu-torch serve` worker over pipes.

        extra_args go BEFORE `serve` when they are global flags the CLI
        defines there (only `--cpu` is) and after it otherwise, so
        spawn(["--cpu", "--max-sessions", "4"]) does what it looks like.
        The worker is torn down by close()/__exit__ (shutdown request,
        then kill as a backstop)."""
        pre = [a for a in extra_args if a == "--cpu"]
        post = [a for a in extra_args if a != "--cpu"]
        cmd = [python or sys.executable, "-m", "spectral_tpu_torch.cli",
               *pre, "serve", *post]
        proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE,
                                encoding="utf-8", errors="replace",
                                bufsize=1)
        return cls(proc.stdout, proc.stdin, proc=proc)

    # ------------------------------------------------------------------
    # Transport
    # ------------------------------------------------------------------

    def request(self, req: dict) -> dict:
        """One raw protocol round trip; raises ServeError on ok=false."""
        self._w.write(json.dumps(req) + "\n")
        self._w.flush()
        line = self._r.readline()
        if not line:
            raise ServeError("worker closed the connection")
        resp = json.loads(line)
        if not resp.get("ok"):
            raise ServeError(resp.get("error", "unknown error"))
        return resp

    def close(self, shutdown: bool = False) -> None:
        """Close the connection. shutdown=True asks the worker to exit
        first (stops a TCP server; an owned stdio worker is always shut
        down since nothing else can reach it)."""
        try:
            if shutdown or self._proc is not None:
                try:
                    self.request({"cmd": "shutdown"})
                except (ServeError, OSError, ValueError):
                    pass
        finally:
            for closer in (getattr(self._r, "close", None),
                           getattr(self._w, "close", None)):
                try:
                    if closer:
                        closer()
                except OSError:
                    pass
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
            if self._proc is not None:
                try:
                    self._proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    self._proc.kill()
                    self._proc.wait(timeout=5)   # reap; no zombie

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # Typed requests (cli.py::_make_serve_loop protocol)
    # ------------------------------------------------------------------

    def ping(self) -> bool:
        return bool(self.request({"cmd": "ping"}).get("pong"))

    def stats(self) -> dict:
        return self.request({"cmd": "stats"})

    def detect(self, files: Sequence[str], *, config: Optional[dict] = None,
               combine: bool = False, csv: Optional[str] = None
               ) -> List[Tuple[float, float]]:
        req = {"cmd": "detect", "files": list(files),
               "combine": combine}
        if config:
            req["config"] = config
        if csv:
            req["csv"] = csv
        return [tuple(e) for e in self.request(req)["events"]]

    def learn(self, files: Sequence[str],
              rois: Sequence[Tuple[float, float]], *,
              config: Optional[dict] = None, combine: bool = False,
              csv: Optional[str] = None) -> List[Tuple[float, float]]:
        req = {"cmd": "learn", "files": list(files),
               "rois": [list(r) for r in rois], "combine": combine}
        if config:
            req["config"] = config
        if csv:
            req["csv"] = csv
        return [tuple(e) for e in self.request(req)["events"]]

    def bands(self, files: Sequence[str], *, config: Optional[dict] = None,
              combine: bool = False) -> Tuple[dict, float]:
        req = {"cmd": "bands", "files": list(files), "combine": combine}
        if config:
            req["config"] = config
        resp = self.request(req)
        return resp["bands"], resp["total_power"]

    def render(self, files: Sequence[str], out: str, *,
               config: Optional[dict] = None, combine: bool = False) -> str:
        req = {"cmd": "render", "files": list(files), "out": out,
               "combine": combine}
        if config:
            req["config"] = config
        return self.request(req)["message"]

    def render_batch(self, files: Sequence[str], out_dir: str, *,
                     clip_seconds: float = 10.0,
                     config: Optional[dict] = None,
                     batch: int = 64, compress_level: int = 1) -> dict:
        req = {"cmd": "render_batch", "files": list(files),
               "out_dir": out_dir, "clip_seconds": clip_seconds,
               "batch": batch, "compress_level": compress_level}
        if config:
            req["config"] = config
        return self.request(req)

    def stream_bands(self, files: Sequence[str], *, channel: int = 0,
                     chunk_seconds: float = 60.0,
                     config: Optional[dict] = None) -> Tuple[dict, float]:
        """Hour-scale band powers via the bounded-memory streaming fold
        (the PSD is never materialized server-side)."""
        req = {"cmd": "stream_bands", "files": list(files),
               "channel": channel, "chunk_seconds": chunk_seconds}
        if config:
            req["config"] = config
        resp = self.request(req)
        return resp["bands"], resp["total_power"]

    def detect_batch(self, files: Sequence[str], *,
                     config: Optional[dict] = None) -> dict:
        """{sweep_name: {"events": [...]} | {"error": "..."}}"""
        req = {"cmd": "detect_batch", "files": list(files)}
        if config:
            req["config"] = config
        return self.request(req)["results"]
