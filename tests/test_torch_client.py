"""The port's serve client (spectral_tpu_torch/client.py), a copy of the
JAX package's held to the original's text: the one change is the module
``spawn`` runs (``-m spectral_tpu_torch.cli``), with the docstrings'
import line and command name following it. ``spawn`` owns a port worker
over pipes on the CPU and tears it down on close.
"""

import inspect
import os

import pytest

torch = pytest.importorskip("torch")

from spectral_tpu import client as jclient  # noqa: E402
from spectral_tpu_torch import client as tclient  # noqa: E402


def _text(mod):
    with open(mod.__file__, encoding="utf-8") as fh:
        return fh.read()


def test_client_is_the_original_but_the_module_it_spawns():
    want = (_text(jclient).replace("spectral_tpu.", "spectral_tpu_torch.")
            .replace("spectral-tpu serve", "spectral-tpu-torch serve"))
    assert _text(tclient) == want
    assert '"-m", "spectral_tpu_torch.cli"' in _text(tclient)
    assert "spectral_tpu." not in _text(tclient).replace(
        "spectral_tpu_torch.", "")


def test_client_surface_is_the_originals():
    def methods(cls):
        return {name: str(inspect.signature(fn))
                for name, fn in inspect.getmembers(cls, inspect.isroutine)
                if not name.startswith("__")}

    assert methods(tclient.ServeClient) == methods(jclient.ServeClient)
    assert issubclass(tclient.ServeError, RuntimeError)


def test_spawn_owns_a_port_worker_on_the_cpu():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    old = os.getcwd()
    os.chdir(repo)          # -m finds the package from the checkout
    try:
        with tclient.ServeClient.spawn(["--cpu", "--max-sessions", "2"]) as c:
            assert c._proc.args[1:] == ["-m", "spectral_tpu_torch.cli",
                                        "--cpu", "serve", "--max-sessions",
                                        "2"]
            assert c.ping()
            st = c.stats()
            assert st["sessions_cached"] == 0 and st["requests"] == 2
            with pytest.raises(tclient.ServeError, match="unknown cmd"):
                c.request({"cmd": "nonsense"})
    finally:
        os.chdir(old)
    assert c._proc.returncode == 0        # clean shutdown, not a kill
