"""The port's boundaries: it never imports jax nor anything of the JAX
package, its entry points run on the card unless the caller asks for the
CPU, its plain versions run only for CPU tensors, a kernel that cannot be
built or launched raises instead of falling back, its contract dots run in
full float32, and chip_smoke.py refuses to report without a card.

A tensor on the ``meta`` device stands in for a CUDA tensor here: like a
CUDA tensor it does not lie on the CPU, so the wrappers must take the
kernel route for it.
"""

import ast
import dataclasses
import glob
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spectral_tpu_torch import SpecConfig  # noqa: E402
from spectral_tpu_torch.ops import build, display_cuda, stft_cuda  # noqa: E402
from spectral_tpu_torch.parallel import pipeline, sharding  # noqa: E402
from spectral_tpu_torch.parallel.sharding import (  # noqa: E402
    batched_spectrogram_fn)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 16000.0
NS_256 = SpecConfig.north_star(256, 64, log_scale=True)


def _run(code, cwd=REPO, env_extra=None, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO, **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_and_runs_without_jax():
    code = textwrap.dedent("""
        import json, pkgutil, sys
        sys.modules["jax"] = None          # any import of jax now fails
        import importlib
        import numpy as np
        import spectral_tpu_torch
        names = sorted(m.name for m in pkgutil.walk_packages(
            spectral_tpu_torch.__path__, "spectral_tpu_torch."))
        for name in names:
            importlib.import_module(name)
        from spectral_tpu_torch import SpecConfig
        from spectral_tpu_torch.parallel.sharding import (
            batched_spectrogram_fn)
        x = np.random.RandomState(0).randn(2, 4096).astype(np.float32)
        cfg = SpecConfig.north_star(256, 64, log_scale=True)
        out = batched_spectrogram_fn(16000.0, cfg, flip_image=True,
                                     device="cpu")(x)
        import os, tempfile
        from spectral_tpu_torch.parallel.pipeline import export_spectrograms
        with tempfile.TemporaryDirectory() as tmp:
            stats = export_spectrograms(
                [("a", x[0]), ("b", (x[1] * 9000).astype(np.int16))],
                16000.0, cfg, tmp, clip_samples=4096, batch=2,
                device="cpu", encode_workers=1)
            pngs = sorted(os.listdir(tmp))
        from spectral_tpu_torch.models.detector import BurstDetector
        ff = np.random.RandomState(0).randn(120, 2).astype(np.float32)
        ff[40:70, 0] += 5.0
        events = BurstDetector(device="cpu").unsupervised_detect(
            np.arange(120) * 0.5, ff)
        from spectral_tpu_torch.api.session import AnalysisSession
        from spectral_tpu_torch.io.wav import write_wav
        sig = 0.02 * np.random.RandomState(1).randn(60000)
        sig[20000:26000] += 0.5 * np.sin(0.04 * np.arange(6000))
        with tempfile.TemporaryDirectory() as tmp:
            write_wav(os.path.join(tmp, "rec.wav"), sig, 1000.0)
            session = AnalysisSession(device="cpu")
            plotted = session.plot_sweeps(
                session.load(os.path.join(tmp, "rec.wav")),
                SpecConfig.scipy_default(1024, fmin=0.0, fmax=30.0))
            session_events = session.unsupervised_detect()
            status = session.export_png(os.path.join(tmp, "s.png"))
            from spectral_tpu_torch import cli
            from spectral_tpu_torch.utils import memory
            cli_rc = cli.main(["--cpu", "render", os.path.join(tmp, "rec.wav"),
                               "-o", os.path.join(tmp, "c.png"),
                               "--scipy-compat", "--fmin", "0", "--fmax",
                               "30"])
            trimmed = memory.maybe_trim_caches(1.0)
        from spectral_tpu_torch.parallel.streaming import scan_spectrogram
        from spectral_tpu_torch.parallel.sweep_grid import (default_grid,
                                                            sweep_grid)
        streamed = scan_spectrogram(x[0], 16000.0, cfg, 1024,
                                    chunks_per_block=2, device="cpu")
        grid = sweep_grid(x[0], 16000.0, default_grid(n_ffts=(256,)),
                          device="cpu")
        loaded = [m for m in sys.modules
                  if m.startswith(("jax.", "jaxlib"))
                  or (m == "jax" and sys.modules[m] is not None)]
        reference = [m for m in sys.modules
                     if m == "spectral_tpu" or m.startswith("spectral_tpu.")]
        print(json.dumps({"modules": names, "jax": loaded,
                          "spectral_tpu": reference,
                          "triton": "triton" in sys.modules,
                          "shapes": {k: list(v.shape) for k, v in out.items()},
                          "finite": out["finite"].tolist(),
                          "pngs": pngs, "written": stats.pngs_written,
                          "events": len(events),
                          "plot": list(plotted.image.shape),
                          "session_events": len(session_events),
                          "status": status, "cli": cli_rc,
                          "trimmed": trimmed,
                          "streamed": list(streamed.shape),
                          "grid": [list(g.shape) for g in grid]}))
    """)
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["jax"] == [] and not report["triton"]
    assert report["spectral_tpu"] == []
    assert report["pngs"] == ["a.png", "b.png"] and report["written"] == 2
    assert "spectral_tpu_torch.parallel.pipeline" in report["modules"]
    assert "spectral_tpu_torch.ops.display_cuda" in report["modules"]
    assert "spectral_tpu_torch.parallel.sharding" in report["modules"]
    for name in ("core.events", "models.kmeans", "models.hmm",
                 "models.hmm_pscan", "models.detector", "models.batch",
                 "ops.hmm_cuda", "api.session", "api.export", "io.registry",
                 "io.abf", "io.nix", "native.build", "native.png_native",
                 "render.figure", "render.waveform", "parallel.streaming",
                 "parallel.sweep_grid", "gui.app", "gui.controller", "cli",
                 "client", "utils.memory", "utils.metrics", "utils.device"):
        assert f"spectral_tpu_torch.{name}" in report["modules"]
    assert report["events"] >= 1
    assert report["plot"] == [31, 66] and report["session_events"] >= 1
    assert report["status"].startswith("Successfully")
    assert report["cli"] == 0 and report["trimmed"] is True
    assert report["shapes"] == {"psd": [2, 61, 129], "image": [2, 129, 61],
                                "rgb_packed": [2, 129, 61], "finite": [2]}
    assert report["finite"] == [True, True]
    assert report["streamed"] == [61, 129]
    assert report["grid"] == [[61, 129]] * 4


def test_plain_dots_run_in_ieee_float32(monkeypatch):
    seen = []
    real = torch.matmul

    def spy(*args, **kwargs):
        seen.append((torch.get_float32_matmul_precision(),
                     torch.backends.cuda.matmul.allow_tf32))
        return real(*args, **kwargs)

    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        monkeypatch.setattr(torch, "matmul", spy)
        x = torch.from_numpy(np.random.RandomState(0).randn(2, 4096)
                             .astype(np.float32))
        batched_spectrogram_fn(FS, NS_256, device="cpu")(x)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(before)
    assert len(seen) == 2
    assert all(p == "highest" and not tf32 for p, tf32 in seen)


def _fail(*args, **kwargs):
    raise AssertionError("the plain version ran for a non-CPU tensor")


def test_cpu_tensors_never_touch_the_kernels(monkeypatch):
    def no_kernel(*args, **kwargs):
        raise AssertionError("a kernel was loaded for a CPU tensor")

    monkeypatch.setattr(build, "load_library", no_kernel)
    monkeypatch.setattr(display_cuda, "_library", no_kernel)
    launches = (dict(stft_cuda.launches), dict(display_cuda.launches))
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 4096)
                         .astype(np.float32))
    for cfg in (NS_256, SpecConfig.scipy_default(2048, log_scale=True)):
        for palette in (False, True):
            out = batched_spectrogram_fn(FS, cfg, palette=palette,
                                         device="cpu")(x)
            assert out["finite"].tolist() == [True, True]
    assert (stft_cuda.launches, display_cuda.launches) == launches


def test_stft_kernel_failure_propagates(monkeypatch):
    def broken(name):
        raise RuntimeError(f"cannot build {name}")

    monkeypatch.setattr(build, "load_library", broken)
    monkeypatch.setattr(stft_cuda, "stft_psd_reference", _fail)
    # the pipeline's device: a stand-in for the card
    monkeypatch.setattr(sharding, "resolve_device",
                        lambda device: torch.device("meta"))
    x = torch.empty((2, 8192), device="meta")
    for cfg in (NS_256, SpecConfig.scipy_default(8192)):
        with pytest.raises(RuntimeError, match="cannot build stft_psd"):
            stft_cuda.stft_psd(x, FS, cfg, with_stats=True)
        with pytest.raises(RuntimeError, match="cannot build stft_psd"):
            batched_spectrogram_fn(FS, cfg)(x)
    # unsupported configs raise before any device question; a transform
    # past 8192 is a config like any other and needs the library
    with pytest.raises(NotImplementedError):
        stft_cuda.stft_psd(x, FS, SpecConfig.scipy_default(65536))
    with pytest.raises(RuntimeError, match="cannot build stft_psd"):
        stft_cuda.stft_psd(x, FS, SpecConfig.scipy_default(16384))


def test_display_kernel_failure_propagates(monkeypatch):
    def broken(name):
        raise RuntimeError(f"cannot build {name}")

    monkeypatch.setattr(build, "load_library", broken)
    monkeypatch.setattr(display_cuda, "_LIB", [])
    monkeypatch.setattr(display_cuda, "display_map_reference", _fail)
    monkeypatch.setattr(display_cuda, "clip_stats_reference", _fail)
    psd = torch.empty((2, 61, 129), device="meta")
    params = torch.empty((2, 3), device="meta")
    with pytest.raises(RuntimeError, match="cannot build display"):
        display_cuda.display_map(psd, params, log_scale=True)
    x = torch.empty((2, 4096), device="meta")
    with pytest.raises(RuntimeError, match="cannot build display"):
        display_cuda.clip_stats(x, torch.empty((2, 1, 2, 61), device="meta"))


def test_grad_on_cpu_tensors_never_touches_the_kernels(monkeypatch):
    """A waveform that requires grad on the CPU runs the plain forward and
    the plain backward of every Function: no library is loaded, no count
    moves."""
    from spectral_tpu_torch.ops import mel_cuda

    def no_kernel(*args, **kwargs):
        raise AssertionError("a kernel was loaded for a CPU tensor")

    monkeypatch.setattr(build, "load_library", no_kernel)
    for mod in (stft_cuda, display_cuda, mel_cuda):
        monkeypatch.setattr(mod, "_library", no_kernel)
    monkeypatch.setattr(stft_cuda, "_grad_library", no_kernel)
    counts = (stft_cuda.launches, stft_cuda.grad_launches,
              display_cuda.launches, display_cuda.grad_launches,
              mel_cuda.launches, mel_cuda.grad_launches)
    before = [dict(c) for c in counts]
    mel_cfg = SpecConfig.north_star(256, 64, log_scale=True, n_mels=16)
    for cfg in (NS_256, mel_cfg, SpecConfig.scipy_default(2048)):
        x = torch.from_numpy(np.random.RandomState(1).randn(2, 4096)
                             .astype(np.float32)).requires_grad_()
        out = batched_spectrogram_fn(FS, cfg, device="cpu")(x)
        loss = out["image"].sum() + out["psd"].sum()
        if cfg.n_mels:
            loss = loss + out["mel"].sum()
        loss.backward()
        assert torch.isfinite(x.grad).all() and x.grad.abs().max() > 0
    z = stft_cuda.stft_complex(x, FS, NS_256)
    (z.real.sum() + z.imag.sum()).backward()
    assert [dict(c) for c in counts] == before


def _meta_stft(x, fs, cfg, log10_out, with_stats, kernel=None, pack=True,
               partials=False, band=None, out_mode=None):
    """_stft_psd_cuda's outputs on the meta device, as the card's shapes."""
    from spectral_tpu_torch.core.stft import num_frames
    T = num_frames(x.shape[-1], cfg.nperseg, cfg.hop_)
    lo, hi = stft_cuda.check_band(cfg, band)
    cplx = (out_mode or cfg.mode) in ("complex", "stft")
    out = torch.empty((x.shape[0], T, hi - lo), device="meta",
                      dtype=torch.complex64 if cplx else torch.float32)
    if partials:
        return out, torch.empty((2, 1, x.shape[0], T), device="meta")
    return out


class _FailingLib:
    """A kernel library whose every launch returns an error code."""

    def __getattr__(self, name):
        if name.endswith("error_string"):
            return lambda code: b"invalid argument"
        if name.endswith("workspace_bytes"):
            return lambda *args: 8
        return lambda *args: 1


class _NoStream:
    cuda_stream = 0


def _no_card(monkeypatch):
    """Let a wrapper pass torch.cuda's device and stream calls with a meta
    tensor, so that its launch is reached."""
    import contextlib
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _NoStream())


def test_stft_grad_kernel_failure_propagates(monkeypatch):
    """On a tensor off the CPU the backward launches stft_grad.cu's
    kernels and never reaches the plain backward: a library that cannot
    be built, or a launch that fails, raises through loss.backward()."""
    def broken(name):
        raise RuntimeError(f"cannot build {name}")

    monkeypatch.setattr(build, "load_library", broken)
    monkeypatch.setattr(stft_cuda, "_GRAD_LIB", [])
    monkeypatch.setattr(stft_cuda, "_stft_psd_cuda", _meta_stft)
    monkeypatch.setattr(stft_cuda, "stft_backward_reference", _fail)
    monkeypatch.setattr(stft_cuda, "stft_psd_reference", _fail)
    for cfg in (NS_256, SpecConfig.scipy_default(24),
                dataclasses.replace(NS_256, mode="magnitude")):
        x = torch.empty((2, 4096), device="meta", requires_grad=True)
        p = stft_cuda.stft_psd(x, FS, cfg)
        assert p.requires_grad
        with pytest.raises(RuntimeError, match="cannot build stft_grad"):
            p.sum().backward()
    z = stft_cuda.stft_complex(x, FS, NS_256)
    with pytest.raises(RuntimeError, match="cannot build stft_grad"):
        torch.view_as_real(z).sum().backward()
    # a launch that fails raises, naming the kernel: the radix-2 route's
    # adjoint, the GEMM route's small-K adjoint, and stft_backward_kernel
    # past the small-K configs
    monkeypatch.setattr(stft_cuda, "_grad_library", lambda: _FailingLib())
    _no_card(monkeypatch)
    p = stft_cuda.stft_psd_partials(x, FS, NS_256)[0]
    with pytest.raises(RuntimeError, match="stft_fft_backward kernel launch "
                                           "failed: invalid argument"):
        p.sum().backward()
    p = stft_cuda.stft_psd(x, FS, SpecConfig.scipy_default(24))
    with pytest.raises(RuntimeError, match="stft_small_backward kernel "
                                           "launch failed: invalid argument"):
        p.sum().backward()
    p = stft_cuda.stft_psd(x, FS, dataclasses.replace(
        SpecConfig.scipy_default(24), onesided=False))
    with pytest.raises(RuntimeError, match="stft_backward kernel launch "
                                           "failed: invalid argument"):
        p.sum().backward()


def test_mel_and_display_grad_kernel_failure_propagates(monkeypatch):
    from spectral_tpu_torch.core.mel import mel_filterbank
    from spectral_tpu_torch.ops import mel_cuda

    def broken(name):
        raise RuntimeError(f"cannot build {name}")

    monkeypatch.setattr(build, "load_library", broken)
    monkeypatch.setattr(mel_cuda, "_LIB", [])
    monkeypatch.setattr(display_cuda, "_LIB", [])
    monkeypatch.setattr(mel_cuda, "mel_backward_reference", _fail)
    monkeypatch.setattr(display_cuda, "display_backward_reference", _fail)
    spans = mel_cuda.mel_spans(mel_filterbank(8, 65, FS), "meta")
    with pytest.raises(RuntimeError, match="cannot build mel"):
        mel_cuda.mel_backward(torch.empty((2, 3, 8), device="meta"), spans)
    psd = torch.empty((2, 61, 129), device="meta")
    params = torch.empty((2, 3), device="meta")
    with pytest.raises(RuntimeError, match="cannot build display"):
        display_cuda.display_backward(torch.empty((2, 129, 61),
                                                  device="meta"),
                                      psd, params, log_scale=True)
    # a failed launch raises
    for mod in (mel_cuda, display_cuda):
        monkeypatch.setattr(mod, "_library", lambda: _FailingLib())
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="mel backward kernel launch "
                                           "failed"):
        mel_cuda.mel_backward(torch.empty((2, 3, 8), device="meta"), spans)
    with pytest.raises(RuntimeError, match="display backward kernel launch "
                                           "failed"):
        display_cuda.display_backward(torch.empty((2, 129, 61),
                                                  device="meta"),
                                      psd, params, log_scale=False)


def test_stft_kernel_refuses_what_it_cannot_take(monkeypatch):
    monkeypatch.setattr(build, "load_library", lambda name: None)
    monkeypatch.setattr(stft_cuda, "_library", lambda: None)
    meta64 = torch.empty((2, 4096), dtype=torch.float64, device="meta")
    with pytest.raises(TypeError, match="float32"):
        stft_cuda.stft_psd(meta64, FS, NS_256)
    with pytest.raises(ValueError, match="CUDA"):
        stft_cuda._stft_psd_cuda(torch.zeros(2, 4096), FS, NS_256, False,
                                 False)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        build.build_library("stft_psd")
    assert list(tmp_path.iterdir()) == []


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(0o755)
    return str(path)


def test_failed_build_raises_and_leaves_nothing(monkeypatch, tmp_path):
    out = tmp_path / "out"
    monkeypatch.setattr(build, "BUILD_DIR", out)
    nvcc = _fake_nvcc(tmp_path, "echo 'stft_psd.cu(1): error: boom' >&2\n"
                                "exit 2\n")
    monkeypatch.setattr(build, "find_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="boom"):
        build.build_library("stft_psd")
    assert list(out.iterdir()) == []


def test_build_is_cached_by_source_hash(monkeypatch, tmp_path):
    out = tmp_path / "out"
    monkeypatch.setattr(build, "BUILD_DIR", out)
    # a stand-in nvcc that writes its -o target and reports like ptxas
    nvcc = _fake_nvcc(tmp_path, textwrap.dedent("""\
        while [ "$1" != "-o" ]; do shift; done
        echo lib > "$2"
        echo 'ptxas info    : Used 126 registers' >&2
        """))
    monkeypatch.setattr(build, "find_nvcc", lambda: nvcc)
    first = build.build_library("stft_psd")
    assert "126 registers" in first["log"]
    assert first["path"] == str(build.library_path("stft_psd"))
    assert os.path.basename(first["path"]).startswith("libstft_psd_")
    again = build.build_library("stft_psd")
    assert again == {"path": first["path"], "seconds": 0.0, "log": ""}
    assert [p.name for p in out.iterdir()] == [os.path.basename(
        first["path"])]


def test_chip_smoke_refuses_without_a_card(tmp_path):
    proc = subprocess.run([sys.executable, os.path.join(REPO,
                                                        "chip_smoke.py")],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120, env=dict(os.environ,
                                                CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=alone,
                          capture_output=True, text=True, timeout=120,
                          env={k: v for k, v in os.environ.items()
                               if k != "PYTHONPATH"})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _imported_modules(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_chip_smoke_and_port_import_nothing_of_jax():
    """An AST scan: chip_smoke.py, every module of the port and the port's
    tools import neither jax nor any module of the JAX package."""
    paths = [os.path.join(REPO, "chip_smoke.py")] + sorted(glob.glob(
        os.path.join(REPO, "spectral_tpu_torch", "**", "*.py"),
        recursive=True)) + sorted(glob.glob(os.path.join(REPO, "tools",
                                                         "torch_*.py")))
    assert len(paths) > 15
    assert os.path.join(REPO, "tools", "torch_precision.py") in paths
    for sub in ("api", "gui", "io", "native", "render"):
        assert any(p.startswith(os.path.join(REPO, "spectral_tpu_torch", sub,
                                             "")) for p in paths), sub
    for name in ("parallel/streaming.py", "parallel/sweep_grid.py",
                 "gui/app.py", "gui/controller.py", "cli.py", "client.py",
                 "utils/memory.py", "utils/metrics.py", "utils/device.py"):
        assert os.path.join(REPO, "spectral_tpu_torch", name) in paths
    for path in paths:
        names = _imported_modules(path)
        bad = [n for n in names if n in ("jax", "jaxlib", "spectral_tpu")
               or n.startswith(("jax.", "jaxlib.", "spectral_tpu."))]
        assert not bad, (path, bad)
        assert all(n == "spectral_tpu_torch" or n.startswith(
            "spectral_tpu_torch.") for n in names
            if n.startswith("spectral_tpu")), path


def test_entry_points_run_on_the_card_by_default(monkeypatch, tmp_path):
    """batched_spectrogram_fn and export_spectrograms take device='cuda'
    unless told otherwise, and raise without a card instead of running
    on the CPU."""
    import inspect
    for fn in (sharding.batched_spectrogram_fn,
               pipeline.export_spectrograms):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        sharding.batched_spectrogram_fn(FS, NS_256)
    clips = [("a", np.zeros(4096, np.float32))]
    with pytest.raises(RuntimeError, match="is_available"):
        pipeline.export_spectrograms(clips, FS, NS_256, str(tmp_path),
                                     clip_samples=4096)
    assert list(tmp_path.iterdir()) == []


def test_streaming_and_grid_run_on_the_card_by_default(monkeypatch):
    """The streaming entry points and the sweep grid take device='cuda'
    unless told otherwise: a numpy signal goes to the card (here the
    ``meta`` stand-in, which must reach the STFT kernel's build and
    never its plain version), device='cpu' keeps it on the CPU, and
    without a card they raise before any work."""
    import inspect
    from spectral_tpu_torch.parallel import streaming, sweep_grid
    entries = (streaming.StreamingSTFT, streaming.BlockStreamingSTFT,
               streaming.ScanStreamer, streaming.stream_spectrogram,
               streaming.scan_spectrogram, streaming.stream_fold,
               streaming.stream_band_powers, streaming.iter_stream,
               streaming.stream_features, streaming.stream_detect,
               sweep_grid.sweep_grid)
    for fn in entries:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    x = np.random.RandomState(2).randn(8192).astype(np.float32)
    cfg = SpecConfig.north_star(256, 64)
    calls = (lambda **kw: streaming.scan_spectrogram(x, FS, cfg, 1024, **kw),
             lambda **kw: streaming.stream_spectrogram(x, FS, cfg, 1024,
                                                       **kw),
             lambda **kw: streaming.stream_features(x, FS, cfg, 1024, **kw),
             lambda **kw: streaming.stream_band_powers(x, FS, cfg, 1024,
                                                       **kw)[1],
             lambda **kw: next(streaming.iter_stream(iter([x[:1024]]), FS,
                                                     cfg, 1024, **kw))[0],
             lambda **kw: sweep_grid.sweep_grid(x, FS, [cfg], **kw)[0])
    for call in calls:
        out = call(device="cpu")
        if isinstance(out, tuple):
            out = out[1]
        assert not isinstance(out, torch.Tensor) or out.device.type == "cpu"
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        for call in calls:
            with pytest.raises(RuntimeError, match="is_available"):
                call()

    def broken(name):
        raise RuntimeError(f"cannot build {name}")

    monkeypatch.setattr(build, "load_library", broken)
    monkeypatch.setattr(stft_cuda, "_LIB", [])
    monkeypatch.setattr(stft_cuda, "stft_psd_reference", _fail)
    meta = torch.device("meta")
    monkeypatch.setattr(streaming, "resolve_device", lambda device: meta)
    monkeypatch.setattr(sweep_grid, "resolve_device", lambda device: meta)
    for call in calls:
        with pytest.raises(RuntimeError, match="cannot build stft_psd"):
            call()


# ---------------------------------------------------------------------------
# detection: the HMM kernels (ops/hmm_cuda.py) and the flows above them
# ---------------------------------------------------------------------------

def _bursty_features(T=150):
    f = np.random.RandomState(4).randn(T, 2).astype(np.float32) * 0.2
    f[50:90, 0] += 3.0
    return np.arange(T) * 0.5, f


def test_hmm_cpu_tensors_never_touch_the_kernels(monkeypatch):
    from spectral_tpu_torch.models import batch, hmm, hmm_pscan
    from spectral_tpu_torch.models.detector import BurstDetector
    from spectral_tpu_torch.ops import hmm_cuda

    def no_kernel(*args, **kwargs):
        raise AssertionError("an HMM kernel was reached for a CPU tensor")

    monkeypatch.setattr(build, "load_library", no_kernel)
    for name in ("_library", "fit_seq", "viterbi_seq", "viterbi_chunked",
                 "estep_chunked", "fit_chunked"):
        monkeypatch.setattr(hmm_cuda, name, no_kernel)
    before = dict(hmm_cuda.launches)
    t, f = _bursty_features()
    for engine in ("scan", "pscan"):
        det = BurstDetector(device="cpu", engine=engine)
        assert det.unsupervised_detect(t, f)
        assert det.learn_and_detect(t, f, [(20.0, 50.0)])
    assert batch.batch_unsupervised_detect(t, f[None], device="cpu")
    X = torch.from_numpy(f.astype(np.float64))
    p = hmm.init_params(f, 4, device="cpu")
    hmm_pscan.unsupervised_fit_decode(p, X, n_iter=2)
    hmm_pscan.score(p, X)
    assert hmm_cuda.launches == before


def test_hmm_kernel_failure_propagates(monkeypatch):
    """On a tensor off the CPU the models launch the kernels and never
    reach a plain version; a kernel that cannot be built raises through
    every entry point, _find_burst_in_roi's guard included."""
    from spectral_tpu_torch.models import detector, hmm, hmm_pscan
    from spectral_tpu_torch.ops import hmm_cuda

    def broken(name):
        raise RuntimeError(f"cannot build {name}")

    monkeypatch.setattr(build, "load_library", broken)
    monkeypatch.setattr(hmm_cuda, "_LIB", [])
    for mod, name in ((hmm, "_fit_plain"), (hmm, "_viterbi_plain"),
                      (hmm, "_e_step_stats_plain"),
                      (hmm_pscan, "_viterbi_plain"),
                      (hmm_pscan, "_e_step_stats_plain")):
        monkeypatch.setattr(mod, name, _fail)
    meta = torch.device("meta")
    monkeypatch.setattr(hmm, "resolve_device", lambda device: meta)
    monkeypatch.setattr(detector, "detection_device", lambda device: meta)
    X = torch.empty((2, 3000, 2), dtype=torch.float64, device=meta)
    p = hmm.HMMParams(*(torch.empty(s, dtype=torch.float64, device=meta)
                        for s in ((2, 4), (2, 4, 4), (2, 4, 2), (2, 4, 2))))
    for call in (lambda: hmm.fit(p, X), lambda: hmm.viterbi(p, X),
                 lambda: hmm_pscan.viterbi(p, X),
                 lambda: hmm_pscan.e_step_stats(p, X)):
        with pytest.raises(RuntimeError, match="cannot build hmm"):
            call()
    with pytest.raises(RuntimeError, match="cannot build hmm"):
        hmm.score(p, X)
    # the lattices have no kernel: a tensor off the CPU is refused
    lb = torch.empty((2, 3000, 4), dtype=torch.float64, device=meta)
    for call in (lambda: hmm.forward_log(p, lb),
                 lambda: hmm.backward_log(p, lb), lambda: hmm._e_step(p, X),
                 lambda: hmm_pscan.forward_log(p, lb),
                 lambda: hmm_pscan.backward_log(p, lb),
                 lambda: hmm_pscan.e_step(p, X)):
        with pytest.raises(ValueError, match="CPU tensors only"):
            call()
    t, f = _bursty_features()
    det = detector.BurstDetector()
    with pytest.raises(RuntimeError, match="cannot build hmm"):
        det.unsupervised_detect(t, f)
    with pytest.raises(RuntimeError, match="cannot build hmm"):
        det._find_burst_in_roi(f[40:100], t[40:100])


def test_hmm_kernels_refuse_what_they_cannot_take(monkeypatch):
    from spectral_tpu_torch.ops import hmm_cuda
    monkeypatch.setattr(hmm_cuda, "_library", lambda: None)

    def model(B, K, D, dtype=torch.float64, device="meta"):
        return tuple(torch.empty(s, dtype=dtype, device=device)
                     for s in ((B, K), (B, K, K), (B, K, D), (B, K, D)))

    X = torch.empty((2, 100, 2), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        hmm_cuda.viterbi_seq(X, model(2, 4, 2))
    with pytest.raises(ValueError, match="CUDA"):
        hmm_cuda.fit_seq(torch.zeros(2, 100, 2, dtype=torch.float64),
                         model(2, 4, 2, device="cpu"), 10, 1e-2)
    with pytest.raises(TypeError, match="float64"):
        hmm_cuda.viterbi_seq(X.float(), model(2, 4, 2))
    with pytest.raises(ValueError, match="shape"):
        hmm_cuda.viterbi_seq(X, model(3, 4, 2))
    with pytest.raises(ValueError, match="states"):
        hmm_cuda.estep_chunked(X, model(2, 9, 2), 64)
    with pytest.raises(ValueError, match="chunk length"):
        hmm_cuda.viterbi_chunked(X, model(2, 8, 2), 256)
    with pytest.raises(ValueError, match="n_iter"):
        hmm_cuda.fit_seq(X, model(2, 4, 2), -1, 1e-2)


def test_detection_entry_points_run_on_the_card_by_default():
    import inspect
    from spectral_tpu_torch.models import batch, detector, hmm
    assert inspect.signature(detector.BurstDetector).parameters[
        "device"].default == "auto"
    assert detector.detection_device("cpu") == torch.device("cpu")
    for fn in (batch.batch_unsupervised_detect,):
        assert inspect.signature(fn).parameters["device"].default == "auto"
    for fn in (hmm.init_params, hmm.supervised_fit, hmm.params_from_jax):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


# ---------------------------------------------------------------------------
# the interactive session (api/session.py, api/export.py)
# ---------------------------------------------------------------------------

def test_session_and_exports_run_on_the_card_by_default(monkeypatch,
                                                        tmp_path):
    """AnalysisSession, its detector and the batch export take the card
    unless told otherwise; without one the plot and the batch export
    raise, and the PNG export's status says why (it swallows errors into
    its status, as the reference does)."""
    import inspect
    from spectral_tpu_torch.api import export
    from spectral_tpu_torch.api.session import AnalysisSession
    from spectral_tpu_torch.io.registry import SweepEntry
    assert inspect.signature(AnalysisSession).parameters[
        "device"].default == "cuda"
    assert inspect.signature(export.export_batch_signals_png).parameters[
        "device"].default == "cuda"
    s = AnalysisSession()
    assert s.device == "cuda" and s.detector.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.RandomState(0).randn(4096).astype(np.float32)
    s.registry.register("a_sweep0", SweepEntry("f", 0, 1000.0, 1000.0, x,
                                               None))
    with pytest.raises(RuntimeError, match="is_available"):
        s.plot_sweeps(["a_sweep0"], SpecConfig(nperseg=256))
    s.last_image = np.zeros((4, 5), np.float32)
    assert "is_available" in s.export_png(str(tmp_path / "a.png"))
    with pytest.raises(RuntimeError, match="is_available"):
        s.export_batch_png(str(tmp_path / "b"), ["a_sweep0"])
    assert list(tmp_path.iterdir()) == []


def test_session_kernel_failure_propagates(monkeypatch):
    """On a tensor off the CPU the plot launches the STFT kernel and never
    reaches a plain version; a kernel that cannot be built raises out of
    plot_sweeps and leaves no plot behind."""
    from spectral_tpu_torch.api import session as sess
    from spectral_tpu_torch.io.registry import SweepEntry

    def broken(name):
        raise RuntimeError(f"cannot build {name}")

    monkeypatch.setattr(build, "load_library", broken)
    monkeypatch.setattr(stft_cuda, "_LIB", [])
    monkeypatch.setattr(stft_cuda, "stft_psd_reference", _fail)
    monkeypatch.setattr(sess, "resolve_device",
                        lambda device: torch.device("meta"))
    s = sess.AnalysisSession(device="cpu", warm_detection=False)
    x = np.random.RandomState(0).randn(4096).astype(np.float32)
    s.registry.register("a_sweep0", SweepEntry("f", 0, 1000.0, 1000.0, x,
                                               None))
    for cfg in (SpecConfig(nperseg=256),
                SpecConfig.scipy_default(512, fmin=0.0, fmax=50.0,
                                         n_mels=16)):
        with pytest.raises(RuntimeError, match="cannot build stft_psd"):
            s.plot_sweeps(["a_sweep0"], cfg)
        assert s.last_image is None and s._psd_cache is None
