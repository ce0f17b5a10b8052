#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (spectral_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and triton; run it from the root of a checkout.
It builds every kernel of the port's main path from the sources in the
checkout, holds each kernel against its plain PyTorch version on the card,
drives the main path once at full size (1024 clips of 10 s at 16 kHz
through ``batched_spectrogram_fn`` at north_star 1024/256 log, the batch the
reference app's display spine runs), checks the result against scipy in
float64, and times kernel and plain paths with CUDA events.

Every phase that fails raises, so the script exits nonzero and prints no
result. Without a CUDA card, or without the package beside it, it fails.
The last line of its output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

FS = 16000.0
CLIP_SECONDS = 10.0
BATCH = 1024
REPS = 5
PSD_TOL = 5e-6          # max|Δ| per clip, relative to the clip's PSD max
IMAGE_TOL = 1e-6        # display image, same PSD in (shared scalars)
DB_TOL = 1e-3           # display contract against scipy float64
SAME_WORDS = 0.999      # packed words identical, else one LUT index apart


def require(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase(name):
    print(f"== {name}", flush=True)


def run_text(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def psd_err(got, want):
    """Largest |Δ| per clip over the clip's PSD max; both (B, T, F)."""
    import torch
    diff = torch.amax(torch.abs(got - want), dim=(1, 2))
    scale = torch.amax(torch.abs(want), dim=(1, 2)).clamp_min(1e-30)
    return float(torch.amax(diff / scale)), float(torch.amax(diff))


def word_index_range(words):
    """First and last LUT index of each packed word (duplicates of the jet
    table are neighbours)."""
    import numpy as np
    from spectral_tpu_torch.ops.colormap import _packed_lut_np
    lut = _packed_lut_np("jet", True).view(np.uint32)
    first = {}
    last = {}
    for i, w in enumerate(lut.tolist()):
        first.setdefault(w, i)
        last[w] = i
    w = np.asarray(words, np.uint32).ravel()
    uniq, inv = np.unique(w, return_inverse=True)
    lo = np.array([first[u] for u in uniq.tolist()])[inv]
    hi = np.array([last[u] for u in uniq.tolist()])[inv]
    return lo, hi


def check_words(got, want, what):
    """>= 99.9% identical words and never more than one LUT index apart."""
    import numpy as np
    a = got.cpu().numpy()
    b = want.cpu().numpy()
    same = float(np.mean(a == b))
    alo, ahi = word_index_range(a)
    blo, bhi = word_index_range(b)
    step = int(np.max(np.maximum(0, np.maximum(alo - bhi, blo - ahi))))
    require(same >= SAME_WORDS and step <= 1,
            f"{what}: {same:.6f} identical words, max index step {step}")
    return same


def db_error_vs_scipy(img_unflipped, x64):
    """bench.py's display-error formula: max |Δimage| x dB range against
    scipy.signal.spectrogram in float64 at north_star 1024/256 (Hann)."""
    import numpy as np
    from scipy.signal import spectrogram
    _f, _t, sxx = spectrogram(x64, fs=FS, window="hann", nperseg=1024,
                              noverlap=1024 - 256, nfft=1024, detrend=False,
                              scaling="density", mode="psd")
    norm = np.clip(sxx / (sxx.max() + 1e-20), 0.0, 1.0)
    db = np.nan_to_num(10.0 * np.log10(norm + 1e-12))
    rng_db = db.max() - db.min()
    oracle = (db - db.min()) / rng_db
    return float(np.max(np.abs(img_unflipped - oracle)) * rng_db)


def time_ms(fn):
    """Median of REPS CUDA-event timings after one warm-up, in ms."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        del out
    return sorted(times)[REPS // 2], times


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def toolchain():
    import torch
    phase("toolchain")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this run needs a CUDA card")
    sys.path.insert(0, HERE)
    # Triton's kernel cache goes into the checkout's build directory
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(HERE, "build", "triton"))
    import spectral_tpu_torch
    pkg = os.path.dirname(os.path.abspath(spectral_tpu_torch.__file__))
    require(pkg == os.path.join(HERE, "spectral_tpu_torch"),
            f"spectral_tpu_torch imported from {pkg}, not this checkout")
    import triton
    from spectral_tpu_torch.ops.build import find_nvcc
    nvcc = find_nvcc()
    require(nvcc is not None, "nvcc not found")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, triton {triton.__version__}")
    print(run_text([nvcc, "--version"]).splitlines()[-1])
    card = run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"]).splitlines()[0]
    print(card, flush=True)
    return card


def build_kernels():
    from spectral_tpu_torch.ops import build
    phase("build")
    info = build.build_library("stft_psd")
    print(f"stft_psd.cu -> {os.path.relpath(info['path'], HERE)} in "
          f"{info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  " + line.strip())
    build.load_library("stft_psd")


def kernel_cases(dev):
    import numpy as np
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.ops import display_triton as disp
    from spectral_tpu_torch.ops import stft_cuda
    from spectral_tpu_torch.parallel.sharding import finite_flags

    phase("kernels against their plain versions")
    rs = np.random.RandomState(1)
    n = int(FS * CLIP_SECONDS)
    north = SpecConfig.north_star(1024, 256, log_scale=True)
    scipy_cfg = SpecConfig.scipy_default(1024, log_scale=True)

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    def both(x, cfg, **kw):
        got = stft_cuda.stft_psd(x, FS, cfg, **kw)
        want = stft_cuda.stft_psd_reference(
            x, stft_cuda.dft_constants(cfg, FS, dev), cfg, **kw)
        torch.cuda.synchronize()
        return got, want

    def check_stats(got, want, what):
        psd_rel, _ = psd_err(got[0], want[0])
        scale = torch.amax(want[0], dim=(1, 2))
        lo = float(torch.amax(torch.abs(got[1] - want[1]) / scale))
        hi = float(torch.amax(torch.abs(got[2] - want[2]) / scale))
        require(psd_rel <= PSD_TOL and lo <= PSD_TOL and hi <= PSD_TOL,
                f"{what}: psd {psd_rel:.2e}, pmin {lo:.2e}, pmax {hi:.2e} "
                f"(relative to clip max)")
        print(f"{what}: psd {psd_rel:.2e}, pmin {lo:.2e}, pmax {hi:.2e}")

    x8 = on_card(rs.randn(8, n))
    t0 = time.perf_counter()
    got, want = both(x8, north, with_stats=True)
    print(f"first stft_psd launch (module load) {time.perf_counter() - t0:.2f}"
          " s")
    check_stats(got, want, "8 x 10 s, north_star 1024/256, with_stats")
    psd8, pmin8, pmax8 = got

    xs = on_card(rs.randn(4, n) + 3.0)           # DC offset: detrend works
    check_stats(*both(xs, scipy_cfg, with_stats=True),
                "scipy_default 1024 (hop 896, Tukey, constant detrend)")

    got, want = both(x8[:2], north, log10_out=True)
    lin_rel, _ = psd_err(10.0 ** got.double(), 10.0 ** want.double())
    require(lin_rel <= PSD_TOL, f"log10_out: {lin_rel:.2e}")
    print(f"log10_out (compared in linear units): {lin_rel:.2e}")

    xr = on_card(rs.randn(3, 40000))             # T = 153: ragged frame tile
    check_stats(*both(xr, north, with_stats=True), "ragged T = 153")
    check_stats(*both(xr, SpecConfig.north_star(256, 64), with_stats=True),
                "north_star 256/64")
    # nperseg 100: K not a multiple of the kernel's 16-sample stage
    check_stats(*both(xr, SpecConfig.scipy_default(100), with_stats=True),
                "scipy_default 100 (hop 88)")

    before = stft_cuda.launches
    psd0, lo0, hi0 = stft_cuda.stft_psd(on_card(rs.randn(2, 500)), FS, north,
                                        with_stats=True)
    require(tuple(psd0.shape) == (2, 0, 513) and stft_cuda.launches == before
            and float(lo0.abs().sum() + hi0.abs().sum()) == 0.0,
            "T = 0 gives empty PSD and zero extrema without a launch")
    print("T = 0: empty PSD, zero extrema, no launch")

    xn = rs.randn(2, 20000)
    xn[1, 5000] = np.nan
    xn = on_card(xn)
    psd_n, lo_n, hi_n = stft_cuda.stft_psd(xn, FS, north, with_stats=True)
    flags = finite_flags(xn, lo_n, hi_n).tolist()
    require(bool(torch.isnan(lo_n[1])) and bool(torch.isnan(hi_n[1]))
            and bool(torch.isfinite(lo_n[0])) and flags == [True, False],
            f"NaN sample: pmin {lo_n.tolist()}, pmax {hi_n.tolist()}, "
            f"finite {flags}")
    print("NaN sample: pmin and pmax NaN, finite [True, False]")

    for log_scale, flip, share in ((True, True, False), (True, False, False),
                                   (True, True, True), (True, False, True),
                                   (False, True, False)):
        kw = dict(log_scale=log_scale, share_max=share, flip_image=flip)
        img_k, rgb_k = disp.display_epilogue(psd8, pmin8, pmax8, **kw)
        img_p, rgb_p = disp.display_epilogue_reference(psd8, pmin8, pmax8,
                                                       **kw)
        torch.cuda.synchronize()
        err = float(torch.amax(torch.abs(img_k - img_p)))
        what = f"display log={log_scale} flip={flip} share_max={share}"
        require(err <= IMAGE_TOL, f"{what}: image {err:.2e}")
        same = check_words(rgb_k, rgb_p, what)
        print(f"{what}: image {err:.2e}, words identical {same:.6f}")


def main_path(dev, card):
    import numpy as np
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu.render.png import encode_png
    from spectral_tpu_torch.ops import display_triton as disp
    from spectral_tpu_torch.ops import stft_cuda
    from spectral_tpu_torch.ops.colormap import unpack_rgba
    from spectral_tpu_torch.parallel.sharding import (batched_spectrogram_fn,
                                                      finite_flags)

    phase(f"main path: {BATCH} clips x {CLIP_SECONDS:g} s at {FS:g} Hz")
    n = int(FS * CLIP_SECONDS)
    cfg = SpecConfig.north_star(1024, 256, log_scale=True)
    x_host = np.random.RandomState(0).randn(BATCH, n).astype(np.float32)
    x = torch.from_numpy(x_host).to(dev)
    fn = batched_spectrogram_fn(FS, cfg, flip_image=True)
    consts = stft_cuda.dft_constants(cfg, FS, dev)

    stft_cuda.launches = 0
    disp.launches = 0
    out = fn(x)
    torch.cuda.synchronize()
    counts = {"stft_psd": stft_cuda.launches,
              "display_epilogue": disp.launches}
    print(f"launches in the main-path run: {counts}")
    require(all(c >= 1 for c in counts.values()),
            f"a kernel of the path did not launch: {counts}")

    T, F = 622, 513
    require(tuple(out["psd"].shape) == (BATCH, T, F)
            and tuple(out["image"].shape) == (BATCH, F, T)
            and tuple(out["rgb_packed"].shape) == (BATCH, F, T)
            and out["rgb_packed"].dtype == torch.uint32
            and tuple(out["finite"].shape) == (BATCH,),
            "output shapes and dtypes")
    require(bool(out["finite"].all()), "every clip finite")
    require(bool(torch.isfinite(out["image"]).all())
            and float(out["image"].amin()) == 0.0
            and float(out["image"].amax()) == 1.0, "image spans [0, 1]")

    db_err = db_error_vs_scipy(
        out["image"][0].flip(0).cpu().numpy(), x_host[0].astype(np.float64))
    require(db_err <= DB_TOL, f"clip 0 vs scipy f64: {db_err:.3e} dB")
    print(f"clip 0 vs scipy float64: {db_err:.3e} dB (limit {DB_TOL:g})")

    # the plain path on the same card, same input
    psd_p, pmin_p, pmax_p = stft_cuda.stft_psd_reference(x, consts, cfg,
                                                         with_stats=True)
    stft_rel, stft_abs = psd_err(out["psd"], psd_p)
    require(stft_rel <= PSD_TOL, f"main-path psd vs plain: {stft_rel:.2e}")
    print(f"psd vs plain: {stft_rel:.2e} of clip max ({stft_abs:.3e} abs)")
    pmin_k = torch.amin(out["psd"], dim=(1, 2))
    pmax_k = torch.amax(out["psd"], dim=(1, 2))
    img_ref, _ = disp.display_epilogue_reference(
        out["psd"], pmin_k, pmax_k, log_scale=True, flip_image=True)
    disp_abs = float(torch.amax(torch.abs(out["image"] - img_ref)))
    require(disp_abs <= IMAGE_TOL, f"main-path image vs plain: {disp_abs:.2e}")
    print(f"image vs plain display on the same PSD: {disp_abs:.2e}")
    del img_ref
    _, rgb_p = disp.display_epilogue_reference(
        psd_p[:8], pmin_p[:8], pmax_p[:8], log_scale=True, flip_image=True)
    same = check_words(out["rgb_packed"][:8], rgb_p, "rgb_packed, 8 clips")
    print(f"rgb_packed of 8 clips vs the plain path: {same:.6f} identical")
    del psd_p, pmin_p, pmax_p, rgb_p

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "clip0.png")
        encode_png(unpack_rgba(out["rgb_packed"][0]), path)
        with open(path, "rb") as fh:
            head = fh.read(8)
    require(head == b"\x89PNG\r\n\x1a\n", "PNG signature")
    print("clip 0 PNG written, signature ok")

    phase(f"times (CUDA events, median of {REPS} after a warm-up; {card})")
    psd, pmin, pmax = out["psd"], pmin_k, pmax_k
    del out

    def plain_pipeline():
        p, lo, hi = stft_cuda.stft_psd_reference(x, consts, cfg,
                                                 with_stats=True)
        img, rgb = disp.display_epilogue_reference(p, lo, hi, log_scale=True,
                                                   flip_image=True)
        return p, img, rgb, finite_flags(x, lo, hi)

    disp_kw = dict(log_scale=True, flip_image=True)
    timings = {
        "stft_kernel": time_ms(lambda: stft_cuda.stft_psd(
            x, FS, cfg, with_stats=True)),
        "stft_plain": time_ms(lambda: stft_cuda.stft_psd_reference(
            x, consts, cfg, with_stats=True)),
        "display_kernel": time_ms(lambda: disp.display_epilogue(
            psd, pmin, pmax, **disp_kw)),
        "display_plain": time_ms(lambda: disp.display_epilogue_reference(
            psd, pmin, pmax, **disp_kw)),
        "pipeline_kernel": time_ms(lambda: fn(x)),
        "pipeline_plain": time_ms(plain_pipeline),
    }
    audio_h = BATCH * CLIP_SECONDS / 3600.0
    summary = {"card": card, "batch": BATCH, "peak_gib": round(
        torch.cuda.max_memory_allocated() / 2 ** 30, 3)}
    for name, (ms, reps) in timings.items():
        summary[name] = {"ms": ms, "ms_per_clip": ms / BATCH,
                         "audio_h_per_min": audio_h / (ms / 60000.0),
                         "reps_ms": reps}
        print(f"{name}: {ms:.3f} ms/batch, {ms / BATCH:.5f} ms/clip, "
              f"{audio_h / (ms / 60000.0):.1f} audio-h/min [{card}]")
    print(json.dumps({"times": summary}))
    return counts, {"stft_psd": stft_abs, "display_epilogue": disp_abs}, \
        timings


def main():
    import torch
    card = toolchain()
    dev = torch.device("cuda", 0)
    build_kernels()
    kernel_cases(dev)
    counts, errs, timings = main_path(dev, card)
    kernels = [
        {"name": "stft_psd", "route": "cuda",
         "source": "spectral_tpu_torch/ops/csrc/stft_psd.cu",
         "replaces": "spectral_tpu/ops/stft_pallas.py:217",
         "launches": counts["stft_psd"], "max_abs_err": errs["stft_psd"],
         "ms": timings["stft_kernel"][0],
         "plain_ms": timings["stft_plain"][0]},
        {"name": "display_epilogue", "route": "triton",
         "source": "spectral_tpu_torch/ops/display_triton.py",
         "replaces": "spectral_tpu/ops/stft_pallas.py:456",
         "launches": counts["display_epilogue"],
         "max_abs_err": errs["display_epilogue"],
         "ms": timings["display_kernel"][0],
         "plain_ms": timings["display_plain"][0]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
