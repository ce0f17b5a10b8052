"""Time the radix-2 FFT kernel against variants of its own source, on the card.

    python3 tools/torch_r2_variants.py [--only NAME ...]

Builds ``spectral_tpu_torch/ops/csrc/stft_psd.cu`` as it stands ("this") and
each variant below, a textual edit of the same source, with the port's nvcc
flags into ``build/r2_variants/`` (gitignored), and launches each through
its C entry ``stft_fft_psd_launch`` with the output allocated once: the
kernel alone, without the wrapper's host work. Configs: the display
spine's north_star 1024/256 on 1024 clips of 10 s (path 1), scipy_default
8192 on 256 clips of 60 s (path 2), and scipy_default at every power of two
from 32 to 8192 on 1024 clips of 10 s, each with the per-row extrema on.
Each kernel runs in two rounds, the variants in turn, CUDA events, median
of 5 after a warm-up. A variant's PSD of the first 16 clips is compared
with this build's: the design variants must be bitwise equal; the
ablations ("no_...") compute something else and only time a part.

Also times ``stft_psd`` itself beside the bare launch at path 1, the host
work the wrapper adds.

Needs one CUDA card. Prints one JSON line: the card's name and power
limit, each variant's ptxas registers and spills per instantiation, and
per config each variant's times and whether its PSD is this build's.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "spectral_tpu_torch", "ops", "csrc",
                      "stft_psd.cu")
OUT_DIR = os.path.join(ROOT, "build", "r2_variants")
FS = 16000.0
REPS = 5

TABLE = "constexpr int R2_LR[13] = {0, 0, 0, 0, 3, 3, 3, 3, 3, 3, 4, 4, 4};"
# name -> (what it changes, [(text in the source, replacement)])
VARIANTS = {
    "values8": (
        "8 values a thread (three stages a pass, 64 registers) at every size",
        [(TABLE, TABLE.replace("4, 4, 4}", "3, 3, 3}"))]),
    "values16": (
        "16 values a thread (four stages a pass, 128 registers) from 64",
        [(TABLE, TABLE.replace("3, 3, 3, 3, 3, 3", "3, 4, 4, 4, 4, 4"))]),
    "regs128": (
        "8 values a thread at 128 registers: half the warps an SM holds",
        [("static constexpr int MIN_BLOCKS = LR == 3 ? 2 : 1;",
          "static constexpr int MIN_BLOCKS = 1;")]),
    "not_alone": (
        "a block of one frame computes its frame and row at run time",
        [("constexpr bool ALONE = G::FRAMES == 1;",
          "constexpr bool ALONE = false;")]),
    "no_butterflies": (
        "ablation: the stages' butterflies and twiddle loads removed",
        [("      r2_butterfly(v[i], v[i | (1 << J)], w);",
          "      (void)w;")]),
    "no_bins": (
        "ablation: the epilogue computes and stores bin 0 only",
        [("  for (int f = u; f < F; f += P) {\n    const int g = f <= M ? f : "
          "K - f;",
          "  for (int f = u; f < 1; f += P) {\n    const int g = f <= M ? f : "
          "K - f;")]),
}


def build(name, src, nvcc, flags):
    """Compile src into build/r2_variants/<name>/ and load it; returns the
    library and nvcc's -Xptxas -v log."""
    folder = os.path.join(OUT_DIR, name)
    os.makedirs(folder, exist_ok=True)
    cu = os.path.join(folder, "stft_psd.cu")
    so = os.path.join(folder, "libstft_psd.so")
    with open(cu, "w") as fh:
        fh.write(src)
    proc = subprocess.run([nvcc, *flags, "-o", so, cu], capture_output=True,
                          text=True)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.stft_fft_psd_launch.argtypes = [ptr] * 7 + [
        i32, ctypes.c_longlong] + [i32] * 7 + [ptr]
    lib.stft_fft_psd_launch.restype = i32
    return lib, proc.stdout + proc.stderr


def ptxas(log):
    """{"LOG2M/values": "registers/spilled bytes"} of the radix-2
    instantiations."""
    rows, m, spill = {}, None, "?"
    for line in log.splitlines():
        entry = re.search(r"stft_fft_psd_kernelILi(\d+)ELi(\d+)E", line)
        if "Compiling entry" in line:
            m = (f"{entry.group(1)}/{2 ** int(entry.group(2))}" if entry
                 else None)
            spill = "?"
        elif m is not None and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif m is not None and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            rows[m] = f"{regs}/{spill}"
            m = None
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", choices=sorted(VARIANTS),
                    help="time these variants beside this build only")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_r2_variants: this needs a CUDA card")
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.core.stft import num_frames
    from spectral_tpu_torch.ops import build as port_build
    from spectral_tpu_torch.ops import stft_cuda

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = port_build.find_nvcc()
    if nvcc is None:
        raise SystemExit("torch_r2_variants: nvcc not found")
    flags = list(port_build.NVCC_FLAGS)
    with open(SOURCE) as fh:
        this_src = fh.read()
    names = ["this"] + list(args.only or VARIANTS)
    libs, regs = {}, {}
    for name in names:
        src = this_src
        for old, new in ([] if name == "this" else VARIANTS[name][1]):
            if old not in src:
                raise SystemExit(f"{name}: the source no longer holds "
                                 f"{old!r}")
            src = src.replace(old, new)
        t0 = time.perf_counter()
        libs[name], log = build(name, src, nvcc, flags)
        regs[name] = ptxas(log)
        print(f"{name}: built in {time.perf_counter() - t0:.1f} s, ptxas "
              f"(LOG2M/values: registers/spilled bytes) {regs[name]}",
              flush=True)

    dev = torch.device("cuda", 0)
    configs = ([("path 1 north_star 1024/256",
                 SpecConfig.north_star(1024, 256), 1024, 10.0),
                ("path 2 scipy_default 8192",
                 SpecConfig.scipy_default(8192), 256, 60.0)]
               + [(f"scipy_default {k}", SpecConfig.scipy_default(k), 1024,
                   10.0) for k in (2 ** b for b in range(5, 14))])
    batches = {}
    stream = torch.cuda.current_stream(dev).cuda_stream

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        reps = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            reps.append(start.elapsed_time(end))
        return sorted(reps)[REPS // 2]

    report = {"card": card, "ptxas": regs, "configs": {}}
    for label, cfg, clips, seconds in configs:
        if (clips, seconds) not in batches:
            batches.clear()
            gen = torch.Generator(device=dev).manual_seed(3)
            batches[clips, seconds] = torch.randn(
                (clips, int(FS * seconds)), generator=gen, device=dev)
        x = batches[clips, seconds]
        B, n = x.shape
        T = num_frames(n, cfg.nperseg, cfg.hop_)
        F = cfg.n_freqs
        fc = stft_cuda.fft_constants(cfg, FS, dev)
        out = torch.empty((B, T, F), device=dev)
        parts = torch.empty((2, B * T), device=dev)
        detrend = stft_cuda.DETREND_CODES[cfg.detrend]

        def launch(lib):
            err = lib.stft_fft_psd_launch(
                x.data_ptr(), fc.window.data_ptr(), fc.twiddles.data_ptr(),
                fc.wts.data_ptr(), out.data_ptr(), parts[0].data_ptr(),
                parts[1].data_ptr(), B, n, T, F, cfg.nperseg, cfg.hop_,
                detrend, 0, 1, stream)
            if err:
                raise SystemExit(f"{label}: launch failed with {err}")

        launch(libs["this"])
        torch.cuda.synchronize()
        want = out[:16].clone()
        row = {}
        for rnd in range(2):
            for name in (names if rnd == 0 else names[::-1]):
                ms = timed(lambda: launch(libs[name]))
                entry = row.setdefault(name, {"ms": []})
                entry["ms"].append(ms)
                entry["same_psd"] = bool(torch.equal(out[:16], want))
        if label.startswith("path 1"):
            row["stft_psd (wrapper)"] = {"ms": [timed(
                lambda: stft_cuda.stft_psd(x, FS, cfg, with_stats=True))]}
        report["configs"][label] = row
        print(label, {k: [round(t, 3) for t in v["ms"]]
                      for k, v in row.items()}, flush=True)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
