"""Time the mixed-radix FFT kernel against variants of its own source, on
the card.

    python3 tools/torch_mixed_variants.py [--only NAME ...] [--nperseg N ...]

Builds ``spectral_tpu_torch/ops/csrc/stft_psd.cu`` as it stands ("this") and
each variant below, a textual edit of the same source, with the port's nvcc
flags into ``build/mixed_variants/`` (gitignored), and launches each
through its C entry ``stft_mixed_fft_psd_launch`` with the output allocated
once: the kernel alone, without the wrapper's host work. Configs: paths 4,
5 and 6 of ``chip_smoke.py`` (scipy_default 8160, 8032 and 8160 under
linear detrend on 256 clips of 60 s) and scipy_default 96, 352, 992, 1184
and 4192 on 1024 clips of 10 s (several frames a block; the largest prime
11, 31, 37 and 131), or scipy_default at each ``--nperseg`` on 1024 clips
of 10 s, each with the per-row extrema on. Each kernel runs in
two rounds, the variants in turn, CUDA events, median of 5 after a
warm-up. A variant's PSD of the first 16 clips is compared with this
build's: the design variants must be bitwise equal; the ablations
("no_...") compute something else and only time a part.

Needs one CUDA card. Prints one JSON line: the card's name and power
limit, each variant's ptxas registers and spills per instantiation, and
per config each variant's times and whether its PSD is this build's.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "spectral_tpu_torch", "ops", "csrc",
                      "stft_psd.cu")
OUT_DIR = os.path.join(ROOT, "build", "mixed_variants")
FS = 16000.0
REPS = 5

# name -> (what it changes, [(text in the source, replacement)])
VARIANTS = {
    "rm8": (
        "every generic lane on 8 output pairs (the widest plans' width)",
        [("return p_max <= 7 ? 0 : (p_max <= MIX_NARROW_RADIX ? 4 : 8);",
          "return p_max <= 7 ? 0 : 8;")]),
    "one_kernel": (
        "one instantiation for every plan: generic code compiled in "
        "everywhere",
        [("return p_max <= 7 ? 0 : (p_max <= MIX_NARROW_RADIX ? 4 : 8);",
          "return p_max <= MIX_NARROW_RADIX ? 4 : 8;")]),
    "no_generic_sums": (
        "ablation: the generic passes' sums skipped (reads and writes kept)",
        [("#pragma unroll 1\n    for (int q = 1; q <= h; ++q) {",
          "#pragma unroll 1\n    for (int q = 1; q <= 0; ++q) {"),
         ("    for (int q = 1; q <= H; ++q, rq += RM) {",
          "    for (int q = 1; q <= 0; ++q, rq += RM) {")]),
    "no_odd_sums": (
        "ablation: the radix 3, 5 and 7 passes' sums skipped (loads, "
        "twiddles and stores kept)",
        [("      buf[base + m * L] = make_double2(ar - bi, ai + br);\n"
          "      if (m > 0) buf[base + (P - m) * L] = make_double2(ar + bi, "
          "ai - br);",
          "      buf[base + m * L] = y[m];\n"
          "      if (m > 0) buf[base + (P - m) * L] = y[P - m];")]),
    "no_scatter": (
        "ablation: the load writes the frame in natural order, not through "
        "perm",
        [("fbuf[perm[j]] = make_double2(", "fbuf[j] = make_double2(")]),
    "no_r2_butterflies": (
        "ablation: the radix-2 passes' butterflies and twiddle loads removed",
        [("      r2_butterfly(v[i], v[i | (1 << S)], w);",
          "      (void)w;")]),
    "no_bins": (
        "ablation: the epilogue computes and stores bin 0 only",
        [("  for (int g = u; 2 * g <= M; g += pf) {",
          "  for (int g = u; 2 * g <= 0; g += pf) {")]),
    "no_table_reads": (
        "ablation: the window, radix-2 twiddles, split rows and weights "
        "each read at one row",
        [("      const double2 w = win2[j];",
          "      const double2 w = win2[0];"),
         ("    const double2 w = tw[row + k + L * t];",
          "    const double2 w = tw[row];"),
         ("bin(g, a, b, g < M ? split[g] : make_double2(-1.0, 0.0), wts[g]);",
          "bin(g, a, b, g < M ? split[0] : make_double2(-1.0, 0.0), wts[0]);"),
         ("bin(f, b, a, f < M ? split[f] : make_double2(-1.0, 0.0), wts[f]);",
          "bin(f, b, a, f < M ? split[0] : make_double2(-1.0, 0.0), wts[0]);"
          )]),
}


def load(so):
    lib = ctypes.CDLL(so)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.stft_mixed_fft_psd_launch.argtypes = [ptr] * 5 + [i32] * 3 + [
        ptr] * 4 + [i32, ctypes.c_longlong] + [i32] * 7 + [ptr]
    lib.stft_mixed_fft_psd_launch.restype = i32
    return lib


def ptxas(log):
    """{"RMAX": "registers/spilled bytes"} of the mixed-radix kernel's
    instantiations."""
    rows, m, spill = {}, None, "?"
    for line in log.splitlines():
        entry = re.search(r"stft_mixed_fft_psd_kernelILi(\d+)E", line)
        if "Compiling entry" in line:
            m = entry.group(1) if entry else None
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
    ap.add_argument("--nperseg", type=int, nargs="*",
                    help="time scipy_default at these nperseg on 1024 clips "
                         "of 10 s instead")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_mixed_variants: this needs a CUDA card")
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.core.stft import num_frames
    from spectral_tpu_torch.ops import build as port_build
    from spectral_tpu_torch.ops import stft_cuda

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = port_build.find_nvcc()
    if nvcc is None:
        raise SystemExit("torch_mixed_variants: nvcc not found")
    flags = list(port_build.NVCC_FLAGS)
    with open(SOURCE) as fh:
        this_src = fh.read()
    names = ["this"] + list(args.only or VARIANTS)
    sources = {}
    for name in names:
        src = this_src
        for old, new in ([] if name == "this" else VARIANTS[name][1]):
            if src.count(old) != 1:
                raise SystemExit(f"{name}: the source holds {old!r} "
                                 f"{src.count(old)} times, not once")
            src = src.replace(old, new)
        sources[name] = src
    # one nvcc a variant, all at once
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        folder = os.path.join(OUT_DIR, name)
        os.makedirs(folder, exist_ok=True)
        cu = os.path.join(folder, "stft_psd.cu")
        with open(cu, "w") as fh:
            fh.write(sources[name])
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-o", os.path.join(folder, "libstft_psd.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, regs = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        libs[name] = load(os.path.join(OUT_DIR, name, "libstft_psd.so"))
        regs[name] = ptxas(log)
    print(f"built {len(names)} variants in {time.perf_counter() - t0:.1f} "
          f"s; ptxas (registers/spilled bytes) {regs}", flush=True)

    dev = torch.device("cuda", 0)
    s8160 = SpecConfig.scipy_default(8160)
    configs = ([("path 4 scipy_default 8160", s8160, 256, 60.0),
                ("path 5 scipy_default 8032", SpecConfig.scipy_default(8032),
                 256, 60.0),
                ("path 6 scipy_default 8160 linear",
                 dataclasses.replace(s8160, detrend="linear"), 256, 60.0)]
               + [(f"scipy_default {k}", SpecConfig.scipy_default(k), 1024,
                   10.0) for k in (96, 352, 992, 1184, 4192)])
    if args.nperseg:
        configs = [(f"scipy_default {k}", SpecConfig.scipy_default(k), 1024,
                    10.0) for k in args.nperseg]
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
        mc = stft_cuda.mixed_constants(cfg, FS, dev)
        out = torch.empty((B, T, F), device=dev)
        parts = torch.empty((2, B * T), device=dev)
        detrend = stft_cuda.DETREND_CODES[cfg.detrend]

        def launch(lib):
            err = lib.stft_mixed_fft_psd_launch(
                x.data_ptr(), mc.window.data_ptr(), mc.perm.data_ptr(),
                mc.twiddles.data_ptr(), mc.stages.ctypes.data,
                len(mc.stages), mc.split, mc.rader, mc.wts.data_ptr(),
                out.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(), B,
                n, T, F, cfg.nperseg, cfg.hop_, detrend, 0, 1, stream)
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
        report["configs"][label] = row
        print(label, {k: [round(t, 3) for t in v["ms"]]
                      for k, v in row.items()}, flush=True)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
