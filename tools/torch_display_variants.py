"""Time the display map kernel of ``csrc/display.cu`` against textual
variants of its own source, on the card.

    python3 tools/torch_display_variants.py [--only NAME ...]

Builds ``spectral_tpu_torch/ops/csrc/display.cu`` as it stands ("this")
and each variant below (a textual edit that must match the source exactly
once), with the port's nvcc flags, one nvcc a variant, all at once, into
``build/display_variants/`` (gitignored), and launches each through
``display_map_launch`` on the same inputs, the outputs allocated once: a
PSD of 10^U(-9, -1) values, seeded, at the shapes of ``chip_smoke.py``'s
paths (path 1: 1024 clips x 622 frames x 513 bins, RGBA words and the
image, log and linear; path 2: 256 x 133 x 4097, RGBA words and the
image; path 3: one export batch, 64 x 622 x 513, palette words and no
image; path 10: 1024 x 7618 x 13, RGBA words and the image), the
per-clip operands from its extrema. Each config runs two rounds, the
variants in turn, CUDA events around runs of RUN launches over the count,
median of 5 after a warm-up. A variant's outputs for the first 16 clips
are compared with this build's: the design variants must be bitwise
equal; the ablations ("no_...") compute something else and only time a
part.

Needs one CUDA card. Prints one JSON line: the card's name and power
limit, each variant's ptxas registers and spills, and per config each
variant's times, whether its outputs are this build's, and the config's
bytes bound at 3.35 TB/s.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

from torch_kernel_variants import variant_source

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "spectral_tpu_torch", "ops", "csrc",
                      "display.cu")
OUT_DIR = os.path.join(ROOT, "build", "display_variants")
REPS = 5
RUN = 10
HBM_RATE = 3.35e12

BOUNDS = "__global__ void __launch_bounds__(DM_THREADS)\ndisplay_map_kernel("
PIXEL = ("  const float u = unit_clip(__fdiv_rn(v, s.denom));\n"
         "  if (!LOG) return u;")
RGBA_STORES = ("            if (with_image) img_row[t] = px;\n"
               "            if (MODE == MODE_RGBA) word_row[t] = "
               "s_lut[lut_index(px)];")
VARIANTS = {
    "six_blocks": (
        "at least six blocks an SM (at most 40 registers)",
        [(BOUNDS, BOUNDS.replace("(DM_THREADS)", "(DM_THREADS, 6)"))]),
    "eight_blocks": (
        "at least eight blocks an SM (at most 32 registers)",
        [(BOUNDS, BOUNDS.replace("(DM_THREADS)", "(DM_THREADS, 8)"))]),
    "streaming_stores": (
        "the image and RGBA words stored evict-first (st.global.cs)",
        [(RGBA_STORES,
          "            if (with_image) __stcs(img_row + t, px);\n"
          "            if (MODE == MODE_RGBA)\n"
          "              __stcs(word_row + t, s_lut[lut_index(px)]);")]),
    "no_math": (
        "ablation: the pixel is the PSD value (copies, shared reads, LUT "
        "and stores kept)",
        [(PIXEL, "  if (v == v) return v;\n" + PIXEL)]),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", choices=sorted(VARIANTS),
                    help="time these variants beside this build only")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_display_variants: this needs a CUDA card")
    from chip_smoke import radix2_ptxas
    from spectral_tpu_torch.ops import build as port_build
    from spectral_tpu_torch.ops.colormap import packed_lut
    from spectral_tpu_torch.ops.display_cuda import MODES, clip_params

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = port_build.find_nvcc()
    if nvcc is None:
        raise SystemExit("torch_display_variants: nvcc not found")
    with open(SOURCE) as fh:
        this_src = fh.read()
    names = ["this"] + list(args.only or VARIANTS)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        src = (this_src if name == "this" else
               variant_source(this_src, VARIANTS[name][1], name))
        folder = os.path.join(OUT_DIR, name)
        os.makedirs(folder, exist_ok=True)
        cu = os.path.join(folder, "display.cu")
        with open(cu, "w") as fh:
            fh.write(src)
        procs[name] = subprocess.Popen(
            [nvcc, *port_build.NVCC_FLAGS, "-o",
             os.path.join(folder, "libdisplay.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, regs = {}, {}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(os.path.join(OUT_DIR, name, "libdisplay.so"))
        lib.display_map_launch.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
        lib.display_map_launch.restype = i32
        libs[name] = lib
        regs[name] = radix2_ptxas(
            log, r"display_map_kernelILi(\d)ELb(\d)E",
            lambda e: f"<MODE {e.group(1)}, LOG {e.group(2)}>")
    print(f"built {len(names)} variants in {time.perf_counter() - t0:.1f} "
          f"s; ptxas {regs}", flush=True)

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    configs = [("path 1 rgba+image log", 1024, 622, 513, "rgba", 1, 1),
               ("path 1 rgba+image linear", 1024, 622, 513, "rgba", 0, 1),
               ("path 2 rgba+image log", 256, 133, 4097, "rgba", 1, 1),
               ("path 3 batch palette log", 64, 622, 513, "palette", 1, 0),
               ("path 10 rgba+image log", 1024, 7618, 13, "rgba", 1, 1)]
    gen = torch.Generator(device=dev).manual_seed(3)
    lut = packed_lut("jet", dev)
    report = {"card": card, "ptxas": regs, "run": RUN, "configs": {}}

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        reps = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(RUN):
                fn()
            end.record()
            torch.cuda.synchronize()
            reps.append(start.elapsed_time(end) / RUN)
        return sorted(reps)[REPS // 2]

    for label, B, T, F, mode, log_scale, with_image in configs:
        psd = torch.pow(10.0, torch.rand((B, T, F), generator=gen,
                                         device=dev) * 8.0 - 9.0)
        params = clip_params(psd.amin(dim=(1, 2)), psd.amax(dim=(1, 2)))
        image = (torch.empty((B, F, T), device=dev) if with_image
                 else None)
        width = -(-T // 4) if mode == "palette" else T
        words = torch.empty((B, F, width), dtype=torch.int32, device=dev)
        bytes_ = (B * T * F * 4 + B * 12 + (1024 if mode == "rgba" else 0)
                  + (B * F * T * 4 if with_image else 0)
                  + B * F * width * 4)

        def launch(lib):
            err = lib.display_map_launch(
                psd.data_ptr(), params.data_ptr(), lut.data_ptr(),
                None if image is None else image.data_ptr(),
                words.data_ptr(), B, T, F, MODES[mode], log_scale,
                with_image, 1, stream)
            if err:
                raise SystemExit(f"{label}: launch failed with {err}")

        launch(libs["this"])
        torch.cuda.synchronize()
        want = [words[:16].clone()] + (
            [image[:16].clone()] if image is not None else [])
        row = {}
        for rnd in range(2):
            for name in (names if rnd == 0 else names[::-1]):
                ms = timed(lambda: launch(libs[name]))
                entry = row.setdefault(name, {"ms": []})
                entry["ms"].append(ms)
                got = [words[:16]] + ([image[:16]] if image is not None
                                      else [])
                entry["same"] = all(torch.equal(g, w)
                                    for g, w in zip(got, want))
        report["configs"][label] = {"bound_ms": 1e3 * bytes_ / HBM_RATE,
                                    "variants": row}
        print(label, f"bound {1e3 * bytes_ / HBM_RATE:.4f} ms",
              {k: [round(t, 4) for t in v["ms"]] for k, v in row.items()},
              flush=True)
        del psd, image, words
        torch.cuda.empty_cache()
    print(json.dumps(report))


if __name__ == "__main__":
    main()
