"""Time the PyTorch port's STFT kernel at the display spine's batch, for one
checkout of the port.

    python3 tools/torch_route_times.py [--root DIR] [--route ROUTE]
                                       [--nperseg N ...] [--detrend D]
                                       [--paths [P ...]] [--sweep S]
                                       [--rader S] [--small]
                                       [--frames-alone] [--library]
                                       [--plain] [--ulp]

Imports ``spectral_tpu_torch`` from DIR (default: the checkout holding this
script), builds its STFT kernel from DIR's sources, and times
``stft_psd(x, fs, cfg, with_stats=True)`` on 1024 clips of 10 s at 16 kHz
for scipy_default 1024, north_star 1024/256 and scipy_default 992 (the
mixed-radix route), or scipy_default at each ``--nperseg`` given, under
each config's own detrend or ``--detrend``, with CUDA events, median of 5
after a warm-up. ``--paths`` times instead the STFT/PSD configs of
``chip_smoke.py``'s paths 1-11 at their batches (1024 clips of 10 s at
north_star 1024/256, the export's config too; 256 clips of 60 s at
scipy_default 8192, 8160, 8032, 8160 under linear detrend, 8191, 8185
and 8182; 1024 clips of 10 s at scipy_default 24), or those of the paths
numbered after it (path 11: scipy_default 8186 on 256 clips of 60 s);
``--sweep S`` every S-th nperseg from 32 to 8192 that the odd route takes
and every S-th the Bluestein route takes, at scipy_default; ``--rader S``
every S-th of the mixed route's 405 Rader plans (even nperseg whose half
is a prime past 255; 1 for all); ``--small`` nperseg 2-31, the GEMM
route's small-K tile. ``--nperseg``, ``--paths``, ``--sweep``, ``--rader``
and ``--small`` add up. ``--route`` (gemm,
fft, mixed, odd or bluestein) forces that kernel through ``stft_psd``'s
module-private ``_route`` on the configs that allow it and skips the
others; ``--route mixed`` also takes the
power-of-two configs, whose plan is all radix-2 stages, and reports the
largest difference from the radix-2 kernel's PSD relative to its max.
``--frames-alone`` launches the odd kernel with every frame transformed
alone (its packing off). ``--library`` also times each config's library
yardstick, ``chip_smoke.py::library_psd`` (cuFFT's float64 transform of
the same frames), which the port never calls; ``--plain`` the plain
version, ``stft_psd_reference`` (its float64 DFT matrices built first). ``--ulp`` also reports the
largest distance in float32 ulps of the first 64 clips' PSD from the
plain version, ``stft_psd_reference``, on the same clips. Pointed at an older checkout it times that
checkout's kernels, so one call on one card compares two versions: run it
for the older, this, this and the older again.

A launch that fails is reported as such for its config, and the others
run on. Needs one CUDA card. Prints one JSON line: the root, the card's name and
power limit, and per config the median, every repeat, the launch counts
the calls added and a SHA-256 of the first 64 clips' PSD bytes (equal
digests in two checkouts: bitwise-equal PSDs).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys

CLIPS = 1024
SECONDS = 10.0
FS = 16000.0
REPS = 5


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="the checkout to time")
    ap.add_argument("--route",
                    choices=("gemm", "fft", "mixed", "odd", "bluestein"),
                    help="force this kernel where the config allows it")
    ap.add_argument("--paths", type=int, nargs="*",
                    help="time chip_smoke.py's paths 1-11 configs and "
                         "batches, or the paths numbered")
    ap.add_argument("--sweep", type=int,
                    help="every S-th nperseg of the odd and Bluestein "
                         "routes")
    ap.add_argument("--rader", type=int,
                    help="every S-th of the mixed route's Rader plans")
    ap.add_argument("--small", action="store_true",
                    help="nperseg 2-31, the GEMM route's small-K tile")
    ap.add_argument("--frames-alone", action="store_true",
                    help="the odd kernel without its packing")
    ap.add_argument("--library", action="store_true",
                    help="time chip_smoke.py's cuFFT yardstick too")
    ap.add_argument("--plain", action="store_true",
                    help="time the plain version too")
    ap.add_argument("--ulp", action="store_true",
                    help="the PSD's float32 ulp distance from the plain "
                         "version")
    ap.add_argument("--nperseg", type=int, nargs="*",
                    help="time scipy_default at these nperseg instead")
    ap.add_argument("--detrend", choices=("none", "constant", "linear"),
                    help="replace each config's detrend")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_route_times: this needs a CUDA card")
    import spectral_tpu_torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.ops import stft_cuda
    pkg = os.path.dirname(os.path.abspath(spectral_tpu_torch.__file__))
    if pkg != os.path.join(root, "spectral_tpu_torch"):
        raise SystemExit(f"spectral_tpu_torch came from {pkg}, not {root}")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    batches = {}

    if args.library or args.ulp:
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        from chip_smoke import library_psd, ulp_distance

    def batch(clips, seconds):
        """Seeded noise, the same in every checkout and call."""
        if (clips, seconds) not in batches:
            gen = torch.Generator(device=dev).manual_seed(3)
            batches.clear()
            batches[clips, seconds] = torch.randn(
                (clips, int(FS * seconds)), generator=gen, device=dev)
        return batches[clips, seconds]

    report = {"root": root, "card": card, "clips": CLIPS,
              "seconds": SECONDS, "route": args.route,
              "detrend": args.detrend, "frames_alone": args.frames_alone}
    nperseg = list(args.nperseg or [])
    if args.sweep:
        for route in ("odd", "bluestein"):
            ks = [k for k in range(32, 8193)
                  if stft_cuda.route(SpecConfig.scipy_default(k)) == route]
            nperseg += ks[::args.sweep]
    if args.rader:
        from spectral_tpu_torch.core.stft import rader_prime
        ks = [k for k in range(32, 8193, 2)
              if stft_cuda.route(SpecConfig.scipy_default(k)) == "mixed"
              and rader_prime(k // 2)]
        nperseg += ks[::args.rader]
    if args.small:
        nperseg += list(range(2, 32))
    configs = [(f"scipy_default {k}", SpecConfig.scipy_default(k))
               for k in nperseg]
    if not configs and args.paths is None:
        configs = [("scipy_default 1024", SpecConfig.scipy_default(1024)),
                   ("north_star 1024/256", SpecConfig.north_star(1024, 256)),
                   ("scipy_default 992", SpecConfig.scipy_default(992))]
    if args.detrend:
        configs = [(f"{name} {args.detrend}",
                    dataclasses.replace(cfg, detrend=args.detrend))
                   for name, cfg in configs]
    shape = {name: (CLIPS, SECONDS) for name, _ in configs}
    if args.paths is not None:
        s8160 = SpecConfig.scipy_default(8160, log_scale=True)
        paths = [
            ("path 1 north_star 1024/256",
             SpecConfig.north_star(1024, 256, log_scale=True)),
            ("path 2 scipy_default 8192",
             SpecConfig.scipy_default(8192, log_scale=True)),
            ("path 4 scipy_default 8160", s8160),
            ("path 5 scipy_default 8032",
             SpecConfig.scipy_default(8032, log_scale=True)),
            ("path 6 scipy_default 8160 linear",
             dataclasses.replace(s8160, detrend="linear")),
            ("path 7 scipy_default 8191",
             SpecConfig.scipy_default(8191, log_scale=True)),
            ("path 8 scipy_default 8185",
             SpecConfig.scipy_default(8185, log_scale=True)),
            ("path 9 scipy_default 8182",
             SpecConfig.scipy_default(8182, log_scale=True)),
            ("path 10 scipy_default 24",
             SpecConfig.scipy_default(24, log_scale=True)),
            ("path 11 scipy_default 8186",
             SpecConfig.scipy_default(8186, log_scale=True))]
        paths = [(name, cfg) for name, cfg in paths
                 if not args.paths or int(name.split()[1]) in args.paths]
        shape.update({name: (CLIPS, SECONDS)
                      if name.startswith(("path 1 ", "path 10"))
                      else (256, 60.0) for name, _ in paths})
        configs = paths + configs
    for name, cfg in configs:
        x = batch(*shape[name])

        def call(v, cfg=cfg, route=args.route):
            if args.frames_alone and stft_cuda.route(cfg) == "odd":
                return stft_cuda._stft_psd_cuda(v, FS, cfg, False, True,
                                                "odd", pack=False)
            return stft_cuda.stft_psd(v, FS, cfg, with_stats=True,
                                      _route=route)
        if args.route == "mixed" and stft_cuda.route(cfg) == "fft":
            # route() never gives the mixed kernel a power of two, where its
            # plan is all radix-2 stages: launch it through the wrapper's
            # internal entry, and hold it to the radix-2 kernel's PSD
            def call(v, cfg=cfg):
                return stft_cuda._stft_psd_cuda(v, FS, cfg, False, True,
                                                "mixed")
            want = stft_cuda.stft_psd(x[:64], FS, cfg)
            got = call(x[:64])[0]
            report[f"{name} mixed vs fft"] = float(
                (got - want).abs().amax() / want.abs().amax())
        elif args.route is not None:
            try:
                call(x[:1])
            except ValueError:
                report[name] = f"no {args.route} route"
                continue
        before = json.loads(json.dumps(stft_cuda.launches))
        print(name, file=sys.stderr, flush=True)
        try:
            psd = call(x)[0]                     # build, warm up
        except RuntimeError as err:              # a launch the kernel refused
            report[name] = f"launch failed: {err}"
            continue
        digest = hashlib.sha256(psd[:64].cpu().numpy().tobytes()).hexdigest()
        ulps = None
        if args.ulp:
            want = stft_cuda.stft_psd_reference(
                x[:64], stft_cuda.dft_constants(cfg, FS, dev), cfg)
            ulps = ulp_distance(psd[:64], want)
            del want
        del psd
        torch.cuda.synchronize()

        def timed(fn):
            reps = []
            for _ in range(REPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
                reps.append(start.elapsed_time(end))
            return reps
        reps = timed(lambda: call(x))
        after = stft_cuda.launches
        added = ({k: after[k] - before.get(k, 0) for k in after}
                 if isinstance(after, dict) else after - before)
        report[name] = {"ms": sorted(reps)[REPS // 2], "reps_ms": reps,
                        "launches": added, "psd_sha256": digest[:16],
                        "batch": list(shape[name])}
        if ulps is not None:
            report[name]["ulp_from_plain"] = ulps
        if args.library:
            library_psd(x, cfg)                  # warm up
            lib = timed(lambda: library_psd(x, cfg))
            report[name]["library_ms"] = sorted(lib)[REPS // 2]
            torch.cuda.empty_cache()
        if args.plain:
            consts = stft_cuda.dft_constants(cfg, FS, dev)

            def plain(cfg=cfg, consts=consts):
                return stft_cuda.stft_psd_reference(x, consts, cfg,
                                                    with_stats=True)
            plain()                              # warm up
            report[name]["plain_ms"] = sorted(timed(plain))[REPS // 2]
            torch.cuda.empty_cache()
    print(json.dumps(report))


if __name__ == "__main__":
    main()
