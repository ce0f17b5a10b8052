"""Time the PyTorch port's STFT kernel at the display spine's batch, for one
checkout of the port.

    python3 tools/torch_route_times.py [--root DIR]

Imports ``spectral_tpu_torch`` from DIR (default: the checkout holding this
script), builds its STFT kernel from DIR's sources, and times
``stft_psd(x, fs, cfg, with_stats=True)`` on 1024 clips of 10 s at 16 kHz
for scipy_default 1024 and north_star 1024/256, with CUDA events, median
of 5 after a warm-up. Pointed at an older checkout it times that
checkout's kernel, so one call on one card compares two versions: run it
for the older, this, this and the older again.

Needs one CUDA card. Prints one JSON line: the root, the card's name and
power limit, and per config the median, every repeat and the launch
counts the calls added.
"""

from __future__ import annotations

import argparse
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
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((CLIPS, int(FS * SECONDS)), generator=gen, device=dev)
    report = {"root": root, "card": card, "clips": CLIPS,
              "seconds": SECONDS}
    for name, cfg in (("scipy_default 1024", SpecConfig.scipy_default(1024)),
                      ("north_star 1024/256",
                       SpecConfig.north_star(1024, 256))):
        before = json.loads(json.dumps(stft_cuda.launches))
        stft_cuda.stft_psd(x, FS, cfg, with_stats=True)     # build, warm up
        torch.cuda.synchronize()
        reps = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            stft_cuda.stft_psd(x, FS, cfg, with_stats=True)
            end.record()
            torch.cuda.synchronize()
            reps.append(start.elapsed_time(end))
        after = stft_cuda.launches
        added = ({k: after[k] - before.get(k, 0) for k in after}
                 if isinstance(after, dict) else after - before)
        report[name] = {"ms": sorted(reps)[REPS // 2], "reps_ms": reps,
                        "launches": added}
    print(json.dumps(report))


if __name__ == "__main__":
    main()
