"""Precision evidence for the PyTorch port's STFT kernel
(``spectral_tpu_torch/ops/stft_cuda.py``), and the scipy display oracle
that its checks compare against.

    python3 tools/torch_precision.py [--seeds N]

The kernel's accumulation orders are emulated in numpy on the CPU. The
first table gives, for each config on one clip (seed 0), the display error
against scipy in float64 of four ways to accumulate each PSD output over
the nperseg samples of a frame:

- ``fp32 chain``: one float32 FMA chain over ascending k, A in float32
  (exact products, one rounding per step), the epilogue rounded per step;
- ``fp32 16-sums``: float32 chains over 16-sample blocks, summed in a
  float32 chain;
- ``f64, A f32``: float64 accumulation of the float32 A;
- ``f64, A f64``: float64 accumulation of the host's float64 A, the
  epilogue in float64 (the kernel's arithmetic).

The second table repeats the float32 chain and the float64 route over
seeds 0 to N-1 (default 100): whether a float32 chain breaks the 1e-3 dB
contract depends on the clip, through the depth of its deepest bin.

Each PSD is rounded to float32, as the kernel stores it. The display error
is ``bench.py``'s formula, max |Δimage| times the image's dB range, with
the display itself computed in float64 so that it measures the PSD alone.
Clips are white noise of 8·nperseg samples, with or without a +3 offset.

scipy is an oracle here, as in ``bench.py`` and the tests; the port's
package never imports it.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from spectral_tpu_torch.config import SpecConfig  # noqa: E402
from spectral_tpu_torch.core.stft import (dft_matrices,  # noqa: E402
                                          onesided_weights)

FS = 16000.0
CONTRACT_DB = 1e-3


def log_display(p: np.ndarray):
    """bench.py's log display of a PSD in float64: (image in [0, 1], its
    dB range)."""
    p = np.asarray(p, np.float64)
    db = np.nan_to_num(10.0 * np.log10(np.clip(p / (p.max() + 1e-20),
                                               0.0, 1.0) + 1e-12))
    rng = db.max() - db.min()
    return (db - db.min()) / rng, rng


def scipy_display(x64: np.ndarray, cfg: SpecConfig, fs: float = FS):
    """The oracle of the display contract: scipy.signal.spectrogram of a
    float64 clip at cfg's framing, window and detrend, through
    :func:`log_display`. Returns the (F, T) image and its dB range."""
    from scipy.signal import spectrogram
    _f, _t, sxx = spectrogram(
        x64, fs=fs, window=cfg.window, nperseg=cfg.nperseg,
        noverlap=cfg.nperseg - cfg.hop_, nfft=cfg.nperseg,
        detrend=False if cfg.detrend == "none" else cfg.detrend,
        scaling="density", mode="psd")
    return log_display(sxx)


def display_error_db(psd_tf: np.ndarray, x64: np.ndarray,
                     cfg: SpecConfig) -> float:
    """bench.py's display error of a (F, T) PSD against scipy in float64,
    both displays computed in float64."""
    img_ref, rng = scipy_display(x64, cfg)
    img, _ = log_display(psd_tf)
    return float(np.max(np.abs(img - img_ref)) * rng)


def frames_of(x: np.ndarray, cfg: SpecConfig) -> np.ndarray:
    """(T, nperseg) float32 frames of a float32 clip."""
    T = (x.shape[-1] - cfg.nperseg) // cfg.hop_ + 1
    idx = np.arange(T)[:, None] * cfg.hop_ + np.arange(cfg.nperseg)[None]
    return x[idx]


def psd_fp32_chain(frames: np.ndarray, a_re: np.ndarray, a_im: np.ndarray,
                   wts: np.ndarray, block: int = 0) -> np.ndarray:
    """(T, F) float32 PSD from float32 FMA chains over ascending k; block
    > 0 sums float32 chains over block-sample pieces in a float32 chain."""
    a_re = a_re.astype(np.float32).astype(np.float64)
    a_im = a_im.astype(np.float32).astype(np.float64)
    f = frames.astype(np.float64)

    def chain(lo, hi):
        re = np.zeros((f.shape[0], a_re.shape[1]), np.float32)
        im = np.zeros_like(re)
        for k in range(lo, hi):
            re = (re + f[:, k:k + 1] * a_re[k]).astype(np.float32)
            im = (im + f[:, k:k + 1] * a_im[k]).astype(np.float32)
        return re, im

    K = f.shape[1]
    if block:
        re = np.zeros((f.shape[0], a_re.shape[1]), np.float32)
        im = np.zeros_like(re)
        for k0 in range(0, K, block):
            pr, pi = chain(k0, min(K, k0 + block))
            re, im = re + pr, im + pi
    else:
        re, im = chain(0, K)
    return (re * re + im * im) * wts.astype(np.float32)


def psd_f64(frames: np.ndarray, a_re: np.ndarray, a_im: np.ndarray,
            wts: np.ndarray, a_dtype=np.float64) -> np.ndarray:
    """(T, F) PSD accumulated in float64 from A rounded to a_dtype, the
    epilogue in float64, rounded once to float32."""
    f = frames.astype(np.float64)
    re = f @ a_re.astype(a_dtype).astype(np.float64)
    im = f @ a_im.astype(a_dtype).astype(np.float64)
    return ((re * re + im * im) * wts).astype(np.float32)


def clip(cfg: SpecConfig, seed: int, offset: float) -> np.ndarray:
    """White noise of 8·nperseg float32 samples, plus offset."""
    rs = np.random.RandomState(seed)
    return (rs.randn(8 * cfg.nperseg) + offset).astype(np.float32)


ONE_CLIP = [
    ("north_star 1024/256", SpecConfig.north_star(1024, 256), 3.0, False),
    ("scipy_default 1024", SpecConfig.scipy_default(1024), 0.0, True),
    ("scipy_default 1024", SpecConfig.scipy_default(1024), 3.0, True),
    ("north_star 8192/2048", SpecConfig.north_star(8192, 2048), 0.0, False),
    ("scipy_default 8192", SpecConfig.scipy_default(8192), 0.0, True),
    ("scipy_default 8192", SpecConfig.scipy_default(8192), 3.0, True),
]

SWEEP = [
    ("north_star 128/32", SpecConfig.north_star(128, 32)),
    ("north_star 256/64", SpecConfig.north_star(256, 64)),
    ("north_star 512/128", SpecConfig.north_star(512, 128)),
    ("north_star 1024/256", SpecConfig.north_star(1024, 256)),
    ("scipy_default 1024", SpecConfig.scipy_default(1024)),
]


def one_clip_table() -> None:
    print("config                 clip       fp32 chain  fp32 16-sums  "
          "f64, A f32  f64, A f64  (dB against scipy float64, seed 0)")
    for name, cfg, offset, all_columns in ONE_CLIP:
        x = clip(cfg, 0, offset)
        frames = frames_of(x, cfg)
        a_re, a_im = dft_matrices(cfg)
        wts = onesided_weights(cfg, FS)
        cols = [psd_fp32_chain(frames, a_re, a_im, wts)]
        if all_columns:
            cols += [psd_fp32_chain(frames, a_re, a_im, wts, block=16),
                     psd_f64(frames, a_re, a_im, wts, np.float32),
                     psd_f64(frames, a_re, a_im, wts)]
        errs = [f"{display_error_db(p.T, x.astype(np.float64), cfg):.2e}"
                for p in cols]
        errs += ["—"] * (4 - len(errs))
        kind = "noise + 3" if offset else "noise"
        print(f"{name:22s} {kind:10s} " + "  ".join(f"{e:10s}" for e in errs),
              flush=True)


def sweep_table(seeds: int) -> None:
    print(f"\nconfig                 clip       fp32 chain: worst  seed  "
          f"above {CONTRACT_DB:g} dB  worst of seeds 0-19 | f64, A f64: "
          f"worst  (seeds 0-{seeds - 1})")
    for name, cfg in SWEEP:
        a_re, a_im = dft_matrices(cfg)
        wts = onesided_weights(cfg, FS)
        for offset in (0.0, 3.0):
            fp32, f64 = [], []
            for s in range(seeds):
                x = clip(cfg, s, offset)
                x64 = x.astype(np.float64)
                frames = frames_of(x, cfg)
                fp32.append(display_error_db(
                    psd_fp32_chain(frames, a_re, a_im, wts).T, x64, cfg))
                f64.append(display_error_db(
                    psd_f64(frames, a_re, a_im, wts).T, x64, cfg))
            fp32 = np.asarray(fp32)
            kind = "noise + 3" if offset else "noise"
            print(f"{name:22s} {kind:10s} {fp32.max():.2e}           "
                  f"{int(fp32.argmax()):4d}  {int((fp32 > CONTRACT_DB).sum()):3d}"
                  f" of {seeds:<4d}     {fp32[:20].max():.2e}"
                  f"            | {max(f64):.2e}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=100,
                    help="clips per config and offset in the sweep")
    args = ap.parse_args(argv)
    one_clip_table()
    sweep_table(args.seeds)


if __name__ == "__main__":
    main()
