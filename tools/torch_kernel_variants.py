"""Time one of the FFT kernels of the STFT/PSD route against variants of its
own source, on the card.

    python3 tools/torch_kernel_variants.py KERNEL [--only NAME ...]
                                           [--nperseg N ...]

KERNEL is one of KERNELS below: ``r2`` (the radix-2 kernel, C entry
``stft_fft_psd_launch``), ``mixed`` (the mixed-radix kernel,
``stft_mixed_fft_psd_launch``), ``conv`` (the odd and Bluestein kernels,
``stft_odd_fft_psd_launch`` or ``stft_bluestein_psd_launch`` by the
config's route), ``rader`` (the pass engine's Rader plans: the mixed
route's, PACKED, through ``stft_mixed_fft_psd_launch``, and the odd
route's) or ``small`` (the GEMM route's small-K tile, ``stft_psd_launch``). Builds ``spectral_tpu_torch/ops/csrc/stft_psd.cu`` as it
stands ("this") and each of the kernel's variants, a textual edit of the
same source that must match it exactly once, with the port's nvcc flags
into ``build/kernel_variants/`` (gitignored), one nvcc a variant, all at
once, and launches each through its C entry with the output allocated
once: the kernel alone, without the wrapper's host work. Configs: the
kernel's own (KERNELS), or scipy_default at each ``--nperseg`` on 1024
clips of 10 s, each with the per-row extrema on. Each kernel runs in two
rounds, the variants in turn, CUDA events, median of 5 after a warm-up;
``stft_psd`` itself, the wrapper, is timed beside them on the first
config. A variant's PSD of the first 16 clips is compared with this
build's: the design variants must be bitwise equal; the ablations
("no_...") compute something else and only time a part.

Needs one CUDA card. Prints one JSON line: the kernel, the card's name
and power limit, each variant's ptxas registers and spills per
instantiation, and per config each variant's times and whether its PSD is
this build's.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "spectral_tpu_torch", "ops", "csrc",
                      "stft_psd.cu")
OUT_DIR = os.path.join(ROOT, "build", "kernel_variants")
FS = 16000.0
REPS = 5

# variants: name -> (what it changes, [(text in the source, replacement)])
R2_TABLE = "constexpr int R2_LR[13] = {0, 0, 0, 0, 3, 3, 3, 3, 3, 3, 4, 4, 4};"
R2_VARIANTS = {
    "values8": (
        "8 values a thread (three stages a pass, 64 registers) at every size",
        [(R2_TABLE, R2_TABLE.replace("4, 4, 4}", "3, 3, 3}"))]),
    "values16": (
        "16 values a thread (four stages a pass, 128 registers) from 64",
        [(R2_TABLE, R2_TABLE.replace("3, 3, 3, 3, 3, 3", "3, 4, 4, 4, 4, 4"))
         ]),
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
        [("  for (int f = band.lo + u; f < band.end(); f += P) {\n"
          "    const int g = f <= M ? f : K - f;",
          "  for (int f = band.lo + u; f < band.lo + 1; f += P) {\n"
          "    const int g = f <= M ? f : K - f;")]),
}

# the pass engine's ablations, shared by the mixed-radix and conv kernels
NO_ODD_SUMS = (
    "ablation: the radix 3, 5 and 7 passes' sums skipped (loads, twiddles "
    "and stores kept)",
    [("      buf[base + m * L] = make_double2(ar - bi, ai + br);\n"
      "      if (m > 0) buf[base + (P - m) * L] = make_double2(ar + bi, "
      "ai - br);",
      "      buf[base + m * L] = y[m];\n"
      "      if (m > 0) buf[base + (P - m) * L] = y[P - m];")])
NO_GENERIC_SUMS = (
    "ablation: the generic passes' sums skipped (reads and writes kept)",
    [("#pragma unroll 1\n    for (int q = 1; q <= h; ++q) {",
      "#pragma unroll 1\n    for (int q = 1; q <= 0; ++q) {"),
     ("    for (int q = 1; q <= H; ++q, rq += RM) {",
      "    for (int q = 1; q <= 0; ++q, rq += RM) {")])
NO_R2_BUTTERFLIES = (
    "ablation: the radix-2 passes' butterflies and twiddle loads removed",
    [("      if constexpr (DIF)\n"
      "        r2_dif_butterfly(v[i], v[i | (1 << S)], w);\n"
      "      else\n"
      "        r2_butterfly(v[i], v[i | (1 << S)], w);",
      "      (void)w;")])
MIX_RMAX = "return p_max <= 7 ? 0 : (p_max <= MIX_NARROW_RADIX ? 4 : 8);"
LARGE_FIRST = (
    "the twos grouped larger passes first (a = 5: 8, 4; a = 13: 16, 8, 8, "
    "8)",
    [("    const int i = n2 - 1 - pn;       // its rank among the passes, "
      "larger first",
      "    const int i = pn;")])

MIXED_VARIANTS = {
    "rm8": (
        "every generic lane on 8 output pairs (the widest plans' width)",
        [(MIX_RMAX, "return p_max <= 7 ? 0 : 8;")]),
    "one_kernel": (
        "one instantiation for every plan: generic code compiled in "
        "everywhere",
        [(MIX_RMAX, "return p_max <= MIX_NARROW_RADIX ? 4 : 8;")]),
    "kfast": (
        "k fastest across the lanes in the odd and generic passes too (the "
        "conv kernels' mapping), not the group",
        [("  if (KFAST || ps.radix % 2 == 0) {", "  if (true) {"),
         ("    ps.inner = make_fastdiv(ps.radix % 2 ? N / lp : ps.span);",
          "    ps.inner = make_fastdiv(ps.span);")]),
    "large_first": LARGE_FIRST,
    "no_generic_sums": NO_GENERIC_SUMS,
    "no_odd_sums": NO_ODD_SUMS,
    "no_scatter": (
        "ablation: the load writes the frame in natural order, not through "
        "perm",
        [("fbuf[perm[j]] = make_double2(", "fbuf[j] = make_double2(")]),
    "no_r2_butterflies": NO_R2_BUTTERFLIES,
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
         ("    bin(f, fbuf[g], fbuf[M - g], split[g], wts[f]);",
          "    bin(f, fbuf[g], fbuf[M - g], split[0], wts[0]);")]),
}

ODD_MIN = ("  return rmax == 1 || (rmax == 0 && (!rader || packed)) ? "
           "ODD_SMALL_BLOCKS\n"
           "                                                        : 1;")
FUSE = "  plan->fuse = turn && (r0 % 2 == 0 || r0 <= 7) ? 1 : 0;"
NARROW_AT = "  bool narrow = width <= narrow_points;"
NARROW_PASS = ("      if (N / ps.radix <= 16 || (pairs + rm - 1) / rm > "
               "*threads / 32)")
CONV_VARIANTS = {
    "noinline": (
        "the pass engine's transforms compiled once, not inlined into the "
        "kernels",
        [("template <int RMAX>\n__device__ __forceinline__ void conv_forward(",
          "template <int RMAX>\n__device__ __noinline__ void conv_forward("),
         ("template <int RMAX, typename Product>\n"
          "__device__ __forceinline__ void conv_transform(",
          "template <int RMAX, typename Product>\n"
          "__device__ __noinline__ void conv_transform(")]),
    "no_turn": (
        "the turn-around not fused: pass 0 a trip in each direction and the "
        "product a trip of its own",
        [(FUSE, "  plan->fuse = 0;")]),
    "no_swizzle": (
        "power-of-two transforms at plain slots (the span-1 pass 8-way in "
        "conflict)",
        [("  plan->swz_mask = pow2 ? 7 : 0;", "  plan->swz_mask = 0;")]),
    "unroll2": (
        "two butterflies a thread in flight in the radix-2 and radix 3, 5, "
        "7 passes (their loops unrolled by 2)",
        [("  for (int b = threadIdx.x; b < nbt; b += blockDim.x) {\n"
          "    int k;\n    const int base = mix_base(ps, M, b, k);\n"
          "    double2 v[R];",
          "#pragma unroll 2\n"
          "  for (int b = threadIdx.x; b < nbt; b += blockDim.x) {\n"
          "    int k;\n    const int base = mix_base(ps, M, b, k);\n"
          "    double2 v[R];"),
         ("  for (int b = threadIdx.x; b < nbt; b += blockDim.x) {\n"
          "    int k;\n    const int base = mix_base<KFAST>(ps, M, b, k);\n"
          "    double2 y[P];",
          "#pragma unroll 2\n"
          "  for (int b = threadIdx.x; b < nbt; b += blockDim.x) {\n"
          "    int k;\n    const int base = mix_base<KFAST>(ps, M, b, k);\n"
          "    double2 y[P];")]),
    "unroll2_turn": (
        "two turn-around butterflies a thread in flight",
        [("  for (int b = threadIdx.x; b < N / R; b += blockDim.x) {",
          "#pragma unroll 2\n"
          "  for (int b = threadIdx.x; b < N / R; b += blockDim.x) {"),
         ("  for (int b = threadIdx.x; b < N / P; b += blockDim.x) {",
          "#pragma unroll 2\n"
          "  for (int b = threadIdx.x; b < N / P; b += blockDim.x) {")]),
    "large_first": LARGE_FIRST,
    "turn_odd_only": (
        "the turn-around fused only where pass 0 is radix 3, 5 or 7",
        [(FUSE, "  plan->fuse = turn && r0 % 2 == 1 && r0 <= 7 ? 1 : 0;")]),
    "odd_one_block": (
        "the odd kernel's narrow plans, and those of radix 3, 5 and 7 "
        "passes only, at one block of 512 threads an SM (128 registers), as "
        "the others",
        [(ODD_MIN, ODD_MIN.replace("ODD_SMALL_BLOCKS", "1"))]),
    "odd_two_blocks": (
        "every odd kernel at two blocks of 512 threads an SM (64 registers)",
        [(ODD_MIN, ODD_MIN.replace("ODD_SMALL_BLOCKS", "2")
          .replace(": 1;", ": 2;"))]),
    "narrow_upto_24": (
        "generic passes narrow up to 24 butterflies, not 16",
        [(NARROW_PASS, NARROW_PASS.replace("<= 16", "<= 24"))]),
    "narrow_all": (
        "every generic pass of the odd kernel narrow (a thread an output "
        "pair), whatever its plan's size",
        [("  if (*rmax > 0 && narrow) *rmax = 1;",
          "  if (*rmax > 0) *rmax = 1;")]),
    "narrow_small_only": (
        "the generic passes narrow only where a pass has fewer than 32 "
        "butterflies, at any nperseg",
        [(NARROW_AT, "  bool narrow = false;")]),
    "narrow_crowded_only": (
        "the generic passes narrow only where the block's warps cannot hold "
        "a pass's groups, at any size",
        [(NARROW_AT, "  bool narrow = false;"),
         (NARROW_PASS, "      if ((pairs + rm - 1) / rm > *threads / 32)")]),
    "blue_one_block": (
        "the Bluestein kernel at one block an SM (128 registers) at every "
        "length, not two up to BLUE_TWO_BLOCK_POINTS",
        [("      ranks == 2 ? 2 : (local <= BLUE_TWO_BLOCK_POINTS ? 1 : 0);",
          "      ranks == 2 ? 2 : 0;")]),
    "rader_narrow_one_block": (
        "the odd kernel's narrow Rader plans at one block an SM (128 "
        "registers), not two",
        [(ODD_MIN, ODD_MIN.replace("return rmax == 1 ||",
                                   "return (rmax == 1 && !rader) ||"))]),
    "no_load_stores": (
        "ablation: the Bluestein load computes its values but stores none "
        "(what fusing the load into the first pass could save at most)",
        [("    if (loads) buf[map(i)] = z;",
          "    if (loads && i < 0) buf[map(i)] = z;")]),
    "no_last_pass": (
        "ablation: the last pass in time skipped (pruning its unneeded "
        "outputs could save half of it at most)",
        [("  for (int q = first; q < plan.n_passes; ++q) {\n"
          "    conv_pass<RMAX, false>",
          "  for (int q = first; q < plan.n_passes - 1; ++q) {\n"
          "    conv_pass<RMAX, false>")]),
    "no_first_pass": (
        "ablation: the first pass in frequency skipped (skipping its known "
        "zeros could save half of it at most)",
        [("  for (int q = plan.n_passes - 1; q >= plan.fuse; --q) {",
          "  for (int q = plan.n_passes - 2; q >= plan.fuse; --q) {")]),
    "no_odd_sums": NO_ODD_SUMS,
    "no_r2_butterflies": NO_R2_BUTTERFLIES,
    "no_r2_twiddles": (
        "ablation: every radix-2 twiddle read at its stage's first row (the "
        "butterflies kept)",
        [("    const double2 w = tw[row + k + L * t];",
          "    const double2 w = tw[row];")]),
    "no_tables": (
        "ablation: the radix-2 twiddles, the odd passes' twiddles and b^ "
        "each read at one row",
        [("    const double2 w = tw[row + k + L * t];",
          "    const double2 w = tw[row];"),
         ("        y[q] = cmul(tw[ps.tw[0] + (q - 1) * L + k], y[q]);",
          "        y[q] = cmul(tw[ps.tw[0]], y[q]);"),
         ("    const double2 p = cmul(bhat[s], y);",
          "    const double2 p = cmul(bhat[0], y);"),
         ("    return cmul(bhat[s], y);", "    return cmul(bhat[0], y);")]),
    "no_generic_sums": NO_GENERIC_SUMS,
}


JFAST = "    const bool jfast = per > 1 && (per & (per - 1)) == 0;"
RADER_VARIANTS = {
    "narrow_m_fast": (
        "every narrow pass with its output pairs fastest across the lanes "
        "(the mapping before the round's butterflies took the lanes)",
        [(JFAST, "    const bool jfast = false;")]),
    "narrow_j_fast_all": (
        "every narrow pass of more than one butterfly a round with the "
        "round's butterflies fastest, not only at a power of two a round",
        [(JFAST, "    const bool jfast = per > 1;")]),
    "packed_bits4": (
        "the PACKED plans' radix-2 passes of up to 16 values, not 8",
        [("constexpr int PACKED_R2_BITS = 3;",
          "constexpr int PACKED_R2_BITS = 4;")]),
    "packed_r0_one_block": (
        "the PACKED plans without a generic pass at one block an SM (128 "
        "registers), not two",
        [(ODD_MIN, ODD_MIN.replace("(!rader || packed)", "!rader"))]),
    "no_root_gather": (
        "ablation: a narrow pass reads its lane's root at one index (m), "
        "not the gathered q m mod p",
        [("          const double2 c = roots[idx];",
          "          const double2 c = roots[m];")]),
    "no_narrow_sums": (
        "ablation: a narrow pass's sums skipped (its reads of y0 and its "
        "writes kept)",
        [("        for (int q = 1; q <= h; ++q) {\n          idx += m;",
          "        for (int q = 1; q <= 0; ++q) {\n          idx += m;")]),
    "no_odd_sums": NO_ODD_SUMS,
    "no_r2_butterflies": NO_R2_BUTTERFLIES,
}

SK_BLOCKS = "constexpr int SK_MIN_BLOCKS = 3;"
SMALL_VARIANTS = {
    "sk_bins8": (
        "the small tile compiled for 8 bins a thread at every F (the bins "
        "a thread does not hold predicated off), not instantiated by them",
        [("    const auto kernel = by_nb[nb - 1];",
          "    const auto kernel = stft_psd_small_kernel<8>;"),
         ("    const int err = raise_smem(kernel, smem, small_smem_set[nb - 1]);",
          "    const int err = raise_smem(kernel, smem, small_smem_set[7]);")]),
    "sk_two_blocks": (
        "the small tile at two blocks an SM (128 registers)",
        [(SK_BLOCKS, SK_BLOCKS.replace("3;", "2;"))]),
    "sk_four_blocks": (
        "the small tile at four blocks an SM (64 registers)",
        [(SK_BLOCKS, SK_BLOCKS.replace("3;", "4;"))]),
    "sk_no_sums": (
        "ablation: the small tile's products skipped (staging and stores "
        "kept)",
        [("  for (int k0 = 0; k0 < KP; k0 += SK_K_STEP) {",
          "  for (int k0 = 0; k0 < 0; k0 += SK_K_STEP) {")]),
    "sk_no_stage": (
        "ablation: the small tile stages no samples (its products read "
        "what shared memory holds)",
        [("      cp_async_f32(xs + off[i] + k, x + src[i] + k);",
          "      (void)src;")]),
}

def _r2_launch(stft_cuda, cfg, dev, a):
    c = stft_cuda.fft_constants(cfg, FS, dev)
    return lambda lib: lib.stft_fft_psd_launch(
        a.x, c.window.data_ptr(), c.twiddles.data_ptr(), c.wts.data_ptr(),
        *a.outs, *a.shape, a.detrend, 0, 1, 0, a.stream)


def _mixed_launch(stft_cuda, cfg, dev, a):
    c = stft_cuda.mixed_constants(cfg, FS, dev)
    return lambda lib: lib.stft_mixed_fft_psd_launch(
        a.x, c.window.data_ptr(), c.perm.data_ptr(), c.twiddles.data_ptr(),
        c.stages.ctypes.data, len(c.stages), c.split, c.rader,
        c.wts.data_ptr(), *a.outs, *a.shape, a.detrend, 0, 1, 0, a.stream)


def _conv_launch(stft_cuda, cfg, dev, a):
    if stft_cuda.route(cfg) == "odd":
        c = stft_cuda.mixed_constants(cfg, FS, dev)
        return lambda lib: lib.stft_odd_fft_psd_launch(
            a.x, c.window.data_ptr(), c.perm.data_ptr(),
            c.twiddles.data_ptr(), c.stages.ctypes.data, len(c.stages),
            c.rader, c.wts.data_ptr(), *a.outs, *a.shape, a.detrend, 0, 1,
            1, 0, a.stream)
    c = stft_cuda.bluestein_constants(cfg, FS, dev)
    return lambda lib: lib.stft_bluestein_psd_launch(
        a.x, c.window.data_ptr(), c.twiddles.data_ptr(),
        c.stages.ctypes.data, len(c.stages), c.m, c.bhat, c.chirp, c.split,
        c.wts.data_ptr(), *a.outs, *a.shape, a.detrend, 0, 1, 0, a.stream)


def _rader_launch(stft_cuda, cfg, dev, a):
    if stft_cuda.route(cfg) == "odd":
        return _conv_launch(stft_cuda, cfg, dev, a)
    return _mixed_launch(stft_cuda, cfg, dev, a)


def _small_launch(stft_cuda, cfg, dev, a):
    c = stft_cuda.dft_constants(cfg, FS, dev)
    return lambda lib: lib.stft_psd_launch(
        a.x, c.a_re.data_ptr(), c.a_im.data_ptr(), c.wts.data_ptr(), *a.outs,
        *a.shape, 0, 1, a.stream)

@dataclasses.dataclass(frozen=True)
class Kernel:
    routes: tuple          # the routes whose configs it launches
    ptxas: tuple           # (entry pattern, label) for chip_smoke's parser
    paths: tuple           # chip_smoke.py's paths (label, nperseg, detrend):
                           # scipy_default on 256 clips of 60 s, path 1
                           # north_star nperseg/256 on 1024 clips of 10 s
    nperseg: tuple         # scipy_default on 1024 clips of 10 s
    launch: object         # (stft_cuda, cfg, dev, args) -> launch(lib)
    variants: dict


KERNELS = {
    "r2": Kernel(
        ("fft",),
        (r"stft_fft_psd_kernelILi(\d+)ELi(\d+)E",
         lambda e: f"LOG2M {e.group(1)}, {2 ** int(e.group(2))} values"),
        (("path 1 north_star 1024/256", 1024, None),
         ("path 2 scipy_default 8192", 8192, None)),
        tuple(2 ** b for b in range(5, 14)), _r2_launch, R2_VARIANTS),
    "mixed": Kernel(
        ("mixed",),
        (r"stft_mixed_fft_psd_kernelILi(\d+)E",
         lambda e: f"RMAX {e.group(1)}"),
        (("path 4 scipy_default 8160", 8160, None),
         ("path 5 scipy_default 8032", 8032, None),
         ("path 6 scipy_default 8160 linear", 8160, "linear")),
        (96, 352, 992, 1184, 4192), _mixed_launch, MIXED_VARIANTS),
    "conv": Kernel(
        ("odd", "bluestein"),
        (r"stft_(odd_fft|bluestein)_psd_kernelIL[bi](\d)EL[ib](\d+)E",
         lambda e: f"{e.group(1).split('_')[0]}<{e.group(2)}, "
                   f"{e.group(3)}>"),
        (("path 7 scipy_default 8191", 8191, None),
         ("path 8 scipy_default 8185", 8185, None),
         ("path 9 scipy_default 8182", 8182, None)),
        (563, 1023, 2049, 4093), _conv_launch, CONV_VARIANTS),
    "rader": Kernel(
        ("mixed", "odd"),
        (r"stft_odd_fft_psd_kernelILb(\d)ELi(\d+)ELb(\d)E",
         lambda e: f"odd<{e.group(1)}, {e.group(2)}, {e.group(3)}>"),
        (), (526, 1006, 1082, 2894, 4106, 8186, 503, 1553),
        _rader_launch, RADER_VARIANTS),
    "small": Kernel(
        ("gemm",),
        (r"stft_psd_(small_kernelILi(\d)E|kernelE)",
         lambda e: f"small<{e.group(2)}>" if e.group(2) else "large"),
        (), (2, 7, 13, 24, 31), _small_launch, SMALL_VARIANTS),
}


def variant_source(src, edits, name="variant"):
    """src with each (old, new) of edits replaced; each old must occur
    exactly once."""
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: the source holds {old!r} "
                             f"{src.count(old)} times, not once")
        src = src.replace(old, new)
    return src


def load(so):
    lib = ctypes.CDLL(so)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    out = [ptr] * 3 + [i32, i64]
    for entry, args in (
            ("stft_psd_launch", [ptr] * 4 + out + [i32] * 6),
            ("stft_fft_psd_launch", [ptr] * 4 + out + [i32] * 8),
            ("stft_mixed_fft_psd_launch",
             [ptr] * 5 + [i32] * 3 + [ptr] + out + [i32] * 8),
            ("stft_odd_fft_psd_launch",
             [ptr] * 5 + [i32] * 2 + [ptr] + out + [i32] * 9),
            ("stft_bluestein_psd_launch",
             [ptr] * 4 + [i32] * 5 + [ptr] + out + [i32] * 8)):
        fn = getattr(lib, entry)
        fn.argtypes = args + [ptr]
        fn.restype = i32
    return lib


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=sorted(KERNELS))
    ap.add_argument("--only", nargs="*",
                    help="time these variants beside this build only")
    ap.add_argument("--nperseg", type=int, nargs="*",
                    help="time scipy_default at these nperseg on 1024 clips "
                         "of 10 s instead")
    args = ap.parse_args(argv)
    kern = KERNELS[args.kernel]
    unknown = set(args.only or ()) - set(kern.variants)
    if unknown:
        ap.error(f"{args.kernel} has no variants {sorted(unknown)}; it has "
                 f"{sorted(kern.variants)}")
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_variants: this needs a CUDA card")
    from chip_smoke import radix2_ptxas
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.core.stft import num_frames
    from spectral_tpu_torch.ops import build as port_build
    from spectral_tpu_torch.ops import stft_cuda

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = port_build.find_nvcc()
    if nvcc is None:
        raise SystemExit("torch_kernel_variants: nvcc not found")
    with open(SOURCE) as fh:
        this_src = fh.read()
    names = ["this"] + list(args.only or kern.variants)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        src = (this_src if name == "this" else
               variant_source(this_src, kern.variants[name][1], name))
        folder = os.path.join(OUT_DIR, args.kernel, name)
        os.makedirs(folder, exist_ok=True)
        cu = os.path.join(folder, "stft_psd.cu")
        with open(cu, "w") as fh:
            fh.write(src)
        procs[name] = subprocess.Popen(
            [nvcc, *port_build.NVCC_FLAGS, "-o",
             os.path.join(folder, "libstft_psd.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, regs = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        libs[name] = load(os.path.join(OUT_DIR, args.kernel, name,
                                       "libstft_psd.so"))
        regs[name] = radix2_ptxas(log, *kern.ptxas)
    print(f"built {len(names)} variants in {time.perf_counter() - t0:.1f} "
          f"s; ptxas {regs}", flush=True)

    dev = torch.device("cuda", 0)
    configs = []
    for label, k, detrend in kern.paths:
        if label.startswith("path 1 "):
            configs.append((label, SpecConfig.north_star(k, 256), 1024, 10.0))
            continue
        cfg = SpecConfig.scipy_default(k)
        if detrend:
            cfg = dataclasses.replace(cfg, detrend=detrend)
        configs.append((label, cfg, 256, 60.0))
    configs += [(f"scipy_default {k}", SpecConfig.scipy_default(k), 1024,
                 10.0) for k in kern.nperseg]
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

    report = {"kernel": args.kernel, "card": card, "ptxas": regs,
              "configs": {}}
    for i, (label, cfg, clips, seconds) in enumerate(configs):
        if stft_cuda.route(cfg) not in kern.routes:
            report["configs"][label] = f"the {stft_cuda.route(cfg)} route"
            continue
        if (clips, seconds) not in batches:
            batches.clear()
            gen = torch.Generator(device=dev).manual_seed(3)
            batches[clips, seconds] = torch.randn(
                (clips, int(FS * seconds)), generator=gen, device=dev)
        x = batches[clips, seconds]
        B, n = x.shape
        T = num_frames(n, cfg.nperseg, cfg.hop_)
        F = cfg.n_freqs
        out = torch.empty((B, T, F), device=dev)
        parts = torch.empty((2, B * T), device=dev)
        launch = kern.launch(stft_cuda, cfg, dev, argparse.Namespace(
            x=x.data_ptr(), stream=stream,
            outs=(out.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr()),
            shape=(B, n, T, F, cfg.nperseg, cfg.hop_),
            detrend=stft_cuda.DETREND_CODES[cfg.detrend]))

        def checked(lib):
            err = launch(lib)
            if err:
                raise SystemExit(f"{label}: launch failed with {err}")

        checked(libs["this"])
        torch.cuda.synchronize()
        want = out[:16].clone()
        row = {}
        for rnd in range(2):
            for name in (names if rnd == 0 else names[::-1]):
                ms = timed(lambda: checked(libs[name]))
                entry = row.setdefault(name, {"ms": []})
                entry["ms"].append(ms)
                entry["same_psd"] = bool(torch.equal(out[:16], want))
        if i == 0:
            row["stft_psd (wrapper)"] = {"ms": [timed(
                lambda: stft_cuda.stft_psd(x, FS, cfg, with_stats=True))]}
        report["configs"][label] = row
        print(label, {k: [round(t, 3) for t in v["ms"]]
                      for k, v in row.items()}, flush=True)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
