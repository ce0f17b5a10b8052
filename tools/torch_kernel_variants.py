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
route's) or ``small`` (the GEMM route's small-K tile, ``stft_psd_launch``),
all in ``spectral_tpu_torch/ops/csrc/stft_psd.cu``; or ``grad`` (the
radix-2 route's backward, ``stft_fft_backward_launch`` in
``csrc/stft_grad.cu``, on a seeded gradient of the PSD) or ``grad_mixed``
(the mixed and odd routes' backward, ``stft_mixed_fft_backward_launch``
and ``stft_odd_fft_backward_launch`` in ``csrc/stft_grad_mixed.cu``, a
source of their own, the same way) or ``grad_bluestein`` (the Bluestein
route's backward, ``stft_bluestein_fft_backward_launch`` in the same
source) or ``hmm`` (the HMM kernels of ``csrc/hmm.cu``: H1,
``hmm_fit_launch``, at path 14's shapes; H3's EM loop,
``hmm_fit_chunked_launch`` through ``ops/hmm_cuda.py::fit_chunked``'s
host loop, at each ``EM_GROUP`` of ``HMM_EM_GROUPS`` too, and one E-step,
``hmm_estep_chunked_launch``, at path 15's; see :func:`hmm_main`). Builds the
kernel's source as it
stands ("this") and each of the kernel's variants, a textual edit of the
same source that must match it exactly once, with the port's nvcc flags
into ``build/kernel_variants/`` (gitignored), one nvcc a variant, all at
once, and launches each through its C entry with the output allocated
once: the kernel alone, without the wrapper's host work. Configs: the
kernel's own (KERNELS), or scipy_default at each ``--nperseg`` on 1024
clips of 10 s, each with the per-row extrema on. Each kernel runs in two
rounds, the variants in turn, CUDA events, median of 5 after a warm-up;
``stft_psd`` itself, the wrapper, is timed beside them on the first
config. A variant's output (the PSD, or the backward's frames'
gradient) of the first 16 clips is compared with this build's: the
design variants must be bitwise equal; the ablations ("no_...") compute
something else and only time a part.

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
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the ptxas parser, its HMM pattern)
CSRC = os.path.join(ROOT, "spectral_tpu_torch", "ops", "csrc")
SOURCE = os.path.join(CSRC, "stft_psd.cu")
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
         ("bin(g, a, b, g < M ? split[g] : make_double2(-1.0, 0.0), wts[g],",
          "bin(g, a, b, g < M ? split[0] : make_double2(-1.0, 0.0), wts[0],"),
         ("    bin(f, fbuf[g], fbuf[M - g], split[g], wts[f], true);",
          "    bin(f, fbuf[g], fbuf[M - g], split[0], wts[0], true);")]),
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
        [("    const auto kernel = by_nb[ext][nb - 1];",
          "    const auto kernel = by_nb[ext][SK_BINS - 1];"),
         ("    const int err = raise_smem(kernel, smem, small_smem_set[ext][nb - 1]);",
          "    const int err = raise_smem(kernel, smem, "
          "small_smem_set[ext][SK_BINS - 1]);")]),
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

GRAD_VARIANTS = {
    "regs128": (
        "8 values a thread at 128 registers (no spills): half the warps an "
        "SM holds",
        [("static constexpr int MIN_BLOCKS = LR == 3 ? 2 : 1;",
          "static constexpr int MIN_BLOCKS = 1;")]),
    "no_forward": (
        "ablation: no load and no forward passes (X from whatever the "
        "buffer holds)",
        [("  if (mode != OUT_COMPLEX) {\n    const float* frame =",
          "  if (false) {\n    const float* frame =")]),
    "no_inverse": (
        "ablation: the inverse passes removed (the store reads pass 0's "
        "values)",
        [("  r2_sync<P>();\n  r2_pass<LOG2M, LR, 0>(v, tw, u);\n"
          "  if constexpr (G::PASSES > 1)\n"
          "    r2_exchange_pass<LOG2M, LR, 1>(v, buf, tw, fl, u);\n"
          "  if constexpr (G::PASSES > 2)\n"
          "    r2_exchange_pass<LOG2M, LR, 2>(v, buf, tw, fl, u);\n"
          "  if constexpr (G::PASSES > 3)\n"
          "    r2_exchange_pass<LOG2M, LR, 3>(v, buf, tw, fl, u);\n",
          "  r2_sync<P>();\n")]),
    "no_cotangent": (
        "ablation: no g or weights read and no H (Z' from X alone)",
        [("  if (band.has(f)) h = cotangent_of(X.x, X.y, g, w, row + f, f, "
          "mode);",
          "  h = X;"),
         ("  if (two_sided && f > 0 && f < M && band.has(m)) {",
          "  if (false) {")]),
}


GRAD_MIXED_VARIANTS = {
    "odd_one_block": (
        "the odd backward's narrow plans and plans of radix 3, 5, 7 passes "
        "at one block an SM (128 registers), not two (64 registers, the "
        "forward's)",
        [("  return rmax == 1 || (rmax == 0 && (!rader || packed)) ? "
          "ODD_SMALL_BLOCKS\n                                                "
          "        : 1;",
          "  return 1;")]),
    "no_forward": (
        "ablation: the recompute's transform removed (the loads, the "
        "cotangent and the inverse kept; X from the loaded values)",
        [("    __syncthreads();\n    mixed_passes<RMAX, false>(buf, roots, "
          "odd_roots, tw, plan, M);\n  }",
          "    __syncthreads();\n  }"),
         ("      forward();\n    }\n    double2 x0 = make_double2(0.0, 0.0), "
          "z0 = x0;",
          "    }\n    double2 x0 = make_double2(0.0, 0.0), z0 = x0;"),
         ("      __syncthreads();\n      forward();\n    }\n    // slot P",
          "      __syncthreads();\n    }\n    // slot P")]),
    "no_inverse": (
        "ablation: the inverse transform removed (the store reads the "
        "cotangent pass's values)",
        [("  mixed_passes<RMAX, true>(buf, roots, odd_roots, tw, plan, M);\n",
          ""),
         ("    // pair, conj d for a lone frame\n    inverse();\n",
          "    // pair, conj d for a lone frame\n"),
         ("    inverse();\n    // 4. sample i", "    // 4. sample i")]),
    "no_cotangent": (
        "ablation: no g or weights read and no H (S from X alone)",
        [("  if (band.has(f)) h = cotangent_of(X.x, X.y, g, w, row + f, f, "
          "mode);\n  const int m = K - f;\n  if (two_sided && f > 0 && 2 * "
          "f < K && band.has(m)) {",
          "  h = X;\n  const int m = K - f;\n  if (false) {")]),
}


GRAD_BLUESTEIN_VARIANTS = {
    "one_block": (
        "one block an SM at every M, not two up to BLUE_TWO_BLOCK_POINTS "
        "(64 registers, the forward's)",
        [("ranks == 2 ? 2 : (local <= BLUE_TWO_BLOCK_POINTS ? 1 : 0);",
          "ranks == 2 ? 2 : 0;")]),
    "no_forward": (
        "ablation: the recompute's transform removed (the loads, the "
        "cotangent and the inverse kept; X from the loaded values)",
        [("                            : make_double2(0.0, 0.0);\n"
          "      transform();\n    }\n",
          "                            : make_double2(0.0, 0.0);\n    }\n"),
         ("                    : make_double2(0.0, 0.0);\n      }\n"
          "      transform();\n    }\n",
          "                    : make_double2(0.0, 0.0);\n      }\n    }\n")]),
    "no_inverse": (
        "ablation: the inverse transform removed (the store reads the "
        "cotangent pass's values)",
        [("    // 3. the inverse: the same transform of conj Z', y_j = conj "
          "z'[j]\n    transform();\n",
          "    // 3. the inverse: the same transform of conj Z', y_j = conj "
          "z'[j]\n"),
         ("    transform();\n    if (!lead) continue;\n",
          "    if (!lead) continue;\n")]),
    "no_cotangent": GRAD_MIXED_VARIANTS["no_cotangent"],
}

HMM_VARIANTS = {
    "no_chain": (
        "ablation: the transfers' and the chunk pass's K^2-lane steps "
        "skipped (staging, the scan and the statistics kept)",
        [("    for (int s = first; s < len; ++s)\n"
          "      v = k2_step<KM>(v, lbs[s * K + oo], col, true, o, r, K);",
          "    for (int s = first; s < first; ++s)\n"
          "      v = k2_step<KM>(v, lbs[s * K + oo], col, true, o, r, K);"),
         ("      for (int s = first; s < len; ++s) {\n"
          "        a = k2_step<KM>(",
          "      for (int s = first; s < first; ++s) {\n"
          "        a = k2_step<KM>("),
         ("      for (int s = len - 2; s >= 0; --s) {\n"
          "        bb = k2_step<KM>(",
          "      for (int s = len - 2; s >= len; --s) {\n"
          "        bb = k2_step<KM>(")]),
    "no_scan": (
        "ablation: the scan's chains skipped (its tiles still fetched)",
        [("        for (int c = t == 0 ? 1 : t * SCAN_TILE; c < c1; ++c) {",
          "        for (int c = t == 0 ? 1 : t * SCAN_TILE; c < 0; ++c) {"),
         ("             c >= (t == 0 ? 1 : t * SCAN_TILE); --c) {",
          "             c >= n; --c) {")]),
    "no_stats": (
        "ablation: the chunk pass's statistics loop skipped (its block sum "
        "kept)",
        [("  for (int s = tid; s < len; s += THREADS) {\n"
          "    double xd[MAX_D];",
          "  for (int s = tid; s < 0; s += THREADS) {\n"
          "    double xd[MAX_D];")]),
    "old_step": (
        "the one-state-a-lane step's exps: each lane computes its row's K "
        "exps itself (no gather of the exps), on the same K^2 lanes",
        [("constexpr bool K2_ONE_EXP = true;",
          "constexpr bool K2_ONE_EXP = false;")]),
    "one_warp": (
        "H1's two chains in one warp, lanes 0-15 forward and 16-31 backward",
        [("constexpr bool H1_ONE_WARP = false;",
          "constexpr bool H1_ONE_WARP = true;")]),
    "scan_global": (
        "the scan's transfers read from global memory on the chain, as the "
        "parent's scan read them",
        [("constexpr bool SCAN_SMEM = true;",
          "constexpr bool SCAN_SMEM = false;")]),
    "scan_tile64": (
        "the scan's tiles 64 chunks, not 32",
        [("constexpr int SCAN_TILE = 32;", "constexpr int SCAN_TILE = 64;")]),
    "chunk_blocks2": (
        "the chunk pass at the blocks an SM its registers allow (233 "
        "registers at KM 4: two), not four",
        [("constexpr int CHUNK_MIN_BLOCKS = 4;",
          "constexpr int CHUNK_MIN_BLOCKS = 1;")]),
    "chunk_blocks3": (
        "the chunk pass at three blocks an SM (168 registers), not four",
        [("constexpr int CHUNK_MIN_BLOCKS = 4;",
          "constexpr int CHUNK_MIN_BLOCKS = 3;")]),
    "chunk_blocks5": (
        "the chunk pass at five blocks an SM (102 registers), not four",
        [("constexpr int CHUNK_MIN_BLOCKS = 4;",
          "constexpr int CHUNK_MIN_BLOCKS = 5;")]),
}
HMM_EM_GROUPS = (1, 4, 8, 16)      # hmm_cuda.EM_GROUP, timed in turns too
HMM_REPS = 3

DG_BOUNDS = ("__global__ void __launch_bounds__(DG_THREADS, DG_MIN_BLOCKS)\n"
             "display_grad_kernel(")
DISPLAY_GRAD_VARIANTS = {
    "ieee_divisions": (
        "the parent's per-pixel divisions: u = v / d, g / rng, r = num / "
        "rng and DB_SLOPE / y / d each an IEEE division (the log10 kept)",
        [("  if (!c.fast || !isfinite(vf)) {",
          "  if (true) {"),
         ("__dmul_rn(hu, __dmul_rn(static_cast<double>(gf),\n"
          "                                             c.inv_d));",
          "__dmul_rn(hu, __ddiv_rn(static_cast<double>(gf),\n"
          "                                             c.d));"),
         ("__dmul_rn(static_cast<double>(gf), inv_rng)",
          "__ddiv_rn(static_cast<double>(gf), rng)"),
         ("__dmul_rn(num, inv_rng)", "__ddiv_rn(num, rng)"),
         ("__dmul_rn(c.sd, recip(y))",
          "__ddiv_rn(__ddiv_rn(DB_SLOPE, y), c.d)")]),
    "per_tile_ops": (
        "the parent's clip operands: every thread recomputes d's "
        "reciprocals and both extrema's dB values (two log10, eight "
        "divisions) for every DG_BATCH pixels",
        [("    const ClipOps c = s_ops;\n", "    ClipOps c = s_ops;\n"),
         ("      for (int j0 = 0; j0 < nt; j0 += DG_BATCH) {\n",
          "      for (int j0 = 0; j0 < nt; j0 += DG_BATCH) {\n"
          "        c.d = *reinterpret_cast<volatile double*>(&s_ops.d);\n"
          "        c.inv_d = __ddiv_rn(1.0, c.d);\n"
          "        c.sd = __ddiv_rn(DB_SLOPE, c.d);\n"
          "        if (LOG) {\n"
          "          c.db_lo = db_grad(c.lo, c.d).db;\n"
          "          rng = __dsub_rn(db_grad(c.hi, c.d).db, c.db_lo);\n"
          "          ok = rng > 1e-6;\n"
          "          inv_rng = ok ? __ddiv_rn(1.0, rng) : 1.0;\n"
          "        }\n")]),
    "chunks16": (
        "items of 16 chunks (512 frames), a warp two chunks in turn",
        [("constexpr int DG_CHUNKS = 8;", "constexpr int DG_CHUNKS = 16;")]),
    "batch4": (
        "four pixels a lane in flight, not two",
        [("constexpr int DG_BATCH = 2;", "constexpr int DG_BATCH = 4;")]),
    "batch1": (
        "a pixel a lane at a time, not two",
        [("constexpr int DG_BATCH = 2;", "constexpr int DG_BATCH = 1;")]),
    "f32_recip": (
        "1/y from the float reciprocal and one Newton step (two F2F "
        "conversions), not the 64-bit seed and two steps",
        [("  double r = rcp_approx(y);\n"
          "  r = __fma_rn(r, __fma_rn(-y, r, 1.0), r);\n",
          "  const double r = __frcp_rn(__double2float_rn(y));\n")]),
    "f64_decisions": (
        "u's clip and clip_slope(u) from f64 compares of u, not float "
        "compares of v against d",
        [("  o.clipped = vf >= c.df ? 1.0 : (vf <= 0.0f ? 0.0 : o.u);\n"
          "  o.slope = (vf > 0.0f && vf < c.df)\n"
          "                ? 1.0\n"
          "                : ((vf == 0.0f || vf == c.df) ? 0.5 : 0.0);\n",
          "  o.clipped = o.u < 0.0 ? 0.0 : (o.u > 1.0 ? 1.0 : o.u);\n"
          "  o.slope = clip_slope(o.u);\n")]),
    "bounds_free": (
        "no blocks-an-SM floor in the launch bounds (the registers ptxas "
        "picks)",
        [(DG_BOUNDS, DG_BOUNDS.replace("(DG_THREADS, DG_MIN_BLOCKS)",
                                       "(DG_THREADS)"))]),
    "blocks4": (
        "at least four blocks an SM (at most 64 registers), not five",
        [("constexpr int DG_MIN_BLOCKS = 5;",
          "constexpr int DG_MIN_BLOCKS = 4;")]),
    "blocks6": (
        "at least six blocks an SM (at most 40 registers), not five",
        [("constexpr int DG_MIN_BLOCKS = 5;",
          "constexpr int DG_MIN_BLOCKS = 6;")]),
    "noinline_clip_done": (
        "the clip's fold and extrema step a function of its own (not "
        "inlined into the pass)",
        [("__device__ void grad_clip_done(",
          "__device__ __noinline__ void grad_clip_done(")]),
    "one_newton": (
        "1/y from the 64-bit seed and one Newton step, not two",
        [("  double r = rcp_approx(y);\n"
          "  r = __fma_rn(r, __fma_rn(-y, r, 1.0), r);\n",
          "  double r = rcp_approx(y);\n")]),
    "no_memory": (
        "ablation: the pixels' arithmetic on values made in registers (no "
        "PSD loads, no stores; g's copies kept)",
        [("        nv[j] = j < nt ? src[static_cast<long long>(j) * F] : 0.0f;",
          "        nv[j] = c.lo + 1e-3f * (j + lane);"),
         ("          nv[j] = jn < nt ? src[static_cast<long long>(jn) * F] "
          ": 0.0f;",
          "          nv[j] = c.lo + 1e-3f * (jn + lane);"),
         ("            dst[static_cast<long long>(j0 + j) * F] = "
          "pixel_grad<LOG>(",
          "            acc.su += pixel_grad<LOG>(")]),
    "no_extrema": (
        "ablation: no clip's fold and no extrema step (the records kept)",
        [("    if (flag[0])\n      grad_clip_done<LOG>(",
          "    if (false)\n      grad_clip_done<LOG>(")]),
    "no_fallback": (
        "ablation: u always the corrected reciprocal product (no IEEE "
        "division for a non-finite v or d; its SASS is the common path's)",
        [("  if (!c.fast || !isfinite(vf)) {", "  if (false) {")]),
    "no_log10": (
        "ablation: the pixel's dB value without its log10 (10 y)",
        [("__dsub_rn(__dmul_rn(10.0, log10(y)), c.db_lo)",
          "__dsub_rn(__dmul_rn(10.0, y), c.db_lo)")]),
    "no_math": (
        "ablation: the pixel's term is g + v (copies, counts, records, "
        "stores and the extrema step kept; the pixel's f64 code compiled "
        "out, so its SASS is the rest's)",
        [("  if (!ok) return 0.0f;\n  const Quotient qu = quotient(vf, c);",
          "  if (ok || !ok) return vf + gf;\n"
          "  const Quotient qu = quotient(vf, c);")]),
}
DISPLAY_GRAD_REPS = 5

MEL_VARIANTS = {
    "weights_global": (
        "the weights read from global memory (a broadcast a step), not "
        "staged in shared memory",
        [("  if (static_cast<long long>(n_w) * 8 <= MP_W_SMEM)",
          "  if (false)")]),
    "rows16": (
        "tiles of 16 rows (two blocks an SM; lanes 16-31 idle in the sums)",
        [("constexpr int MP_ROWS = 32;", "constexpr int MP_ROWS = 16;")]),
    "scalar_copies": (
        "4-byte copies a row, not the tile's run in 16-byte copies",
        [("  const int vec = (F & 1) &&", "  const int vec = false &&")]),
    "one_chain": (
        "one mel row at a time a warp (one FMA chain), not two",
        [("constexpr int MP_CHAINS = 2;", "constexpr int MP_CHAINS = 1;")]),
    "four_chains": (
        "four consecutive mel rows at a time a warp, not two",
        [("constexpr int MP_CHAINS = 2;", "constexpr int MP_CHAINS = 4;")]),
    "threads256": (
        "blocks of 256 threads (8 warps), not 512",
        [("constexpr int MP_THREADS = 512;",
          "constexpr int MP_THREADS = 256;")]),
    "no_sums": (
        "ablation: the spans' FMAs skipped (copies, scan, stores and "
        "partials kept)",
        [("        for (int k = 0; k < kn; ++k)\n",
          "        for (int k = 0; k < 0; ++k)\n")]),
    "no_scan": (
        "ablation: the tile's non-finite pass skipped",
        [("    if (F & 1) {\n      const int count = n * F;",
          "    if (false) {\n      const int count = n * F;")]),
}

def _r2_launch(stft_cuda, cfg, dev, a):
    c = stft_cuda.fft_constants(cfg, FS, dev)
    return lambda lib: lib.stft_fft_psd_launch(
        a.x, c.window.data_ptr(), c.twiddles.data_ptr(), c.wts.data_ptr(),
        *a.outs, *a.shape, a.detrend, 0, 0, 1, 0, a.stream)


def _mixed_launch(stft_cuda, cfg, dev, a):
    c = stft_cuda.mixed_constants(cfg, FS, dev)
    return lambda lib: lib.stft_mixed_fft_psd_launch(
        a.x, c.window.data_ptr(), c.perm.data_ptr(), c.twiddles.data_ptr(),
        c.stages.ctypes.data, len(c.stages), c.split, c.rader,
        c.wts.data_ptr(), *a.outs, *a.shape, a.detrend, 0, 0, 1, 0, a.stream)


def _conv_launch(stft_cuda, cfg, dev, a):
    if stft_cuda.route(cfg) == "odd":
        c = stft_cuda.mixed_constants(cfg, FS, dev)
        return lambda lib: lib.stft_odd_fft_psd_launch(
            a.x, c.window.data_ptr(), c.perm.data_ptr(),
            c.twiddles.data_ptr(), c.stages.ctypes.data, len(c.stages),
            c.rader, c.wts.data_ptr(), *a.outs, *a.shape, a.detrend, 0, 0,
            1, 1, 0, a.stream)
    c = stft_cuda.bluestein_constants(cfg, FS, dev)
    return lambda lib: lib.stft_bluestein_psd_launch(
        a.x, c.window.data_ptr(), c.twiddles.data_ptr(),
        c.stages.ctypes.data, len(c.stages), c.m, c.bhat, c.chirp, c.split,
        c.wts.data_ptr(), *a.outs, *a.shape, a.detrend, 0, 0, 1, 0, a.stream)


def _rader_launch(stft_cuda, cfg, dev, a):
    if stft_cuda.route(cfg) == "odd":
        return _conv_launch(stft_cuda, cfg, dev, a)
    return _mixed_launch(stft_cuda, cfg, dev, a)


def _grad_launch(stft_cuda, cfg, dev, a):
    """stft_fft_backward_launch on a seeded gradient of the PSD; the
    frames' gradient d is the output compared."""
    import torch
    c = stft_cuda.fft_constants(cfg, FS, dev)
    B, n, T, F, K, L, hop = a.shape
    gen = torch.Generator(device=dev).manual_seed(4)
    g = torch.rand((B, T, F), generator=gen, device=dev)
    d = torch.empty((B, T, L), device=dev)

    def launch(lib):
        return lib.stft_fft_backward_launch(
            a.x, g.data_ptr(), c.window.data_ptr(), c.twiddles.data_ptr(),
            c.wts.data_ptr(), d.data_ptr(), B, n, T, F, K, L, hop, a.detrend,
            0, 0, 0, a.stream)
    launch.output = d
    return launch


def _grad_mixed_launch(stft_cuda, cfg, dev, a):
    """stft_mixed_fft_backward_launch or stft_odd_fft_backward_launch, by
    the config's route, on a seeded gradient of the PSD; the frames'
    gradient d is the output compared."""
    import torch
    c = stft_cuda.mixed_constants(cfg, FS, dev)
    B, n, T, F, K, L, hop = a.shape
    gen = torch.Generator(device=dev).manual_seed(4)
    g = torch.rand((B, T, F), generator=gen, device=dev)
    d = torch.empty((B, T, L), device=dev)
    head = (a.x, g.data_ptr(), c.window.data_ptr(), c.perm.data_ptr(),
            c.twiddles.data_ptr(), c.stages.ctypes.data, len(c.stages))
    sizes = (B, n, T, F, K, L, hop, a.detrend, 0, 0)

    def launch(lib):
        if stft_cuda.route(cfg) == "odd":
            return lib.stft_odd_fft_backward_launch(
                *head, c.rader, c.wts.data_ptr(), d.data_ptr(), *sizes, 0,
                a.stream)
        return lib.stft_mixed_fft_backward_launch(
            *head, c.split, c.rader, c.wts.data_ptr(), d.data_ptr(), *sizes,
            0, a.stream)
    launch.output = d
    return launch


def _grad_bluestein_launch(stft_cuda, cfg, dev, a):
    """stft_bluestein_fft_backward_launch on a seeded gradient of the PSD;
    the frames' gradient d is the output compared."""
    import torch
    c = stft_cuda.bluestein_constants(cfg, FS, dev)
    B, n, T, F, K, L, hop = a.shape
    gen = torch.Generator(device=dev).manual_seed(4)
    g = torch.rand((B, T, F), generator=gen, device=dev)
    d = torch.empty((B, T, L), device=dev)

    def launch(lib):
        return lib.stft_bluestein_fft_backward_launch(
            a.x, g.data_ptr(), c.window.data_ptr(), c.twiddles.data_ptr(),
            c.stages.ctypes.data, len(c.stages), c.m, c.bhat, c.chirp,
            c.split, c.wts.data_ptr(), d.data_ptr(), B, n, T, F, K, L, hop,
            a.detrend, 0, 0, 0, a.stream)
    launch.output = d
    return launch


def _small_launch(stft_cuda, cfg, dev, a):
    c = stft_cuda.dft_constants(cfg, FS, dev)
    return lambda lib: lib.stft_psd_launch(
        a.x, c.a_re.data_ptr(), c.a_im.data_ptr(), c.wts.data_ptr(), *a.outs,
        *a.shape[:4], *a.shape[5:], 0, 0, 1, a.stream)

@dataclasses.dataclass(frozen=True)
class Kernel:
    routes: tuple          # the routes whose configs it launches
    ptxas: tuple           # (entry pattern, label) for chip_smoke's parser
    paths: tuple           # chip_smoke.py's paths (label, nperseg, detrend):
                           # scipy_default on 256 clips of 60 s, path 1
                           # north_star nperseg/256 on 1024 clips of 10 s
    nperseg: tuple         # scipy_default on 1024 clips of 10 s
    launch: object         # (stft_cuda, cfg, dev, args) -> launch(lib),
                           # its ``output`` the tensor compared (else the
                           # PSD)
    variants: dict
    source: str = "stft_psd"   # csrc/<source>.cu


KERNELS = {
    "r2": Kernel(
        ("fft",),
        (r"stft_fft_psd_kernelILi(\d+)ELi(\d+)ELb(\d)E",
         lambda e: f"LOG2M {e.group(1)}, {2 ** int(e.group(2))} values"
                   f"{', EXT' if e.group(3) == '1' else ''}"),
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
        (r"stft_(odd_fft|bluestein)_psd_kernelIL[bi](\d)EL[ib](\d+)E"
         r"(?:Lb(\d)E)?",
         lambda e: f"{e.group(1).split('_')[0]}<{e.group(2)}, "
                   f"{e.group(3)}"
                   f"{', ' + e.group(4) if e.group(4) else ''}>"),
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
        (r"stft_psd_(small_kernelILi(\d)ELb(\d)E|kernelE)",
         lambda e: (f"small<{e.group(2)}{', EXT' if e.group(3) == '1' else ''}"
                    ">") if e.group(2) else "large"),
        (), (2, 7, 13, 24, 31), _small_launch, SMALL_VARIANTS),
    "grad": Kernel(
        ("fft",),
        (r"stft_fft_backward_kernelILi(\d+)ELi(\d+)E",
         lambda e: f"LOG2M {e.group(1)}, {2 ** int(e.group(2))} values"),
        (("path 1 north_star 1024/256", 1024, None),),
        (32, 256, 2048, 8192), _grad_launch, GRAD_VARIANTS, "stft_grad"),
    "grad_mixed": Kernel(
        ("mixed", "odd"),
        (r"stft_(mixed_fft_backward_kernelILi(\d+)E|odd_fft_backward_"
         r"kernelILb(\d)ELi(\d+)ELb(\d)E)",
         lambda e: f"mixed<{e.group(2)}>" if e.group(2) is not None else
         f"odd<{e.group(3)}, {e.group(4)}, {e.group(5)}>"),
        (("path 4 scipy_default 8160", 8160, None),
         ("path 7 scipy_default 8191", 8191, None),
         ("path 11 scipy_default 8186", 8186, None)),
        (992, 1006, 1023, 8032), _grad_mixed_launch, GRAD_MIXED_VARIANTS,
        "stft_grad_mixed"),
    "grad_bluestein": Kernel(
        ("bluestein",),
        (r"stft_bluestein_fft_backward_kernelILi(\d)ELb(\d)ELb(\d)E",
         lambda e: f"<{e.group(1)}, {e.group(2)}, {e.group(3)}>"),
        (("path 8 scipy_default 8185", 8185, None),
         ("path 9 scipy_default 8182", 8182, None)),
        (563, 1126, 2049, 2999, 6994), _grad_bluestein_launch,
        GRAD_BLUESTEIN_VARIANTS, "stft_grad_mixed"),
    "hmm": Kernel((), chip_smoke.HMM_PTXAS, (), (), None, HMM_VARIANTS,
                  "hmm"),
    "display_grad": Kernel(
        (), (r"display_grad_(kernelILb(\d)E|prep_kernel)",
             lambda e: f"grad<LOG {e.group(2)}>" if e.group(2) else "prep"),
        (), (), None, DISPLAY_GRAD_VARIANTS, "display"),
    "mel": Kernel(
        (), (r"(mel_project_kernel|mel_backward_kernel)",
             lambda e: e.group(1)),
        (), (), None, MEL_VARIANTS, "mel"),
}


def hmm_shapes(dev):
    """chip_smoke.py's detection shapes on seeded features
    (``chip_smoke.hmm_features``): path 14's, 256 sweeps of 1,071 frames,
    each from the host's k-means start, n_iter 100; path 15's, one hour of
    524,288 frames from the k-means start of its first 65,536."""
    import numpy as np
    import torch
    from spectral_tpu_torch.models import hmm
    feats = [chip_smoke.hmm_features(np.random.RandomState(s), 1071)
             for s in range(256)]
    X14 = torch.tensor(np.stack(feats), device=dev)
    p14 = chip_smoke.stack_params([hmm.init_params(f, 4, device=dev)
                                   for f in feats])
    f15 = chip_smoke.hmm_features(np.random.RandomState(15), 524288)
    X15 = torch.tensor(f15[None], device=dev)
    p15 = chip_smoke.stack_params([hmm.init_params(f15[:65536], 4,
                                                   device=dev)])
    return (X14, tuple(p14)), (X15, tuple(p15))


def hmm_main(args, kern, names, libs, regs, card):
    """The hmm set: H1 (hmm_fit_launch) at path 14's shapes, and at path
    15's H3's EM loop (hmm_fit_chunked_launch, its host loop as
    ops/hmm_cuda.py::fit_chunked runs it, at each EM_GROUP of
    HMM_EM_GROUPS with this build) and one E-step
    (hmm_estep_chunked_launch); two rounds in turns, CUDA events (the EM
    loop on the host clock, synchronised), median of HMM_REPS. Design
    variants must give this build's bits; ablations time a part."""
    import time as _time
    import torch
    from spectral_tpu_torch.models import hmm
    from spectral_tpu_torch.ops import hmm_cuda
    dev = torch.device("cuda", 0)
    ref = hmm_cuda._library()
    for lib in libs.values():
        for entry in ("hmm_fit_launch", "hmm_estep_chunked_launch",
                      "hmm_fit_chunked_launch", "hmm_fit_scratch"):
            getattr(lib, entry).argtypes = getattr(ref, entry).argtypes
            getattr(lib, entry).restype = getattr(ref, entry).restype
    (X14, p14), (X15, p15) = hmm_shapes(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tol = hmm.DEFAULT_TOL

    def fit(lib):
        B, T, D = X14.shape
        K = p14[0].shape[-1]
        out = [torch.empty_like(p) for p in p14]
        ll = torch.empty(B, dtype=torch.float64, device=dev)
        it = torch.empty(B, dtype=torch.int32, device=dev)
        err = lib.hmm_fit_launch(X14.data_ptr(), B, T, D, K,
                                 *[p.data_ptr() for p in p14], 100, tol,
                                 *[o.data_ptr() for o in out], ll.data_ptr(),
                                 it.data_ptr(), None, stream)
        if err:
            raise SystemExit(f"hmm_fit_launch failed with {err}")
        return (*out, ll, it)

    def em(lib, group=hmm_cuda.EM_GROUP):
        saved = hmm_cuda._LIB[:]
        hmm_cuda._LIB[:] = [lib]
        old_group, hmm_cuda.EM_GROUP = hmm_cuda.EM_GROUP, group
        try:
            p, ll, it = hmm_cuda.fit_chunked(X15, p15, 256, 100, tol)
        finally:
            hmm_cuda._LIB[:] = saved
            hmm_cuda.EM_GROUP = old_group
        return (*p, ll, it)

    def estep(lib):
        saved = hmm_cuda._LIB[:]
        hmm_cuda._LIB[:] = [lib]
        try:
            return hmm_cuda.estep_chunked(X15, p15, 256)
        finally:
            hmm_cuda._LIB[:] = saved

    def events_ms(fn):
        return chip_smoke.time_ms(fn, reps=HMM_REPS)[0]

    def host_ms(fn):
        times = []
        for _ in range(HMM_REPS):
            torch.cuda.synchronize()
            t0 = _time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (_time.perf_counter() - t0))
        return sorted(times)[HMM_REPS // 2]

    def bits(ts):
        return [t.view(torch.int64) if t.dtype == torch.float64 else t
                for t in ts]

    cases = {"H1 path 14 (256 x 1071, n_iter 100)": (fit, events_ms),
             "H3 EM loop path 15 (524288 frames, n_iter 100)": (em, host_ms),
             "H3 E-step path 15": (estep, events_ms)}
    report = {"kernel": "hmm", "card": card, "ptxas": regs, "configs": {}}
    for label, (fn, clock) in cases.items():
        want = bits(fn(libs["this"]))
        torch.cuda.synchronize()
        row = {}
        for rnd in range(2):
            for name in (names if rnd == 0 else names[::-1]):
                got = bits(fn(libs[name]))
                entry = row.setdefault(name, {"ms": []})
                entry["same_output"] = all(torch.equal(a, b)
                                           for a, b in zip(got, want))
                entry["ms"].append(clock(lambda: fn(libs[name])))
        if fn is em:
            it = int(want[-1].max())
            for rnd in range(2):
                for g in (HMM_EM_GROUPS if rnd == 0 else HMM_EM_GROUPS[::-1]):
                    entry = row.setdefault(f"EM_GROUP {g}", {"ms": []})
                    got = bits(em(libs["this"], g))
                    entry["same_output"] = all(torch.equal(a, b)
                                               for a, b in zip(got, want))
                    entry["ms"].append(host_ms(lambda: em(libs["this"], g)))
            row["iterations"] = it
        report["configs"][label] = row
        print(label, {k: v if not isinstance(v, dict) else
                      [round(t, 3) for t in v["ms"]]
                      for k, v in row.items()}, flush=True)
    print(json.dumps(report))

def sass_counts(so, pattern):
    """{function: {opcode: count}} of the functions matching ``pattern`` in
    cuobjdump's SASS of the library ``so`` (a static count: each
    instruction once, wherever it sits)."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if re.search(pattern, m.group(1)) else None
            if cur:
                out[cur] = {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if cur and m:
            op = m.group(1)
            out[cur][op] = out[cur].get(op, 0) + 1
    return out


def fp64_issue(counts):
    """(FP64 pipe instructions, quarter-rate ones) of one function's
    opcode counts: D* (DFMA, DMUL, DADD, DSETP, DMNMX) on the FP64 pipe;
    conversions to or from F64 and MUFU's 64-bit ops at a quarter of its
    rate."""
    full = sum(n for op, n in counts.items() if op[0] == "D"
               and op.split(".")[0] in ("DFMA", "DMUL", "DADD", "DSETP",
                                        "DMNMX"))
    quarter = sum(n for op, n in counts.items()
                  if (op.startswith(("F2F", "I2F", "F2I")) and "64" in op)
                  or (op.startswith("MUFU") and "64" in op))
    return full, quarter


def _timed(fn, reps=REPS):
    """CUDA events around one call, median of ``reps`` after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def display_main(args, kern, names, libs, regs, card):
    """The display_grad set: display_backward_launch at path 1's shapes
    (1024 clips x 622 frames x 513 bins: log and flipped as path 21 calls
    it, linear, share_max) and at path 12's mel rows (128), on the PSD of
    seeded noise and its clip_stats operands and a seeded g; two rounds in
    turns, CUDA events, median of DISPLAY_GRAD_REPS. This build is held to
    the plain version (``display_backward_reference``) on 8 clips within
    chip_smoke's GRAD_TOL; each variant's output of the first 16 clips to
    this build's, bitwise or by the largest |difference| over the clip's
    largest entry. The SASS of the LOG instantiation is counted
    (cuobjdump): the FP64 and quarter-rate instructions of this build, of
    the no_fallback and no_log10 ablations and of no_math, whose
    difference from each over the pixel code's copies is the pixel's own
    (a static count: each instruction once)."""
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.core.mel import mel_filterbank
    from spectral_tpu_torch.ops import display_cuda as disp
    from spectral_tpu_torch.ops import mel_cuda, stft_cuda
    dev = torch.device("cuda", 0)
    ref = disp._library()
    for lib in libs.values():
        for entry in ("display_backward_launch",
                      "display_backward_workspace_bytes"):
            getattr(lib, entry).argtypes = getattr(ref, entry).argtypes
            getattr(lib, entry).restype = getattr(ref, entry).restype
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(21)
    n = int(FS * 10.0)
    x = torch.randn((1024, n), generator=gen, device=dev)
    cfg = SpecConfig.north_star(1024, 256)
    psd, parts = stft_cuda.stft_psd_partials(x, FS, cfg)
    spans = mel_cuda.mel_spans(mel_filterbank(128, cfg.n_freqs, FS), dev)
    mel, mparts = mel_cuda.mel_project(psd, spans)
    cases = {
        "path 1 PSD rows, log, flipped": (psd, parts, True, True, False),
        "path 1 PSD rows, linear": (psd, parts, False, False, False),
        "path 1 PSD rows, log, share_max": (psd, parts, True, True, True),
        "path 12 mel rows, log, flipped": (mel, mparts, True, True, False)}

    def launcher(lib, g, rows, params, out, log, flip, share):
        B, T, F = rows.shape
        ws = torch.empty(lib.display_backward_workspace_bytes(B, T, F),
                         dtype=torch.uint8, device=dev)

        def launch():
            err = lib.display_backward_launch(
                g.data_ptr(), rows.data_ptr(), params.data_ptr(),
                out.data_ptr(), ws.data_ptr(), B, T, F, int(log), int(flip),
                int(share), stream)
            if err:
                raise SystemExit(f"display_backward_launch failed: {err}")
        return launch

    report = {"kernel": "display_grad", "card": card, "ptxas": regs,
              "configs": {}}
    for label, (rows, prt, log, flip, share) in cases.items():
        B, T, F = rows.shape
        params = disp.clip_stats(x, prt.contiguous(), share).params
        g = torch.rand((B, F, T), generator=gen, device=dev)
        # this build against the plain version on 8 clips
        c = 8
        p8 = disp.clip_stats(x[:c], prt[:, :, :c].contiguous(),
                             share).params
        o8 = torch.empty_like(rows[:c])
        launcher(libs["this"], g[:c].contiguous(), rows[:c].contiguous(),
                 p8, o8, log, flip, share)()
        want = disp.display_backward_reference(
            g[:c], rows[:c], p8, log_scale=log, flip_image=flip,
            share_max=share)
        plain_rel = chip_smoke.clip_rel(o8, want)[0]
        if not plain_rel <= chip_smoke.GRAD_TOL:
            raise SystemExit(f"{label}: {plain_rel:.2e} from the plain "
                             f"version")
        out = torch.empty_like(rows)
        launcher(libs["this"], g, rows, params, out, log, flip, share)()
        torch.cuda.synchronize()
        want = out[:16].clone()
        row = {"plain_rel": plain_rel}
        for rnd in range(2):
            for name in (names if rnd == 0 else names[::-1]):
                launch = launcher(libs[name], g, rows, params, out, log,
                                  flip, share)
                entry = row.setdefault(name, {"ms": []})
                entry["ms"].append(_timed(launch, DISPLAY_GRAD_REPS))
                entry["same_output"] = bool(torch.equal(
                    out[:16].view(torch.int32), want.view(torch.int32)))
                entry["rel"] = chip_smoke.clip_rel(out[:16], want)[0] \
                    if not name.startswith("no_") else None
        report["configs"][label] = row
        print(label, {k: v if not isinstance(v, dict) else
                      [round(t, 3) for t in v["ms"]]
                      for k, v in row.items()}, flush=True)
        del out, g
        torch.cuda.empty_cache()
    sass = {}
    for name in ("this", "no_fallback", "no_log10", "no_math"):
        if name not in libs:
            continue
        so = os.path.join(OUT_DIR, "display_grad", name, "libdisplay.so")
        for fn, counts in sass_counts(so, r"display_grad_kernelILb1E").items():
            sass[name] = dict(zip(("fp64", "quarter_rate"),
                                  fp64_issue(counts)), opcodes=counts)
    if "no_math" in sass:
        # the pixel's code, once a copy in the chunk's loop
        copies = pixel_copies()
        for name in ("this", "no_fallback", "no_log10"):
            if name in sass:
                sass[f"pixel ({name})"] = {
                    k: (sass[name][k] - sass["no_math"][k]) / copies
                    for k in ("fp64", "quarter_rate")}
    report["sass"] = {k: {kk: vv for kk, vv in v.items() if kk != "opcodes"}
                      for k, v in sass.items()}
    report["sass_opcodes"] = {k: v.get("opcodes") for k, v in sass.items()}
    print(json.dumps(report))


def pixel_copies():
    """The copies of the pixel's code in display_grad_kernel: its batch
    loop (DG_BATCH pixels a lane) unrolled, the loop over batches not."""
    import re
    with open(os.path.join(CSRC, "display.cu")) as fh:
        return int(re.search(r"constexpr int DG_BATCH = (\d+);",
                             fh.read()).group(1))


def mel_main(args, kern, names, libs, regs, card):
    """The mel set: mel_project_launch at path 12's shapes (1024 clips x
    622 frames x 513 bins, 128 mels) and at scipy_default 8192's (256
    clips x 60 s, 4097 bins, 64 mels), on the PSD of seeded noise; two
    rounds in turns, CUDA events, median of 5. This build is held to the
    plain version (``mel_project_reference``) on 16 clips within
    chip_smoke's MEL_ULPS, NaN and inf in its places; each variant's mel
    rows and partials to this build's, bitwise."""
    import torch
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.core.mel import mel_filterbank
    from spectral_tpu_torch.ops import mel_cuda, stft_cuda
    dev = torch.device("cuda", 0)
    ref = mel_cuda._library()
    for lib in libs.values():
        lib.mel_project_launch.argtypes = ref.mel_project_launch.argtypes
        lib.mel_project_launch.restype = ref.mel_project_launch.restype
    stream = torch.cuda.current_stream(dev).cuda_stream
    report = {"kernel": "mel", "card": card, "ptxas": regs, "configs": {}}
    for label, cfg, M, clips, seconds in (
            ("path 12 128 mels over 513 bins",
             SpecConfig.north_star(1024, 256), 128, 1024, 10.0),
            ("scipy_default 8192, 64 mels over 4097 bins",
             SpecConfig.scipy_default(8192), 64, 256, 60.0)):
        gen = torch.Generator(device=dev).manual_seed(12)
        x = torch.randn((clips, int(FS * seconds)), generator=gen,
                        device=dev)
        psd = stft_cuda.stft_psd(x, FS, cfg)
        del x
        B, T, F = psd.shape
        spans = mel_cuda.mel_spans(mel_filterbank(M, F, FS), dev)
        out = torch.empty((B, T, M), device=dev)
        parts = torch.empty((2, B * T), device=dev)

        def launcher(lib):
            def launch():
                err = lib.mel_project_launch(
                    psd.data_ptr(), spans.start.data_ptr(),
                    spans.length.data_ptr(), spans.offset.data_ptr(),
                    spans.weights.data_ptr(), B * T, F, M, out.data_ptr(),
                    parts[0].data_ptr(), parts[1].data_ptr(), stream)
                if err:
                    raise SystemExit(f"mel_project_launch failed: {err}")
            return launch

        launcher(libs["this"])()
        torch.cuda.synchronize()
        want, wparts = mel_cuda.mel_project_reference(psd[:16], spans)
        ulps = chip_smoke.ulp_distance(out[:16], want)
        same_places = bool(torch.equal(torch.isnan(out[:16]),
                                       torch.isnan(want)))
        if not (ulps <= chip_smoke.MEL_ULPS and same_places):
            raise SystemExit(f"{label}: {ulps} ulp from the plain version")
        want, wparts = out.clone(), parts.clone()
        row = {"plain_ulps": ulps}
        for rnd in range(2):
            for name in (names if rnd == 0 else names[::-1]):
                entry = row.setdefault(name, {"ms": []})
                entry["ms"].append(_timed(launcher(libs[name])))
                entry["same_output"] = bool(
                    torch.equal(out.view(torch.int32),
                                want.view(torch.int32))
                    and torch.equal(parts.view(torch.int32),
                                    wparts.view(torch.int32)))
        report["configs"][label] = row
        print(label, {k: v if not isinstance(v, dict) else
                      [round(t, 3) for t in v["ms"]]
                      for k, v in row.items()}, flush=True)
        del psd, out, parts, want, wparts
        torch.cuda.empty_cache()
    print(json.dumps(report))


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
            ("stft_fft_backward_launch", [ptr] * 6 + [i32, i64] + [i32] * 9),
            ("stft_mixed_fft_backward_launch",
             [ptr] * 6 + [i32] * 3 + [ptr] * 2 + [i32, i64] + [i32] * 9),
            ("stft_odd_fft_backward_launch",
             [ptr] * 6 + [i32] * 2 + [ptr] * 2 + [i32, i64] + [i32] * 9),
            ("stft_bluestein_fft_backward_launch",
             [ptr] * 5 + [i32] * 5 + [ptr] * 2 + [i32, i64] + [i32] * 9),
            ("stft_psd_launch", [ptr] * 4 + out + [i32] * 7),
            ("stft_fft_psd_launch", [ptr] * 4 + out + [i32] * 10),
            ("stft_mixed_fft_psd_launch",
             [ptr] * 5 + [i32] * 3 + [ptr] + out + [i32] * 10),
            ("stft_odd_fft_psd_launch",
             [ptr] * 5 + [i32] * 2 + [ptr] + out + [i32] * 11),
            ("stft_bluestein_psd_launch",
             [ptr] * 4 + [i32] * 5 + [ptr] + out + [i32] * 10)):
        if not hasattr(lib, entry):        # another source's entry
            continue
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
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_variants: this needs a CUDA card")
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
    with open(os.path.join(CSRC, f"{kern.source}.cu")) as fh:
        this_src = fh.read()
    names = ["this"] + list(args.only or kern.variants)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        src = (this_src if name == "this" else
               variant_source(this_src, kern.variants[name][1], name))
        folder = os.path.join(OUT_DIR, args.kernel, name)
        os.makedirs(folder, exist_ok=True)
        cu = os.path.join(folder, f"{kern.source}.cu")
        with open(cu, "w") as fh:
            fh.write(src)
        procs[name] = subprocess.Popen(
            [nvcc, *port_build.NVCC_FLAGS, "-o",
             os.path.join(folder, f"lib{kern.source}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, regs = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        libs[name] = load(os.path.join(OUT_DIR, args.kernel, name,
                                       f"lib{kern.source}.so"))
        regs[name] = chip_smoke.radix2_ptxas(log, *kern.ptxas)
    print(f"built {len(names)} variants in {time.perf_counter() - t0:.1f} "
          f"s; ptxas {regs}", flush=True)
    if kern.source == "hmm":
        hmm_main(args, kern, names, libs, regs, card)
        return
    if kern.source == "display":
        display_main(args, kern, names, libs, regs, card)
        return
    if kern.source == "mel":
        mel_main(args, kern, names, libs, regs, card)
        return

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
            shape=(B, n, T, F, cfg.nfft_, cfg.nperseg, cfg.hop_),
            detrend=stft_cuda.DETREND_CODES[cfg.detrend]))

        def checked(lib):
            err = launch(lib)
            if err:
                raise SystemExit(f"{label}: launch failed with {err}")

        checked(libs["this"])
        torch.cuda.synchronize()
        out = getattr(launch, "output", out)
        want = out[:16].clone()
        row = {}
        for rnd in range(2):
            for name in (names if rnd == 0 else names[::-1]):
                ms = timed(lambda: checked(libs[name]))
                entry = row.setdefault(name, {"ms": []})
                entry["ms"].append(ms)
                entry["same_output"] = bool(torch.equal(out[:16], want))
        if i == 0 and kern.source == "stft_psd":
            row["stft_psd (wrapper)"] = {"ms": [timed(
                lambda: stft_cuda.stft_psd(x, FS, cfg, with_stats=True))]}
        report["configs"][label] = row
        print(label, {k: [round(t, 3) for t in v["ms"]]
                      for k, v in row.items()}, flush=True)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
