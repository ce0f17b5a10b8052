// The STFT backward on the mixed-radix, odd and Bluestein routes for
// NVIDIA Hopper (sm_90a): the adjoint of the forward kernels of
// csrc/stft_psd.cu on those routes, on their own engines, as stft_grad.cu's
// stft_fft_backward_kernel is on the radix-2 route.
//
// The JAX package differentiates its STFT/PSD by jax.grad through
// spectral_tpu/core/stft.py::power_spectrogram (:769) and stft (:388); its
// Pallas kernel (stft_pallas.py:431) has no gradient. The port's backward
// is launched by ops/stft_cuda.py::stft_backward by backward_route: here
// "mixed" (stft_mixed_fft_backward_launch), "odd"
// (stft_odd_fft_backward_launch) and "bluestein"
// (stft_bluestein_fft_backward_launch); overlap_add_kernel (stft_grad.cu)
// follows each.
//
// The function. With X[f] = sum_n v[n] e^{-2 pi i f n / K} the forward's
// transform of the frame v (its L samples detrended and windowed, zero to
// K = nfft) and H[f] = dL/dX_re + i dL/dX_im the cotangent of the output's
// bins (stft_grad.cu::cotangent_of: the PSD's 2 w g X, the magnitude's
// w g X / |X|, 0 at |X| = 0, the complex STFT's w g; 0 where |X|^2 is past
// float32's range; 0 outside the band), the frame's gradient is
//
//   d_v[n] = Re sum_f H1[f] e^{+2 pi i f n / K},  f = 0 .. floor(K/2),
//
// H1 the one-sided cotangent (a two-sided spectrum's bin K - f folded onto
// f as conj H), then d = the detrend's projection (its own transpose) of
// window * d_v over the first L samples. With the Hermitian spectrum S
// (S[0] = Re H1[0], S[K/2] = Re H1[K/2] for even K, S[f] = H1[f] / 2
// otherwise, S[K - f] = conj S[f]), d_v is S's unnormalized inverse DFT,
// real, and an inverse DFT is the forward DFT of conjugated values,
// conjugated: IDFT(y) = conj DFT(conj y). So each kernel takes X from its
// route's forward engine and runs the same engine again for the inverse:
// no new butterfly arithmetic, no dense matrix, no X in memory and no
// launch of the forward's complex epilogue.
//
// stft_mixed_fft_backward_kernel<RMAX> (mixed route, even K = 32-8192 whose
//   M = K/2 is 255-smooth; the forward's geometry: MIX_THREADS threads, plan.
//   frames frames a block of plan.pf threads each, passes in registers):
//   1. X: the forward's load (its L samples, consecutive float2 pairs across
//      the frame's threads), detrend (mean or least-squares line over L),
//      window, the scatter through perm and the plan's passes in time
//      (natural-order Z out); skipped for the complex outputs, whose H
//      needs no X.
//   2. A pair of bins (k, M - k) a thread: X[k], X[M - k] by the split step
//      (split_bin), H1 (one_sided_cotangent), S (half_weight), and the
//      inverse split step's conj Z'[k], conj Z'[M - k] (inverse_split)
//      written in place of Z[k], Z[M - k], which the same thread read.
//   3. The M-point inverse: the plan's passes in frequency (mix_*_pass
//      with DIF, the forward passes transposed in reverse order). The DFT
//      matrix is symmetric, so these compute the same DFT as the passes in
//      time, from natural order in place (no scatter through perm, no trip
//      and no barrier for it), leaving DFT index j at slot perm[j]:
//      conj z'[j], z'[j] = d_v[2j] + i d_v[2j + 1].
//   4. Window, the detrend's projection (a frame reduction as in step 1),
//      d stored as f32 (float2 where L is even).
//
// stft_odd_fft_backward_kernel<RADER, RMAX, PACKED> (the pass engine,
//   conv_*; the forward's block of conv_plan's threads holding one
//   transform):
//   - odd route, odd K = 33-8191: two frames t, t + 1 of a clip a block.
//     The recompute is the forward's: both frames loaded as v_a + i v_b,
//     their energies summed, and the forward's guard (PAIR_MAX_RATIO, not
//     finite, all zero) decides whether they share one K-point transform
//     (A[f] = (Z[f] + conj Z[K - f]) / 2, B[f] = (Z[f] - conj Z[K - f]) /
//     2i) or each is transformed alone (X = Z), so that each frame's X is
//     the forward's. A pass over the one-sided bins f = 0 .. (K - 1)/2 (a
//     thread bins f and K - f) writes S_a[f] at bin f and S_b[f] at bin
//     K - f (S_a[0] and S_b[0], both real, share bin 0) and sums each
//     frame's |S|^2. The inverse packs the pair as Z' = S_a + i S_b, whose
//     inverse DFT is d_a + i d_b, only under a guard of its own on the
//     cotangents: both sums finite, nonzero and within PAIR_MAX_RATIO of
//     each other. Otherwise (a NaN or inf in one frame's g, or a frame
//     whose cotangent is far quieter) each frame is inverted alone, Z' = S,
//     so that neither frame's gradient takes the other's NaN or rounding;
//     frame b then takes its S from a second recompute of the pair. A
//     frame the forward transformed alone is inverted alone, and so is the
//     last frame of a clip with odd T.
//     Odd K has no Nyquist bin: S[0] = Re H1[0], S[f] = H1[f] / 2 for
//     0 < f <= (K - 1)/2.
//     Without a Rader stage the forward's passes in time leave Z in
//     natural order, and the inverse runs the passes in frequency
//     (conv_pass with DIF) on conj Z' in natural order, in place, value n
//     at slot perm[n] out. With one (RADER), transform values sit in the
//     Rader order (value i at slot perm[i], i > 0 read as x0 + slot, value
//     0 in slot P = K - 1, its transform X[0] in x_sum), and the inverse
//     writes conj Z'[f] where Z[f] was read and runs the same Rader
//     transform (conv_transform) again. Slot P is read by every bin's
//     output and written by bin 0's, so each thread holds x0 and X[0] in
//     registers across a barrier first.
//   - PACKED (with RADER): the mixed route's Rader plans, even K whose M =
//     K/2 is a prime past 255 with a 255-smooth M - 1 (514-8186): one frame
//     a block, packed as the mixed kernel's, the P = M - 1 point Rader
//     transform, then steps 2-4 above on the Rader order.
//
// stft_bluestein_fft_backward_kernel<RANKS, TWO, EXT> (the Bluestein route,
//   the 2,389 K = 32-8192 the other routes do not take; the forward's
//   geometry: conv_plan's threads, a unit a block, or a cluster of two
//   blocks past BLUE_MAX_BLOCK_POINTS; bluestein_transform, the N-point DFT
//   as a cyclic convolution of M points on the pass engine, natural order
//   in and out, X[k] = w_k conj(slot k) with w the chirp, BluesteinRead):
//   - even K, one frame a block, N = K/2: the mixed kernel's steps 2-4 on
//     Bluestein's engine. 1. The forward's load z_m = (v[2m] + i v[2m + 1])
//     w_m, zeros to M, and the transform. 2. A pair of bins (k, N - k) a
//     thread: X[k], X[N - k] by the split step, H1, S, the inverse split
//     step's conj Z'[k], conj Z'[N - k], each times w_k into the slot the
//     same thread read; slots N..M-1 zeroed (no thread reads them). 3. The
//     same transform again: the DFT of conj Z' is conj z', read as
//     w_j conj(slot j), z'[j] = d_v[2j] + i d_v[2j + 1]. 4. As the mixed
//     kernel's.
//   - odd K, frames t, t + 1 of a clip a unit, N = K: the odd kernel's
//     pairing exactly (the recompute's energy guard as the forward's, the
//     cotangents' guard for the inverse, frame b's second recompute, odd T,
//     no Nyquist bin), each transform the Bluestein one and each value
//     times w_f on its way in.
//   - the cluster (odd K from 7207, M past 14,406, up to 16,384): both
//     ranks run bluestein_transform<2> as many times, or cluster.sync
//     would not pair; both compute the frames' lines and energies from
//     global memory, as in the forward, so both know whether the recompute
//     pairs. Every output index is below N <= M/2, so the cotangent and S
//     lie in rank 0's half alone: rank 0 decides whether the inverse pairs
//     and publishes it in its shared memory (inv_flag), which rank 1 reads
//     through map_shared_rank after a cluster.sync, before the inverse's
//     first sync (past which rank 0 may exit). Rank 0 loads, forms H and
//     stores d; rank 1 only takes part in the transforms.
//   - TWO: two blocks an SM up to BLUE_TWO_BLOCK_POINTS, and EXT (a frame
//     zero-padded to nfft > nperseg, the magnitude and complex outputs), as
//     the forward's; the complex outputs need no X, so no recompute runs.
//
// Everything from the float32 loads to the float32 store is float64, on
// the host's float64 operands (ops/stft_cuda.py::mixed_constants and
// bluestein_constants): the forward's window zero-padded to K, perm, the
// plan's twiddle rows (the split step's, the Rader stage's b^, the
// Bluestein b^ and chirp among them) and every bin's weight.
// tools/torch_precision.py::grad_mixed_fft, grad_odd_fft and
// grad_bluestein are this arithmetic in numpy (tests/test_torch_grad_mixed.py
// holds them to the plain adjoint,
// ops/stft_cuda.py::frames_backward_fft_reference).
//
// Bound: bytes, the waveform x and g read once and d written once; the
// two transforms a frame (the recompute and the inverse) are the forward's
// work twice, below the bytes at the FP64 rate. The Bluestein design does
// more than the function needs: four M-point transforms a frame (M >= 2N -
// 1), about 7e10 operations at path 9's shapes, past the bytes' time even
// at the FP64 peak; its bound stays the function's.
//
// The engine (the mixed kernel's passes, the pass engine, their plans and
// constants, the Bluestein transform and its constants) is copied from
// csrc/stft_psd.cu with its text unchanged, and
// the cotangent arithmetic from csrc/stft_grad.cu, so that this source
// builds as a library of its own and neither of those sources, their
// builds or their registers move (tests/test_torch_grad_fft.py holds each
// copy to its source).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared, its own
// library (ops/build.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {


// x div d for 0 <= x < 2^31 by a multiply: shift = ceil(log2 d), mul =
// floor(2^32 (2^shift - d) / d) + 1 (Granlund and Montgomery), made on the
// host once per launch
struct FastDiv {
  unsigned d, mul, shift;
  __host__ __device__ unsigned div(unsigned v) const {
#ifdef __CUDA_ARCH__
    const unsigned hi = __umulhi(v, mul);
#else
    const unsigned hi = static_cast<unsigned>(
        (static_cast<unsigned long long>(v) * mul) >> 32);
#endif
    return (hi + v) >> shift;
  }
};

FastDiv make_fastdiv(unsigned d) {
  unsigned shift = 0;
  while ((1u << shift) < d) ++shift;
  const unsigned long long num = (1ull << 32) * ((1ull << shift) - d);
  return FastDiv{d, static_cast<unsigned>(num / d + 1), shift};
}

// The epilogues' output modes (stft_cuda.OUTPUT_MODES): the PSD (re^2 +
// im^2) w; the magnitude sqrt(re^2 + im^2) w, w the square root of the PSD
// weight (scipy's mode='magnitude'); the complex STFT (re w, im w) as
// interleaved float2, w sqrt of the PSD scale or 1 (mode='complex', and
// stft()), with no log10 and no partials
constexpr int OUT_PSD = 0;
constexpr int OUT_MAGNITUDE = 1;
constexpr int OUT_COMPLEX = 2;

constexpr int FFT_MAX_THREADS = 512;
constexpr int FFT_MAX_WARPS = FFT_MAX_THREADS / 32;

// the launchers' detrend codes
constexpr int DETREND_NONE = 0;
constexpr int DETREND_CONSTANT = 1;
constexpr int DETREND_LINEAR = 2;

// the sums of v.x and v.y over the block, returned to every thread, at one
// barrier; blockDim.x is a multiple of 32 and scratch holds one double2
// per warp
__device__ __forceinline__ double2 block_sum(double2 v, double2* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
  }
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  double2 s = make_double2(0.0, 0.0);
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    s.x += scratch[w].x;
    s.y += scratch[w].y;
  }
  return s;
}

// The FFT kernels' detrend of a K-sample frame, (mean, slope) in float64,
// to be applied as v[i] = ((double)frame[i] - mean - slope (i - c)) *
// win[i] with c = (K - 1)/2: (0, 0) under DETREND_NONE; (s0 / K, 0) under
// DETREND_CONSTANT; under DETREND_LINEAR the least-squares line, (s0 / K,
// s1 / D), s0 = sum x_i, s1 = sum (i - c) x_i, D = sum (i - c)^2 = K (K^2 -
// 1)/12 (exact in float64), which is scipy's detrend(type='linear') and the
// GEMM route's projection. The centred index keeps s1 small on a frame
// with a large offset, where sum i x_i - c sum x_i would cancel. s0 and s1
// are one block reduction; under the other codes the slope is 0 exactly,
// so the load's arithmetic is the mean's alone.
__device__ __forceinline__ double2 frame_line(const float* frame, int K,
                                              int detrend,
                                              double2* scratch) {
  if (detrend == DETREND_NONE) return make_double2(0.0, 0.0);
  const double c = 0.5 * (K - 1);
  double2 s = make_double2(0.0, 0.0);
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const double v = static_cast<double>(frame[i]);
    s.x += v;
    if (detrend == DETREND_LINEAR) s.y += (i - c) * v;
  }
  s = block_sum(s, scratch);
  const double d = K * (static_cast<double>(K) * K - 1.0) / 12.0;
  return make_double2(s.x / K, detrend == DETREND_LINEAR ? s.y / d : 0.0);
}

// The bins the FFT kernels write, the fmin/fmax band mask (the reference
// masks rows before it normalizes, PlotEngine.py:114-127): bins lo to lo +
// n - 1, bin f at column f - lo of an output row n wide; lo 0 and n the
// config's bin count for the full band. The transform is the full band's
// whatever the band: only the epilogue's bins, its stores and the row's
// (min, max) shrink, so each stored bin is the full band's bit for bit.
struct Band {
  int lo;
  int n;
  __device__ __forceinline__ int end() const { return lo + n; }
  __device__ __forceinline__ bool has(int f) const {
    return static_cast<unsigned>(f - lo) < static_cast<unsigned>(n);
  }
};

// The radix-2 butterfly of psd_fft: (a, b) <- (a + w b, a - w b)
__device__ __forceinline__ void r2_butterfly(double2& a, double2& b,
                                             double2 w) {
  const double tr = w.x * b.x - w.y * b.y;
  const double ti = w.x * b.y + w.y * b.x;
  const double2 a0 = a;
  a = make_double2(a0.x + tr, a0.y + ti);
  b = make_double2(a0.x - tr, a0.y - ti);
}

constexpr int MIX_MAX_STAGES = 16;   // N <= 8191 points: 12 factors at most
constexpr int MIX_MAX_RADIX = 255;   // largest odd radix; roots in smem

__device__ __forceinline__ double2 cmul(double2 w, double2 y) {
  return make_double2(w.x * y.x - w.y * y.y, w.x * y.y + w.y * y.x);
}

// ---------------------------------------------------------------------------
// The mixed-radix kernel's passes (see the note above its constants).

constexpr int MIX_THREADS = 512;        // a block's threads
constexpr int MIX_LOAD = 16;            // sample pairs a thread loads at most
constexpr int MIX_R2_BITS = 4;          // radix-2 stages a pass at most
constexpr int MIX_NARROW_RADIX = 127;   // the largest radix on 4 output pairs
constexpr int MIX_MAX_PASSES = MIX_MAX_STAGES;

// The output pairs a generic lane holds (RMAX, the kernel's template
// argument) by the plan's largest radix: none up to 7 (no generic pass is
// compiled in), 4 up to MIX_NARROW_RADIX (whose (p + 1)/2 pairs fill at
// most 16 warps of 4), else 8 (16 warps of 8 at 255). The generic lane's
// sums are the kernel's largest live state, so a plan carries the fewest
// its radices need.
constexpr int mix_rmax(int p_max) {
  return p_max <= 7 ? 0 : (p_max <= MIX_NARROW_RADIX ? 4 : 8);
}

// One pass: radix 2^B (B radix-2 stages at spans L, 2L, ..., twiddle rows
// tw[0..B-1]) or an odd prime p (one stage at span L, its twiddle rows from
// tw[0], its roots from root). A butterfly b of the block's frames: frame
// b div nb, j = b mod nb; radix 2 (and with KFAST, mix_base's, every pass
// of the conv kernels, whose plans divide by L): k = j mod L fastest,
// group j div L; odd: group j mod G fastest (G = M / (L p)), k = j div G
// (inner divides by L or G). lp divides by L p.
struct MixPass {
  int radix;
  int span;
  int tw[4];
  int root;
  FastDiv nb;
  FastDiv inner;
  FastDiv lp;
};

struct MixRegPlan {
  int n_passes;
  int split;                        // first row of the split step's W_K^g
  int frames;                       // frames a block
  int pf;                           // threads a frame (load and epilogue)
  MixPass pass[MIX_MAX_PASSES];
};

// The first slot of butterfly b of pass ps (its values at + q L) and its
// k. KFAST (every pass of the conv kernels): k fastest in the odd and
// generic passes too. The mixed kernel keeps the group fastest there: on
// the card KFAST made it slower at 8160 (path 4 3.643 ms against 3.606,
// path 6 3.731 against 3.706) and faster at 8032 (path 5 7.979 against
// 8.072), the small plans within 0.6% (tools/torch_kernel_variants.py
// mixed, kfast; NVIDIA H100 80GB HBM3, 700 W).
template <bool KFAST = false>
__device__ __forceinline__ int mix_base(const MixPass& ps, int M, int b,
                                        int& k) {
  const int f = static_cast<int>(ps.nb.div(b));
  const int j = b - f * static_cast<int>(ps.nb.d);
  const int L = ps.span;
  int g;
  if (KFAST || ps.radix % 2 == 0) {
    g = static_cast<int>(ps.inner.div(j));
    k = j - g * L;
  } else {
    k = static_cast<int>(ps.inner.div(j));
    g = j - k * static_cast<int>(ps.inner.d);
  }
  return f * M + g * L * ps.radix + k;
}

// The radix-2 butterfly in frequency, the transpose of r2_butterfly: (a, b)
// <- (a + b, w (a - b))
__device__ __forceinline__ void r2_dif_butterfly(double2& a, double2& b,
                                                 double2 w) {
  const double2 a0 = a;
  a = make_double2(a0.x + b.x, a0.y + b.y);
  b = cmul(w, make_double2(a0.x - b.x, a0.y - b.y));
}

// Radix-2 stage S of a pass of R values in registers: values i and i + 2^S
// (bit S of i clear) at span L 2^S, with the row row + k + L (i mod 2^S);
// with DIF its transpose, on the same values with the same row
template <int R, int S, bool DIF = false>
__device__ __forceinline__ void mix_r2_stage(double2 (&v)[R],
                                             const double2* __restrict__ tw,
                                             int row, int k, int L) {
#pragma unroll
  for (int t = 0; t < (1 << S); ++t) {
    const double2 w = tw[row + k + L * t];
#pragma unroll
    for (int hi = 0; hi < (R >> (S + 1)); ++hi) {
      const int i = t | (hi << (S + 1));
      if constexpr (DIF)
        r2_dif_butterfly(v[i], v[i | (1 << S)], w);
      else
        r2_butterfly(v[i], v[i | (1 << S)], w);
    }
  }
}

// A radix-2^B pass's stages on its values in registers: in time stage S at
// span L 2^S, its rows from ps.tw[S], S ascending; in frequency (DIF) the
// same stages transposed, S descending
template <int B, bool DIF>
__device__ __forceinline__ void mix_r2_stages(double2 (&v)[1 << B],
                                              const double2* __restrict__ tw,
                                              const MixPass& ps, int k,
                                              int L) {
  constexpr int R = 1 << B;
  if constexpr (DIF) {
    if constexpr (B > 3) mix_r2_stage<R, 3, true>(v, tw, ps.tw[3], k, L);
    if constexpr (B > 2) mix_r2_stage<R, 2, true>(v, tw, ps.tw[2], k, L);
    if constexpr (B > 1) mix_r2_stage<R, 1, true>(v, tw, ps.tw[1], k, L);
    mix_r2_stage<R, 0, true>(v, tw, ps.tw[0], k, L);
  } else {
    mix_r2_stage<R, 0>(v, tw, ps.tw[0], k, L);
    if constexpr (B > 1) mix_r2_stage<R, 1>(v, tw, ps.tw[1], k, L);
    if constexpr (B > 2) mix_r2_stage<R, 2>(v, tw, ps.tw[2], k, L);
    if constexpr (B > 3) mix_r2_stage<R, 3>(v, tw, ps.tw[3], k, L);
  }
}

// Slot s's place in a buffer: s with its low three bits XORed with bits
// shift to shift + 2 under mask 7 (the conv kernels' power-of-two
// transforms; a bijection on each eight aligned slots), or s itself under
// mask 0 (every other transform, the mixed kernel's)
struct SlotMap {
  int mask, shift;
  __device__ __forceinline__ int operator()(int s) const {
    return s ^ ((s >> shift) & mask);
  }
};

// B radix-2 stages in registers (stage S at span L 2^S, its rows from
// ps.tw[S]), in time or (DIF) in frequency, at the slots map gives
template <int B, bool DIF = false>
__device__ __forceinline__ void mix_r2_pass(double2* buf,
                                            const double2* __restrict__ tw,
                                            const MixPass& ps, int M,
                                            int nbt,
                                            SlotMap map = SlotMap{0, 0}) {
  constexpr int R = 1 << B;
  const int L = ps.span;
  for (int b = threadIdx.x; b < nbt; b += blockDim.x) {
    int k;
    const int base = mix_base(ps, M, b, k);
    double2 v[R];
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = buf[map(base + q * L)];
    mix_r2_stages<B, DIF>(v, tw, ps, k, L);
#pragma unroll
    for (int q = 0; q < R; ++q) buf[map(base + q * L)] = v[q];
  }
}

// radix P = 3, 5 or 7: a butterfly a thread in registers, the symmetric
// form's arithmetic (odd_dft's), the roots from shared memory (staged by the kernel); in time
// the twiddles on the inputs, in frequency (DIF) on the outputs; KFAST,
// k fastest across the lanes (mix_base)
template <int P, bool DIF = false, bool KFAST = false>
__device__ __forceinline__ void mix_odd_pass(double2* buf,
                                             const double2* roots,
                                             const double2* __restrict__ tw,
                                             const MixPass& ps, int M,
                                             int nbt) {
  constexpr int H = (P - 1) / 2;
  const int L = ps.span;
  for (int b = threadIdx.x; b < nbt; b += blockDim.x) {
    int k;
    const int base = mix_base<KFAST>(ps, M, b, k);
    double2 y[P];
#pragma unroll
    for (int q = 0; q < P; ++q) y[q] = buf[base + q * L];
    if (!DIF && L > 1) {
#pragma unroll
      for (int q = 1; q < P; ++q)
        y[q] = cmul(tw[ps.tw[0] + (q - 1) * L + k], y[q]);
    }
#pragma unroll
    for (int m = 0; m <= H; ++m) {
      double ar = y[0].x, ai = y[0].y, br = 0.0, bi = 0.0;
#pragma unroll
      for (int q = 1; q <= H; ++q) {
        const double2 c = roots[(q * m) % P];
        ar += (y[q].x + y[P - q].x) * c.x;
        ai += (y[q].y + y[P - q].y) * c.x;
        br += (y[q].x - y[P - q].x) * c.y;
        bi += (y[q].y - y[P - q].y) * c.y;
      }
      if (DIF && L > 1 && m > 0) {
        buf[base + m * L] =
            cmul(tw[ps.tw[0] + (m - 1) * L + k],
                 make_double2(ar - bi, ai + br));
        buf[base + (P - m) * L] =
            cmul(tw[ps.tw[0] + (P - m - 1) * L + k],
                 make_double2(ar + bi, ai - br));
        continue;
      }
      buf[base + m * L] = make_double2(ar - bi, ai + br);
      if (m > 0) buf[base + (P - m) * L] = make_double2(ar + bi, ai - br);
    }
  }
}

// A generic lane's output pairs: RMAX for p at run time; for P at compile
// time the fewest that keep its groups of warps, ceil((h + 1)/RMAX) of
// them, as even as they go (P = 17, RMAX = 8: two groups of 5 for the 9
// pairs, not of 8)
template <int P, int RMAX>
__host__ __device__ constexpr int mix_rm() {
  return P == 0 ? RMAX
                : ((P + 1) / 2 + ((P + 1) / 2 + RMAX - 1) / RMAX - 1) /
                      (((P + 1) / 2 + RMAX - 1) / RMAX);
}

// A generic lane's sums: output pairs m0 + i (i < mix_rm<P, RMAX>()) of
// the butterfly at base, the symmetric form's sums with q ascending.
// With P at compile time (11-31) the roots sit in shared memory in the
// lane's order, group by group, q by q, i by i (mix_generic_pass stages
// them): a step reads the next mix_rm of them at fixed offsets. Else the
// root index steps as q m mod p, one shared index for m0 and steps of q
// for the lane's other outputs.
template <int P, int RMAX>
__device__ __forceinline__ void mix_generic_sums(
    const double2* buf, const double2* roots, int base, int L, int p, int m0,
    double (&ar)[RMAX], double (&ai)[RMAX], double (&br)[RMAX],
    double (&bi)[RMAX]) {
  constexpr int RM = mix_rm<P, RMAX>();
  const double2 y0 = buf[base];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    ar[i] = y0.x;
    ai[i] = y0.y;
    br[i] = 0.0;
    bi[i] = 0.0;
  }
  if constexpr (P > 0) {
    constexpr int H = (P - 1) / 2;
    const double2* rq = roots + (m0 / RM) * H * RM;   // this group's roots
#pragma unroll 1
    for (int q = 1; q <= H; ++q, rq += RM) {
      const double2 u = buf[base + q * L];
      const double2 v = buf[base + (P - q) * L];
      const double sr = u.x + v.x, si = u.y + v.y;
      const double dr = u.x - v.x, di = u.y - v.y;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const double2 c = rq[i];                 // W_P^(q (m0 + i) mod P)
        ar[i] += sr * c.x;
        ai[i] += si * c.x;
        br[i] += dr * c.y;
        bi[i] += di * c.y;
      }
    }
  } else {
    const int h = (p - 1) >> 1;
    int idx = 0;                             // q m0 mod p
#pragma unroll 1
    for (int q = 1; q <= h; ++q) {
      const double2 u = buf[base + q * L];
      const double2 v = buf[base + (p - q) * L];
      const double sr = u.x + v.x, si = u.y + v.y;
      const double dr = u.x - v.x, di = u.y - v.y;
      idx += m0;
      if (idx >= p) idx -= p;
      int t = idx;                           // q (m0 + i) mod p
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        if (i > 0) {
          t += q;
          if (t >= p) t -= p;
        }
        const double2 c = roots[t];
        ar[i] += sr * c.x;
        ai[i] += si * c.x;
        br[i] += dr * c.y;
        bi[i] += di * c.y;
      }
    }
  }
}

// Any odd prime p >= 11 (P: p at compile time, 11-31; 0: p from the plan):
// the warps of the block split into groups of ceil((h + 1) / RM) (h = (p -
// 1)/2, RM = mix_rm<P, RMAX>()), warp w of a group computing output pairs
// (m, p - m), m = RM (w mod groups) ..., for 32 consecutive butterflies,
// one a lane. Each lane reads every input pair (y_q, y_(p-q)) of its
// butterfly once, forms their sum and difference once and feeds its RM
// outputs from them (the symmetric form's sums, q ascending); the warp's
// lanes read the same root at each step (a broadcast). Rounds of whole
// butterflies: a round reads, holds its outputs in registers across a
// barrier and writes them. In time, at L > 1 a twiddle pass over every
// slot runs first, with the roots' load (groups h RM roots at most for the
// compile-time primes, 240 at 31); in frequency (DIF) each lane twiddles
// its outputs as it writes them. NARROW (the conv kernels' plans with a
// small generic pass or block, conv_plan) runs the pass a thread an output
// pair (m, p - m) instead, the roots staged in order, with no lane sums
// compiled in: a lane's 4 or 8 outputs would leave most of a small block
// idle on long chains (nperseg 263, P = 2 131: 33 ms against 5.6 at 8191
// on the card). A round takes per = blockDim / (h + 1) butterflies. Where
// per is a power of two the round's butterflies run fastest across the
// lanes (m = t div nr, nr the round's butterflies), so an 8-lane phase
// gathers 8 / per roots at q m mod p, not 8; else the output pairs (m = t
// mod (h + 1), butterfly t div (h + 1)). On the card the first took 1006
// (per 2) 14.1 ms against 20.5, and the 100 sampled plans of 2, 4, 8 and
// 16 a round 0.70-0.88x at the median; at 3, 5 and 9 a round the second
// was faster, by up to 1.3x (tools/torch_kernel_variants.py rader).
// KFAST: k fastest (mix_base).
template <int P, int RMAX, bool DIF = false, bool NARROW = false,
          bool KFAST = false>
__device__ __forceinline__ void mix_generic_pass(
    double2* buf, double2* roots, const double2* __restrict__ tw,
    const MixPass& ps, int M, int frames, int nbt) {
  constexpr int RM = mix_rm<P, RMAX>();
  const int p = P > 0 ? P : ps.radix;
  const int h = (p - 1) >> 1;
  const int L = ps.span;
  const int tid = threadIdx.x;
  if constexpr (P > 0) {
    // group g's roots for step q and pair i at ((g H) + q - 1) RM + i
    constexpr int H = (P - 1) / 2;
    for (int e = tid; e < ((H + RM) / RM) * H * RM; e += blockDim.x) {
      const int i = e % RM;
      const int q = (e / RM) % H + 1;
      const int g = e / (RM * H);
      roots[e] = tw[ps.root + (q * (g * RM + i)) % P];
    }
  } else {
    for (int i = tid; i < p; i += blockDim.x) roots[i] = tw[ps.root + i];
  }
  if (!DIF && L > 1) {
    for (int s = tid; s < frames * M; s += blockDim.x) {
      const int r = s - static_cast<int>(ps.lp.div(s) * ps.lp.d);   // q L + k
      if (r >= L) buf[s] = cmul(tw[ps.tw[0] + r - L], buf[s]);
    }
  }
  __syncthreads();
  if constexpr (NARROW) {
    static_assert(P == 0, "a narrow pass reads its roots in order");
    const int per = static_cast<int>(blockDim.x) / (h + 1);
    const bool jfast = per > 1 && (per & (per - 1)) == 0;
    int m = jfast ? tid / per : tid % (h + 1);
    int j = jfast ? tid - m * per : tid / (h + 1);
    for (int b0 = 0; b0 < nbt; b0 += per) {
      if (jfast && nbt - b0 < per) {       // a short last round, packed
        m = tid / (nbt - b0);
        j = tid - m * (nbt - b0);
      }
      const int b = b0 + j;
      const bool on = m <= h && j < per && b < nbt;
      double ar = 0.0, ai = 0.0, br = 0.0, bi = 0.0;
      int base = 0;
      int k = 0;
      if (on) {
        base = mix_base<KFAST>(ps, M, b, k);
        const double2 y0 = buf[base];
        ar = y0.x;
        ai = y0.y;
        int idx = 0;                         // q m mod p
        for (int q = 1; q <= h; ++q) {
          idx += m;
          if (idx >= p) idx -= p;
          const double2 c = roots[idx];
          const double2 u = buf[base + q * L];
          const double2 v = buf[base + (p - q) * L];
          ar += (u.x + v.x) * c.x;
          ai += (u.y + v.y) * c.x;
          br += (u.x - v.x) * c.y;
          bi += (u.y - v.y) * c.y;
        }
      }
      __syncthreads();
      if (on) {
        double2 lo = make_double2(ar - bi, ai + br);
        double2 hi = make_double2(ar + bi, ai - br);
        if (DIF && L > 1 && m > 0) {
          lo = cmul(tw[ps.tw[0] + (m - 1) * L + k], lo);
          hi = cmul(tw[ps.tw[0] + (p - m - 1) * L + k], hi);
        }
        buf[base + m * L] = lo;
        if (m > 0) buf[base + (p - m) * L] = hi;
      }
    }
    return;
  } else {
  const int groups = (h + RM) / RM;
  const int warp = tid >> 5;
  const int per_round = static_cast<int>(blockDim.x >> 5) / groups;
  const int m0 = (warp % groups) * RM;
  const int chunk = warp / groups;
  const int chunks = (nbt + 31) >> 5;
  for (int c0 = 0; c0 < chunks; c0 += per_round) {
    const int b = (c0 + chunk) * 32 + (tid & 31);
    const bool on = chunk < per_round && b < nbt;
    double ar[RMAX], ai[RMAX], br[RMAX], bi[RMAX];
    int base = 0;
    int k = 0;
    if (on) {
      base = mix_base<KFAST>(ps, M, b, k);
      mix_generic_sums<P, RMAX>(buf, roots, base, L, p, m0, ar, ai, br, bi);
    }
    __syncthreads();
    if (on) {
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int m = m0 + i;
        if (m <= h) {
          double2 lo = make_double2(ar[i] - bi[i], ai[i] + br[i]);
          double2 hi = make_double2(ar[i] + bi[i], ai[i] - br[i]);
          if (DIF && L > 1 && m > 0) {
            lo = cmul(tw[ps.tw[0] + (m - 1) * L + k], lo);
            hi = cmul(tw[ps.tw[0] + (p - m - 1) * L + k], hi);
          }
          buf[base + m * L] = lo;
          if (m > 0) buf[base + (p - m) * L] = hi;
        }
      }
    }
  }
  }
}

// the sums of s over each frame's pf threads (a power of two), in every
// thread: by shuffles within a warp, past a warp through scratch (one
// double2 a warp), the frame's warps added in order
__device__ __forceinline__ double2 mix_frame_sum(double2 s, int pf,
                                                 double2* scratch) {
  const int lanes = pf < 32 ? pf : 32;
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    s.x += __shfl_xor_sync(0xffffffffu, s.x, off);
    s.y += __shfl_xor_sync(0xffffffffu, s.y, off);
  }
  if (pf <= 32) return s;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) scratch[warp] = s;
  __syncthreads();
  const int w0 = warp - warp % (pf >> 5);
  double2 t = scratch[w0];
  for (int w = w0 + 1; w < w0 + (pf >> 5); ++w) {
    t.x += scratch[w].x;
    t.y += scratch[w].y;
  }
  return t;
}

constexpr int SMALL_ROOTS = 16;   // the roots of radix 3, 5 and 7

// where radix p's roots sit among the staged small roots
__host__ __device__ constexpr int small_root_at(int p) {
  return p == 3 ? 0 : (p == 5 ? 3 : 8);
}

struct ConvPlan {
  int n_passes;
  int fuse;                     // 1: pass 0 turns around in registers
  int swz_mask;                 // SlotMap: 7 for a power-of-two N, else 0
  int swz_shift;                // log2 of pass 0's radix
  int rader;                    // first row of the Rader stage's b^, or -1
  int split;                    // first row of the split step's W_K^g, or -1
  int root[3];                  // the root rows of radix 3, 5, 7, or -1
  MixPass pass[MIX_MAX_PASSES];
};

// stage the plan's radix 3, 5 and 7 roots (small_root_at), once for every
// pass in both directions; the kernel's first barrier orders them
__device__ __forceinline__ void conv_stage_roots(
    double2* small, const double2* __restrict__ tw, const ConvPlan& plan) {
  const int t = threadIdx.x;
  const int r = t < 3 ? 0 : (t < 8 ? 1 : 2);
  if (t < 15 && plan.root[r] >= 0)
    small[t] = tw[plan.root[r] + t - small_root_at(2 * r + 3)];
}

// One pass over the block's N slots, in time or (DIF) in frequency
template <int RMAX, bool DIF>
__device__ __forceinline__ void conv_pass(double2* buf, double2* roots,
                                          const double2* small,
                                          const double2* __restrict__ tw,
                                          const MixPass& ps, int N,
                                          SlotMap map) {
  const int nb = static_cast<int>(ps.nb.d);
  switch (ps.radix) {
    case 2: mix_r2_pass<1, DIF>(buf, tw, ps, N, nb, map); break;
    case 4: mix_r2_pass<2, DIF>(buf, tw, ps, N, nb, map); break;
    case 8: mix_r2_pass<3, DIF>(buf, tw, ps, N, nb, map); break;
    case 16: mix_r2_pass<4, DIF>(buf, tw, ps, N, nb, map); break;
    case 3:
      mix_odd_pass<3, DIF, true>(buf, small + small_root_at(3), tw, ps, N,
                                 nb);
      break;
    case 5:
      mix_odd_pass<5, DIF, true>(buf, small + small_root_at(5), tw, ps, N,
                                 nb);
      break;
    case 7:
      mix_odd_pass<7, DIF, true>(buf, small + small_root_at(7), tw, ps, N,
                                 nb);
      break;
    default:
      if constexpr (RMAX == 1) {
        mix_generic_pass<0, 1, DIF, true, true>(buf, roots, tw, ps, N, 1,
                                                nb);
      } else if constexpr (RMAX > 0) {
        switch (ps.radix) {
          case 11:
            mix_generic_pass<11, RMAX, DIF, false, true>(buf, roots, tw, ps,
                                                       N, 1, nb);
            break;
          case 13:
            mix_generic_pass<13, RMAX, DIF, false, true>(buf, roots, tw, ps,
                                                       N, 1, nb);
            break;
          case 17:
            mix_generic_pass<17, RMAX, DIF, false, true>(buf, roots, tw, ps,
                                                       N, 1, nb);
            break;
          case 19:
            mix_generic_pass<19, RMAX, DIF, false, true>(buf, roots, tw, ps,
                                                       N, 1, nb);
            break;
          case 23:
            mix_generic_pass<23, RMAX, DIF, false, true>(buf, roots, tw, ps,
                                                       N, 1, nb);
            break;
          case 29:
            mix_generic_pass<29, RMAX, DIF, false, true>(buf, roots, tw, ps,
                                                       N, 1, nb);
            break;
          case 31:
            mix_generic_pass<31, RMAX, DIF, false, true>(buf, roots, tw, ps,
                                                       N, 1, nb);
            break;
          default:
            mix_generic_pass<0, RMAX, DIF, false, true>(buf, roots, tw, ps,
                                                       N, 1, nb);
        }
      }
  }
}

// Bluestein's product: slot s <- conj(b^_s slot s)
struct BluesteinProduct {
  const double2* bhat;
  __device__ __forceinline__ double2 operator()(int s, double2 y) const {
    const double2 p = cmul(bhat[s], y);
    return make_double2(p.x, -p.y);
  }
};

// Rader's: X[0] = x[0] + slot 0 into *sum (x[0] at *x0), slot s <- b^_s
// slot s
struct RaderProduct {
  const double2* bhat;
  const double2* x0;
  double2* sum;
  __device__ __forceinline__ double2 operator()(int s, double2 y) const {
    if (s == 0) *sum = make_double2(x0->x + y.x, x0->y + y.y);
    return cmul(bhat[s], y);
  }
};

// The P-point DFT z of y by the symmetric form's sums (q ascending, the
// root of (q m) mod P)
template <int P>
__device__ __forceinline__ void odd_dft(const double2 (&y)[P],
                                        const double2* roots,
                                        double2 (&z)[P]) {
  constexpr int H = (P - 1) / 2;
#pragma unroll
  for (int m = 0; m <= H; ++m) {
    double ar = y[0].x, ai = y[0].y, br = 0.0, bi = 0.0;
#pragma unroll
    for (int q = 1; q <= H; ++q) {
      const double2 c = roots[(q * m) % P];
      ar += (y[q].x + y[P - q].x) * c.x;
      ai += (y[q].y + y[P - q].y) * c.x;
      br += (y[q].x - y[P - q].x) * c.y;
      bi += (y[q].y - y[P - q].y) * c.y;
    }
    z[m] = make_double2(ar - bi, ai + br);
    if (m > 0) z[P - m] = make_double2(ar + bi, ai - br);
  }
}

// The turn-around of a radix-2^B pass 0: butterfly b's 2^B contiguous
// slots b 2^B + q (span 1) in frequency, each slot's product, in time, in
// registers
template <int B, typename Product>
__device__ __forceinline__ void conv_turn_r2(double2* buf,
                                             const double2* __restrict__ tw,
                                             const MixPass& ps, int N,
                                             SlotMap map, Product product) {
  constexpr int R = 1 << B;
  for (int b = threadIdx.x; b < N / R; b += blockDim.x) {
    double2 v[R];
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = buf[map(b * R + q)];
    mix_r2_stages<B, true>(v, tw, ps, 0, 1);
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = product(b * R + q, v[q]);
    mix_r2_stages<B, false>(v, tw, ps, 0, 1);
#pragma unroll
    for (int q = 0; q < R; ++q) buf[map(b * R + q)] = v[q];
  }
}

// The same for a pass 0 of radix P = 3, 5 or 7 (no twiddles at span 1)
template <int P, typename Product>
__device__ __forceinline__ void conv_turn_odd(double2* buf,
                                              const double2* roots, int N,
                                              Product product) {
  for (int b = threadIdx.x; b < N / P; b += blockDim.x) {
    double2 y[P], z[P];
#pragma unroll
    for (int q = 0; q < P; ++q) y[q] = buf[b * P + q];
    odd_dft<P>(y, roots, z);
#pragma unroll
    for (int q = 0; q < P; ++q) z[q] = product(b * P + q, z[q]);
    odd_dft<P>(z, roots, y);
#pragma unroll
    for (int q = 0; q < P; ++q) buf[b * P + q] = y[q];
  }
}

// The plan's passes in time over the block's N slots from pass `first` on,
// each ending at a barrier (digit-reversed in, natural order out)
template <int RMAX>
__device__ __forceinline__ void conv_forward(double2* buf, double2* roots,
                                             const double2* small,
                                             const double2* __restrict__ tw,
                                             const ConvPlan& plan, int N,
                                             int first) {
  const SlotMap map{plan.swz_mask, plan.swz_shift};
  for (int q = first; q < plan.n_passes; ++q) {
    conv_pass<RMAX, false>(buf, roots, small, tw, plan.pass[q], N, map);
    __syncthreads();
  }
}

// The cyclic convolution step of a Rader or Bluestein transform over the
// block's N slots, in place, after the barrier that orders the loads: the
// passes in frequency (reverse order; natural order in, digit-reversed
// out), each slot's product in slot order, the passes in time; pass 0
// turns around in registers where the plan fuses it. Ends at a barrier.
template <int RMAX, typename Product>
__device__ __forceinline__ void conv_transform(double2* buf, double2* roots,
                                               const double2* small,
                                               const double2* __restrict__ tw,
                                               const ConvPlan& plan, int N,
                                               Product product) {
  const SlotMap map{plan.swz_mask, plan.swz_shift};
  for (int q = plan.n_passes - 1; q >= plan.fuse; --q) {
    conv_pass<RMAX, true>(buf, roots, small, tw, plan.pass[q], N, map);
    __syncthreads();
  }
  if (plan.fuse) {
    const MixPass& ps = plan.pass[0];
    switch (ps.radix) {
      case 2: conv_turn_r2<1>(buf, tw, ps, N, map, product); break;
      case 4: conv_turn_r2<2>(buf, tw, ps, N, map, product); break;
      case 8: conv_turn_r2<3>(buf, tw, ps, N, map, product); break;
      case 16: conv_turn_r2<4>(buf, tw, ps, N, map, product); break;
      case 3:
        conv_turn_odd<3>(buf, small + small_root_at(3), N, product);
        break;
      case 5:
        conv_turn_odd<5>(buf, small + small_root_at(5), N, product);
        break;
      case 7:
        conv_turn_odd<7>(buf, small + small_root_at(7), N, product);
        break;
    }
  } else {
    for (int s = threadIdx.x; s < N; s += blockDim.x)
      buf[map(s)] = product(s, buf[map(s)]);
  }
  __syncthreads();
  conv_forward<RMAX>(buf, roots, small, tw, plan, N, plan.fuse);
}

// Reads of transform output i from a conv kernel's buffer: plain, or
// after a Rader stage of P = N - 1 points X[0] = *sum and X[i] = x[0] +
// slot perm[i] (x[0] in slot P)
struct ConvRead {
  const double2* buf;
  SlotMap map;
  __device__ double2 operator()(int i) const { return buf[map(i)]; }
};
struct ConvRaderRead {
  const double2* buf;
  const int* __restrict__ perm;
  const double2* sum;
  int P;
  SlotMap map;
  __device__ double2 operator()(int i) const {
    if (i == 0) return *sum;
    const double2 x0 = buf[map(P)];
    const double2 v = buf[map(perm[i])];
    return make_double2(x0.x + v.x, x0.y + v.y);
  }
};

// blocks of 512 threads an SM holds: two (64 registers) for the plans
// with narrow generic passes, and without a Rader stage or PACKED for those
// of radix 3, 5 and 7 passes only (on the card 1029 took 4.3 ms against 6.3
// with one block, Rader 557 13.5 against 21.6, PACKED 1082 4.23 against
// 10.0); one (128) for the rest, whose lanes of output pairs or radix-2
// passes of up to 16 values spill at 64
constexpr int ODD_SMALL_BLOCKS = 2;
// the largest odd nperseg without a Rader stage, and with one, whose
// generic passes all run narrow at two blocks an SM; past them the wide
// passes at one block are the faster (on the card the crossovers lay
// between 5343 and 5457, and near 2048 for the Rader plans, which also run
// two transforms of K - 1 points)
constexpr int ODD_NARROW_POINTS = 5448;
constexpr int RADER_NARROW_POINTS = 2048;
// PACKED: radix-2 passes of 8 values at most (at 64 registers they spill
// less than 16: 514, P = 256, 2.93 ms against 6.34 on 1024 clips of 10 s),
// and every generic pass narrow at two blocks an SM (the launcher passes
// its width as narrow_points): wide lanes at one block ran 69 of the 405
// plans slower than running the stages one at a time, narrow passes 119
// of the 155 wide plans faster (tools/torch_kernel_variants.py rader, H100)
constexpr int PACKED_R2_BITS = 3;
constexpr double PAIR_MAX_RATIO = 65536.0;

constexpr int odd_min_blocks(bool rader, int rmax, bool packed) {
  return rmax == 1 || (rmax == 0 && (!rader || packed)) ? ODD_SMALL_BLOCKS
                                                        : 1;
}

// ---------------------------------------------------------------------------
// The Bluestein route's transform (stft_psd.cu's, text for text; the
// route's design notes are there, above stft_bluestein_psd_kernel).

namespace cg = cooperative_groups;

constexpr int BLUE_MAX_RADIX = 7;              // M's radices: 2, 3, 5, 7
constexpr int BLUE_MIN_BLOCKS = 1;             // blocks of 512 threads an SM
// the largest M / RANKS that runs two blocks an SM (64 registers): two
// buffers fit the SM's shared memory up to about 7150 points; on the card
// two blocks ran M = 1125-6250 up to 1.5x faster (nperseg 563: 9.4 ms
// against 14.2) and one block M = 8192 1.6x faster than two
constexpr int BLUE_TWO_BLOCK_POINTS = 7000;
// A block's shared memory on this card (227 KB, static and dynamic
// together), the kernel's static arrays (small, red_sum, red_lo, red_hi),
// and the most complex float64 values its dynamic buffer then holds: the
// largest 2, 3, 5, 7-smooth M whose buffer fits, 14406 (225 KB). A
// longer convolution runs on a cluster of two blocks.
constexpr int BLOCK_SMEM = 232448;
constexpr int BLUE_MAX_BLOCK_POINTS = 14406;
// the backward kernel's static arrays (small, red_sum, inv_flag)
constexpr int BLUE_BWD_STATIC_SMEM =
    SMALL_ROOTS * 16 + 4 * FFT_MAX_WARPS * 16 + 16;
static_assert(BLUE_MAX_BLOCK_POINTS * 16 + BLUE_BWD_STATIC_SMEM <= BLOCK_SMEM,
              "the backward's one-block buffer fits");

// X[i] = w_i conj(slot i), i < N: the Bluestein transform's output
struct BluesteinRead {
  const double2* buf;
  const double2* __restrict__ chirp;
  SlotMap map;
  __device__ double2 operator()(int i) const {
    const double2 o = buf[map(i)];
    return cmul(chirp[i], make_double2(o.x, -o.y));
  }
};

// The convolution of the values a_i the load put in slots 0..N-1 (zeros
// to M) with b, in place, starting with the barrier that orders the
// loads: slot k of rank 0 ends holding conj(y_k), k < N, after a barrier.
// RANKS = 1: buf holds the M slots and the plan every stage of M. RANKS =
// 2 (a cluster of two blocks): buf holds this block's M/2 slots, the plan
// every stage but the last (radix 2 at span M/2, twiddle rows from
// half_row), which the ranks take through each other's shared memory.
template <int RANKS>
__device__ __forceinline__ void bluestein_transform(
    double2* buf, const double2* small, const double2* __restrict__ tw,
    const ConvPlan& plan, int M, int N, int bhat, int half_row) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int H = M / RANKS;                      // this block's slots
  const SlotMap map{plan.swz_mask, plan.swz_shift};
  int rank = 0;
  if constexpr (RANKS == 2) {
    cg::cluster_group cluster = cg::this_cluster();
    rank = static_cast<int>(cluster.block_rank());
    cluster.sync();                             // rank 0's loads
    if (rank == 1) {
      const double2* half0 = cluster.map_shared_rank(buf, 0);
      for (int j = tid; j < H; j += nt)
        buf[map(j)] = cmul(tw[half_row + j], half0[map(j)]);
    }
    cluster.sync();                             // read before rank 0 writes
  } else {
    __syncthreads();
  }
  conv_transform<0>(buf, nullptr, small, tw, plan, H,
                    BluesteinProduct{tw + bhat + rank * H});
  if constexpr (RANKS == 2) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                             // rank 1's half transformed
    if (rank == 0) {
      const double2* half1 = cluster.map_shared_rank(buf, 1);
      for (int j = tid; j < N; j += nt) {
        const double2 t = cmul(tw[half_row + j], half1[map(j)]);
        const double2 a = buf[map(j)];
        buf[map(j)] = make_double2(a.x + t.x, a.y + t.y);
      }
    }
    cluster.sync();                             // rank 1 may go on or exit
  }
}

constexpr int FFT_MAX_DEVICES = 64;

// raise `kernel`'s dynamic shared memory limit to smem once per device
// (set[] records it); returns a cudaError_t. A block whose static and
// dynamic shared memory together pass 48 KB needs the limit raised, so it
// is raised at any size: a dynamic buffer just under 48 KB beside a
// kernel's static arrays (4.5 KB of roots and reductions in the mixed-radix
// kernels) is refused without it.
template <typename Kernel>
int raise_smem(Kernel kernel, size_t smem, size_t* set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= FFT_MAX_DEVICES || set[dev] < smem)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess && dev < FFT_MAX_DEVICES) set[dev] = smem;
  }
  return static_cast<int>(err);
}

// a detrend code the FFT kernels take
bool detrend_ok(int detrend) {
  return detrend == DETREND_NONE || detrend == DETREND_CONSTANT ||
         detrend == DETREND_LINEAR;
}

// K/4 threads, rounded up to a warp, 32 to FFT_MAX_THREADS
int fft_threads(int K) {
  const int t = (K / 4 + 31) / 32 * 32;
  return t < 32 ? 32 : (t > FFT_MAX_THREADS ? FFT_MAX_THREADS : t);
}

// The passes of an N-point plan from the host's (n_stages, 4) rows
// (core/stft.py::fft_plan: odd primes, then the twos) into pass[0..
// *n_passes), and its largest radix in *p_max; false for a plan the pass
// engine does not take. Each odd stage is a pass; the twos, a of them,
// ceil(a / bits_max) passes of as even a number each (bits_max MIX_R2_BITS,
// or PACKED_R2_BITS for the PACKED plans), the smaller first
// (a = 5: 4, 8; a = 13: 8, 8, 8, 16): the conv kernels' pass 0 turns
// around in registers, and 8 values do it faster than 16 on the card
// (scipy_default 8182 on 1024 clips of 10 s: 6.09 ms against 6.47 larger
// first), and the mixed kernel runs either order in the same time (path 4
// 3.593 against 3.606 ms; tools/torch_kernel_variants.py, NVIDIA H100
// 80GB HBM3, 700 W).
bool group_passes(const int* stages, int n_stages, int N, int bits_max,
                  MixPass* pass, int* n_passes, int* p_max) {
  if (n_stages < 1 || n_stages > MIX_MAX_STAGES) return false;
  int span = 1;
  int twos = 0;
  int np = 0;
  *p_max = 2;
  for (int s = 0; s < n_stages; ++s) {
    const int p = stages[4 * s];
    const bool odd = p % 2 == 1 && p >= 3 && p <= MIX_MAX_RADIX;
    if ((p != 2 && !odd) || (odd && twos > 0) || stages[4 * s + 1] != span ||
        span * p > N)
      return false;
    if (odd) {
      MixPass& ps = pass[np++];
      ps.radix = p;
      ps.span = span;
      ps.tw[0] = stages[4 * s + 2];
      ps.root = stages[4 * s + 3];
      if (p > *p_max) *p_max = p;
    } else {
      ++twos;
    }
    span *= p;
  }
  if (span != N) return false;
  const int n2 = (twos + bits_max - 1) / bits_max;
  int s = n_stages - twos;
  for (int pn = 0; pn < n2; ++pn) {
    const int i = n2 - 1 - pn;       // its rank among the passes, larger first
    const int bits = twos / n2 + (i < twos % n2 ? 1 : 0);
    MixPass& ps = pass[np++];
    ps.radix = 1 << bits;
    ps.span = stages[4 * s + 1];
    ps.root = -1;
    for (int j = 0; j < 4; ++j)
      ps.tw[j] = j < bits ? stages[4 * (s + j) + 2] : -1;
    s += bits;
  }
  for (int i = 0; i < np; ++i) {
    MixPass& ps = pass[i];
    const int lp = ps.span * ps.radix;
    ps.nb = make_fastdiv(N / ps.radix);
    ps.inner = make_fastdiv(ps.radix % 2 ? N / lp : ps.span);
    ps.lp = make_fastdiv(lp);
  }
  *n_passes = np;
  return true;
}

// The mixed-radix kernel's plan of an N-point transform without a Rader
// stage (group_passes) into *plan, and its generic output pairs
// (mix_rmax) in *rmax; false for a plan the kernel does not take. A frame
// takes pf threads, the least power of two that loads it in MIX_LOAD pairs
// each, and a block of MIX_THREADS threads MIX_THREADS / pf frames.
bool mixed_register_plan(const int* stages, int n_stages, int split, int N,
                         MixRegPlan* plan, int* rmax) {
  int p_max = 2;
  if (split < 0 || N > 4096 ||
      !group_passes(stages, n_stages, N, MIX_R2_BITS, plan->pass,
                    &plan->n_passes,
                    &p_max))
    return false;
  *rmax = mix_rmax(p_max);
  int pf = 1;
  while (pf * MIX_LOAD < N) pf *= 2;
  plan->split = split;
  plan->pf = pf;
  plan->frames = MIX_THREADS / pf;
  return true;
}

// The conv kernels' plan of the N-point transform a block holds
// (group_passes, the twos smaller first) into *plan, with rader and split
// its first rows of b^ and of the split step (-1 without), and turn
// whether a Rader or Bluestein convolution runs the passes both ways; the
// generic output pairs a lane (mix_rmax) in *rmax, or 1 where the generic
// passes run narrow (mix_generic_pass): where a pass has at most 16
// butterflies, whose lanes' sums leave most of the block idle on long
// chains (on the card the wide passes ran up to 2.6x slower there, and up
// to 2x faster from 17: P = 796, 199 4 butterflies, against P = 6690, 223
// 30), or more groups of output pairs than the block has warps; and in
// every plan of at most narrow_points wide (ODD_NARROW_POINTS,
// RADER_NARROW_POINTS with a Rader stage, every PACKED plan), which then
// runs two blocks an SM; and in *threads
// the block: `width` / 2 threads rounded up to a warp, 32 to FFT_MAX_THREADS (width the transform length),
// widened to whole warps for the largest radix's (p + 1)/2 output pairs,
// a thread each in a narrow pass; that holds a wide pass's groups of warps
// wherever it has 32 butterflies (N >= 32 p). The turn-around is fused
// when pass 0 is not generic; a power-of-two N (radix-2 passes only) takes
// the XOR swizzle at pass 0's radix. Every pass takes k fastest across the
// lanes (the mixed kernel's odd passes the group): on the card the odd and
// generic passes ran 2-9% faster so at the Bluestein lengths of many odd
// radices (M = 11907 = 7^2 3^5: 8.27 ms against 7.54 at nperseg 5901) and
// at 2049 and 8191.
bool conv_plan(const int* stages, int n_stages, int N, int rader, int split,
               bool turn, int width, int narrow_points, int bits_max,
               ConvPlan* plan, int* rmax, int* threads) {
  int p_max = 2;
  if (!group_passes(stages, n_stages, N, bits_max, plan->pass,
                    &plan->n_passes, &p_max))
    return false;
  *rmax = mix_rmax(p_max);
  plan->rader = rader;
  plan->split = split;
  const int r0 = plan->pass[0].radix;
  plan->fuse = turn && (r0 % 2 == 0 || r0 <= 7) ? 1 : 0;
  int b0 = 0;
  while ((1 << b0) < r0) ++b0;
  const bool pow2 = (N & (N - 1)) == 0;
  plan->swz_mask = pow2 ? 7 : 0;
  plan->swz_shift = pow2 ? b0 : 0;
  const int pairs = ((p_max + 1) / 2 + 31) / 32 * 32;
  *threads = fft_threads(2 * width) > pairs ? fft_threads(2 * width) : pairs;
  bool narrow = width <= narrow_points;
  for (int r = 0; r < 3; ++r) plan->root[r] = -1;
  for (int i = 0; i < plan->n_passes; ++i) {
    MixPass& ps = plan->pass[i];
    ps.inner = make_fastdiv(ps.span);           // k fastest (KFAST)
    if (ps.radix % 2 && ps.radix <= 7) {
      int& row = plan->root[(ps.radix - 3) / 2];
      if (row < 0) row = ps.root;
    } else if (ps.radix % 2) {
      // mix_rm's lane width and the pass's groups of output pairs
      const int pairs = (ps.radix + 1) / 2;
      int rm = *rmax;
      if (ps.radix <= 31) {
        const int g = (pairs + rm - 1) / rm;
        rm = (pairs + g - 1) / g;
      }
      if (N / ps.radix <= 16 || (pairs + rm - 1) / rm > *threads / 32)
        narrow = true;
    }
  }
  if (*rmax > 0 && narrow) *rmax = 1;
  return true;
}

// The band [f_lo, f_lo + F) of a K-point transform's bins, or false when
// it is empty or lies past them
bool band_ok(int f_lo, int F, int K) {
  return f_lo >= 0 && F >= 1 && f_lo + F <= K;
}

constexpr double F32_MAX = 3.4028234663852886e38;

// The cotangent of bin f of output row i, from X = (xr, xi) in float64,
// every step rounded to nearest (no FMA contraction), as the plain
// version's elementwise float64 arithmetic.
__device__ __forceinline__ double2 cotangent_of(double xr, double xi,
                                               const float* g,
                                               const double* w, long long i,
                                               int f, int mode) {
  if (mode == OUT_COMPLEX) {
    const float2 gc = reinterpret_cast<const float2*>(g)[i];
    return make_double2(__dmul_rn(w[f], gc.x), __dmul_rn(w[f], gc.y));
  }
  const double s = __dadd_rn(__dmul_rn(xr, xr), __dmul_rn(xi, xi));
  if (!(s <= F32_MAX)) return make_double2(0.0, 0.0);
  double c;
  if (mode == OUT_MAGNITUDE) {
    if (s == 0.0) return make_double2(0.0, 0.0);
    c = __ddiv_rn(__dmul_rn(w[f], static_cast<double>(g[i])), __dsqrt_rn(s));
  } else {
    c = __dmul_rn(__dmul_rn(2.0, w[f]), static_cast<double>(g[i]));
  }
  return make_double2(__dmul_rn(c, xr), __dmul_rn(c, xi));
}

// X[f] of the split step from a = Z[f mod M] and b = Z[(M - f) mod M] with
// the twiddle w = W_K^f (-1 at f = M), r2_epilogue's expressions
__device__ __forceinline__ double2 split_bin(double2 a, double2 b,
                                             double2 w) {
  const double er = 0.5 * (a.x + b.x);
  const double ei = 0.5 * (a.y - b.y);
  const double o_r = 0.5 * (a.y + b.y);
  const double o_i = 0.5 * (b.x - a.x);
  return make_double2(er + (w.x * o_r - w.y * o_i),
                      ei + (w.x * o_i + w.y * o_r));
}

// conj Z'[k] of the inverse split step from S[k] = s and S[M - k] = t
// and W_K^k = w: (s + conj t) + i (s - conj t) conj w, conjugated for the
// inverse transform's forward passes
__device__ __forceinline__ double2 inverse_split(double2 s, double2 t,
                                                 double2 w) {
  const double er = s.x + t.x;
  const double ei = s.y - t.y;
  const double dr = s.x - t.x;
  const double di = s.y + t.y;
  const double o_r = dr * w.x + di * w.y;
  const double o_i = di * w.x - dr * w.y;
  return make_double2(er - o_i, -(ei + o_r));
}

// S[f] from H1[f]: the interior bins at half weight, the real parts of
// bins 0 and M (the imaginary parts do not reach a real frame)
__device__ __forceinline__ double2 half_weight(double2 h, int f, int M) {
  return f == 0 || f == M ? make_double2(h.x, 0.0)
                          : make_double2(0.5 * h.x, 0.5 * h.y);
}

// ---------------------------------------------------------------------------
// The backward kernels.

// The one-sided cotangent H1[f] of row r at bin f <= K/2 of a K-point
// transform from X[f]: H at bin f where the band holds it, plus, two-sided,
// conj H[K - f] (X[K - f] = conj X[f]) for 0 < f < K/2; rows past the last
// (valid false) give 0. stft_grad.cu's folded_cotangent for any K, odd
// included
__device__ __forceinline__ double2 one_sided_cotangent(
    double2 X, const float* __restrict__ g, const double* __restrict__ w,
    long long r, Band band, int f, int K, int two_sided, int mode,
    bool valid) {
  double2 h = make_double2(0.0, 0.0);
  if (!valid) return h;
  const long long row = r * band.n - band.lo;
  if (band.has(f)) h = cotangent_of(X.x, X.y, g, w, row + f, f, mode);
  const int m = K - f;
  if (two_sided && f > 0 && 2 * f < K && band.has(m)) {
    const double2 c = cotangent_of(X.x, -X.y, g, w, row + m, m, mode);
    h.x += c.x;
    h.y -= c.y;
  }
  return h;
}

// The mixed kernel's passes over the block's frames, each ending at a
// barrier: in time (the forward kernel's, digit-reversed in, natural order
// out) or, DIF, in frequency (the same passes transposed, in reverse order:
// natural order in, DFT index j at slot perm[j] out)
template <int RMAX, bool DIF>
__device__ __forceinline__ void mixed_passes(double2* buf, double2* roots,
                                             double2 (*odd_roots)[8],
                                             const double2* __restrict__ tw,
                                             const MixRegPlan& plan, int M) {
  for (int i = 0; i < plan.n_passes; ++i) {
    const int q = DIF ? plan.n_passes - 1 - i : i;
    const MixPass& ps = plan.pass[q];
    const int nbt = plan.frames * static_cast<int>(ps.nb.d);
    switch (ps.radix) {
      case 2: mix_r2_pass<1, DIF>(buf, tw, ps, M, nbt); break;
      case 4: mix_r2_pass<2, DIF>(buf, tw, ps, M, nbt); break;
      case 8: mix_r2_pass<3, DIF>(buf, tw, ps, M, nbt); break;
      case 16: mix_r2_pass<4, DIF>(buf, tw, ps, M, nbt); break;
      case 3: mix_odd_pass<3, DIF>(buf, odd_roots[q], tw, ps, M, nbt); break;
      case 5: mix_odd_pass<5, DIF>(buf, odd_roots[q], tw, ps, M, nbt); break;
      case 7: mix_odd_pass<7, DIF>(buf, odd_roots[q], tw, ps, M, nbt); break;
      default:
        if constexpr (RMAX > 0) {
          const int fr = plan.frames;
          switch (ps.radix) {
            case 11:
              mix_generic_pass<11, RMAX, DIF>(buf, roots, tw, ps, M, fr, nbt);
              break;
            case 13:
              mix_generic_pass<13, RMAX, DIF>(buf, roots, tw, ps, M, fr, nbt);
              break;
            case 17:
              mix_generic_pass<17, RMAX, DIF>(buf, roots, tw, ps, M, fr, nbt);
              break;
            case 19:
              mix_generic_pass<19, RMAX, DIF>(buf, roots, tw, ps, M, fr, nbt);
              break;
            case 23:
              mix_generic_pass<23, RMAX, DIF>(buf, roots, tw, ps, M, fr, nbt);
              break;
            case 29:
              mix_generic_pass<29, RMAX, DIF>(buf, roots, tw, ps, M, fr, nbt);
              break;
            case 31:
              mix_generic_pass<31, RMAX, DIF>(buf, roots, tw, ps, M, fr, nbt);
              break;
            default:
              mix_generic_pass<0, RMAX, DIF>(buf, roots, tw, ps, M, fr, nbt);
          }
        }
    }
    __syncthreads();
  }
}

template <int RMAX>
__global__ void __launch_bounds__(MIX_THREADS, 1)
stft_mixed_fft_backward_kernel(const float* __restrict__ x,
                               const float* __restrict__ g,
                               const double* __restrict__ win,
                               const int* __restrict__ perm,
                               const double2* __restrict__ tw,
                               const double* __restrict__ wts,
                               float* __restrict__ d, long long n, int R,
                               int T, Band band, int K, int hop, int L,
                               int detrend, int mode, int two_sided,
                               const __grid_constant__ MixRegPlan plan) {
  extern __shared__ double2 buf[];  // plan.frames frames of K/2 values
  __shared__ double2 roots[MIX_MAX_RADIX + 1];
  __shared__ double2 odd_roots[MIX_MAX_PASSES][8];  // radix 3, 5, 7
  __shared__ double2 red_sum[MIX_THREADS / 32];

  const int M = K >> 1;
  const int pf = plan.pf;
  const int tid = threadIdx.x;
  const int fl = tid / pf;
  const int u = tid - fl * pf;
  const int r = blockIdx.x * plan.frames + fl;
  const bool valid = r < R;
  double2* fbuf = buf + fl * M;
  const double c = 0.5 * (L - 1);
  const double dd = L * (static_cast<double>(L) * L - 1.0) / 12.0;
  const double2* win2 = reinterpret_cast<const double2*>(win);

  // the radix 3, 5 and 7 passes' roots, ordered by the first barrier
  if (tid < MIX_MAX_PASSES * 8) {
    const int q = tid >> 3;
    const int i = tid & 7;
    if (q < plan.n_passes && plan.pass[q].radix <= 7 &&
        plan.pass[q].radix % 2 && i < plan.pass[q].radix)
      odd_roots[q][i] = tw[plan.pass[q].root + i];
  }

  // 1. X: stft_mixed_fft_psd_kernel's load, detrend, window and passes
  if (mode != OUT_COMPLEX) {
    const float* frame =
        x + (valid ? (long long)(r / T) * n + (long long)(r % T) * hop : 0);
    float2 s[MIX_LOAD];
    const bool pairs = (reinterpret_cast<size_t>(frame) & 7) == 0;
#pragma unroll
    for (int i = 0; i < MIX_LOAD; ++i) {
      const int j = u + i * pf;
      s[i] = make_float2(0.0f, 0.0f);
      if (valid && j < M)
        s[i] = pairs && 2 * j + 1 < L
                   ? reinterpret_cast<const float2*>(frame)[j]
                   : make_float2(2 * j < L ? frame[2 * j] : 0.0f,
                                 2 * j + 1 < L ? frame[2 * j + 1] : 0.0f);
    }
    double2 line = make_double2(0.0, 0.0);
    if (detrend != DETREND_NONE) {
      double2 a = make_double2(0.0, 0.0);
#pragma unroll
      for (int i = 0; i < MIX_LOAD; ++i) {
        const int j = u + i * pf;
        if (j < M) {
          a.x += static_cast<double>(s[i].x);
          a.x += static_cast<double>(s[i].y);
          if (detrend == DETREND_LINEAR) {
            a.y += (2 * j - c) * static_cast<double>(s[i].x);
            a.y += (2 * j + 1 - c) * static_cast<double>(s[i].y);
          }
        }
      }
      a = mix_frame_sum(a, pf, red_sum);
      line = make_double2(a.x / L, detrend == DETREND_LINEAR ? a.y / dd : 0.0);
    }
#pragma unroll
    for (int i = 0; i < MIX_LOAD; ++i) {
      const int j = u + i * pf;
      if (j < M) {
        const double2 w = win2[j];
        const int i0 = 2 * j;
        fbuf[perm[j]] = make_double2(
            i0 < L ? (static_cast<double>(s[i].x) - line.x -
                      line.y * (i0 - c)) * w.x
                   : 0.0,
            i0 + 1 < L ? (static_cast<double>(s[i].y) - line.x -
                          line.y * (i0 + 1 - c)) * w.y
                       : 0.0);
      }
    }
    __syncthreads();
    mixed_passes<RMAX, false>(buf, roots, odd_roots, tw, plan, M);
  }

  // 2. H a pair of bins (k, M - k) a thread, and conj Z' in place of Z
  const double2* split = tw + plan.split;
  for (int k = u; 2 * k <= M; k += pf) {
    const int k2 = M - k;                   // bin M at k = 0
    const int kb = k == 0 ? 0 : k2;
    double2 xa = make_double2(0.0, 0.0), xb = xa;
    if (mode != OUT_COMPLEX) {
      const double2 a = fbuf[k];
      const double2 b = fbuf[kb];
      xa = split_bin(a, b, split[k]);
      xb = split_bin(b, a, k == 0 ? make_double2(-1.0, 0.0) : split[k2]);
    }
    const double2 hs = half_weight(
        one_sided_cotangent(xa, g, wts, r, band, k, K, two_sided, mode,
                            valid), k, M);
    const double2 ht = half_weight(
        one_sided_cotangent(xb, g, wts, r, band, k2, K, two_sided, mode,
                            valid), k2, M);
    fbuf[k] = inverse_split(hs, ht, split[k]);
    if (k > 0 && k2 != k) fbuf[kb] = inverse_split(ht, hs, split[k2]);
  }
  __syncthreads();

  // 3. the inverse: the passes in frequency on conj Z' in natural order
  mixed_passes<RMAX, true>(buf, roots, odd_roots, tw, plan, M);

  // 4. u = window d_v over the first L samples, the detrend's projection,
  // the store: sample pair j (2j, 2j + 1) of z'[j] = conj of slot perm[j]
  double2 v[MIX_LOAD];
  double2 sum = make_double2(0.0, 0.0);
#pragma unroll
  for (int i = 0; i < MIX_LOAD; ++i) {
    const int j = u + i * pf;
    v[i] = make_double2(0.0, 0.0);
    if (j < M) {
      const double2 y = fbuf[perm[j]];
      const double2 w = win2[j];
      const int i0 = 2 * j;
      v[i].x = i0 < L ? y.x * w.x : 0.0;
      v[i].y = i0 + 1 < L ? -y.y * w.y : 0.0;
      if (detrend != DETREND_NONE) {
        sum.x += v[i].x;
        sum.x += v[i].y;
        if (detrend == DETREND_LINEAR) {
          sum.y += (i0 - c) * v[i].x;
          sum.y += (i0 + 1 - c) * v[i].y;
        }
      }
    }
  }
  double2 line = make_double2(0.0, 0.0);
  if (detrend != DETREND_NONE) {
    sum = mix_frame_sum(sum, pf, red_sum);
    line = make_double2(sum.x / L,
                        detrend == DETREND_LINEAR ? sum.y / dd : 0.0);
  }
  if (!valid) return;
  float* out = d + static_cast<long long>(r) * L;
#pragma unroll
  for (int i = 0; i < MIX_LOAD; ++i) {
    const int j = u + i * pf;
    const int i0 = 2 * j;
    if (j >= M || i0 >= L) continue;
    const float a = static_cast<float>(v[i].x - line.x - line.y * (i0 - c));
    const float b =
        static_cast<float>(v[i].y - line.x - line.y * (i0 + 1 - c));
    if (i0 + 1 < L && (L & 1) == 0) {
      reinterpret_cast<float2*>(out)[j] = make_float2(a, b);
    } else {
      out[i0] = a;
      if (i0 + 1 < L) out[i0 + 1] = b;
    }
  }
}

// The conv kernels' store: the window and the detrend's projection of d_v
// (dv(i) for sample i < L; dv2 the second frame's when two), stored as
// float32 at rows ra (and rb) of d by the block's threads; red_sum[0] and
// red_sum[1] take the two frames' block reductions
template <typename Dv, typename Dv2>
__device__ __forceinline__ void store_frames(
    float* __restrict__ d, const double* __restrict__ win, int L,
    int detrend, Dv dv, Dv2 dv2, bool two, long long ra, long long rb,
    double2 (*red_sum)[FFT_MAX_WARPS]) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const double c = 0.5 * (L - 1);
  const double dd = L * (static_cast<double>(L) * L - 1.0) / 12.0;
  double2 sa = make_double2(0.0, 0.0), sb = sa;
  if (detrend != DETREND_NONE) {
    for (int i = tid; i < L; i += nt) {
      const double ua = dv(i) * win[i];
      sa.x += ua;
      if (detrend == DETREND_LINEAR) sa.y += (i - c) * ua;
      if (two) {
        const double ub = dv2(i) * win[i];
        sb.x += ub;
        if (detrend == DETREND_LINEAR) sb.y += (i - c) * ub;
      }
    }
    sa = block_sum(sa, red_sum[0]);
    if (two) sb = block_sum(sb, red_sum[1]);
  }
  const bool lin = detrend == DETREND_LINEAR;
  const double2 pa = detrend == DETREND_NONE
                         ? sa
                         : make_double2(sa.x / L, lin ? sa.y / dd : 0.0);
  const double2 pb = detrend == DETREND_NONE
                         ? sb
                         : make_double2(sb.x / L, lin ? sb.y / dd : 0.0);
  for (int i = tid; i < L; i += nt) {
    d[ra * L + i] =
        static_cast<float>(dv(i) * win[i] - pa.x - pa.y * (i - c));
    if (two)
      d[rb * L + i] =
          static_cast<float>(dv2(i) * win[i] - pb.x - pb.y * (i - c));
  }
}

// the odd kernel's inverse forms: the pair, frame a (or a lone frame), and
// frame b of a pair's cotangent pass
constexpr int FORM_PAIR = 0;
constexpr int FORM_A = 1;
constexpr int FORM_B = 2;

template <bool RADER, int RMAX, bool PACKED = false>
__global__ void __launch_bounds__(FFT_MAX_THREADS,
                                  odd_min_blocks(RADER, RMAX, PACKED))
stft_odd_fft_backward_kernel(const float* __restrict__ x,
                             const float* __restrict__ g,
                             const double* __restrict__ win,
                             const int* __restrict__ perm,
                             const double2* __restrict__ tw,
                             const double* __restrict__ wts,
                             float* __restrict__ d, long long n, int T,
                             Band band, int K, int hop, int L, int detrend,
                             int mode, int two_sided,
                             const __grid_constant__ ConvPlan plan) {
  extern __shared__ double2 buf[];  // the transform's values
  __shared__ double2 roots[RMAX > 0 ? MIX_MAX_RADIX + 1 : 1];
  __shared__ double2 small[SMALL_ROOTS];
  __shared__ double2 red_sum[4][FFT_MAX_WARPS];
  __shared__ double2 x_sum;         // X[0] under a Rader stage

  conv_stage_roots(small, tw, plan);
  const SlotMap map{plan.swz_mask, plan.swz_shift};
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const bool cplx = mode == OUT_COMPLEX;
  const double c = 0.5 * (L - 1);
  // the points of the transform a block holds, and with a Rader stage the
  // slot of the value at 0
  const int N = PACKED ? K >> 1 : K;
  const int P = N - 1;
  // sample i of a frame detrended and windowed: its L samples, zero past
  // them (nfft > nperseg: the zero-padded transform)
  const auto sample = [&](const float* f, double2 line, int i) {
    return i < L ? (static_cast<double>(f[i]) - line.x - line.y * (i - c)) *
                       win[i]
                 : 0.0;
  };
  // the transform of the values at the load's slots: the plan's passes in
  // time, or the Rader transform (X[0] in x_sum, X[i] = x0 + slot perm[i])
  const auto forward = [&]() {
    if constexpr (RADER) {
      conv_transform<RMAX>(buf, roots, small, tw, plan, P,
                           RaderProduct{tw + plan.rader, buf + map(P),
                                        &x_sum});
    } else {
      conv_forward<RMAX>(buf, roots, small, tw, plan, N, 0);
    }
  };
  // the inverse's transform of the values at bin slots (at()): the Rader
  // transform again, or the passes in frequency (natural order in place,
  // value i at slot perm[i] out)
  const auto inverse = [&]() {
    if constexpr (RADER) {
      forward();
    } else {
      for (int q = plan.n_passes - 1; q >= 0; --q) {
        conv_pass<RMAX, true>(buf, roots, small, tw, plan.pass[q], N, map);
        __syncthreads();
      }
    }
  };
  // where bin i of the forward's output lies, read and written in place
  const auto at = [&](int i) { return map(RADER ? perm[i] : i); };
  // value i of the inverse's output
  const auto out_at = [&](int i) {
    if constexpr (RADER) {
      if (i == 0) return x_sum;
      const double2 x0 = buf[map(P)];
      const double2 v = buf[map(perm[i])];
      return make_double2(x0.x + v.x, x0.y + v.y);
    } else {
      return buf[map(perm[i])];
    }
  };
  const auto store = [&](auto dv, auto dv2, bool two, long long ra,
                         long long rb) {
    store_frames(d, win, L, detrend, dv, dv2, two, ra, rb, red_sum);
  };

  if constexpr (PACKED) {
    static_assert(RADER, "a packed frame's plan has a Rader stage");
    const int r = blockIdx.x;
    const float* frame =
        x + (long long)(r / T) * n + (long long)(r % T) * hop;
    const int M = N;
    // 1. X: the forward's packed load and Rader transform
    if (!cplx) {
      const double2 line = frame_line(frame, L, detrend, red_sum[0]);
      double* bufd = reinterpret_cast<double*>(buf);
      for (int i = tid; i < K; i += nt)
        bufd[2 * map(perm[i >> 1]) + (i & 1)] = sample(frame, line, i);
      __syncthreads();
      forward();
    }
    // slot P holds z[0] and is written by bin 0: x0 and X[0] in registers
    const double2 x0 = buf[map(P)];
    const double2 z0 = x_sum;
    __syncthreads();
    // 2. H a pair of bins (k, M - k) a thread, conj Z' where Z was read
    const double2* split = tw + plan.split;
    for (int k = tid; 2 * k <= M; k += nt) {
      const int k2 = M - k;
      double2 xa = make_double2(0.0, 0.0), xb = xa;
      if (!cplx) {
        double2 a = z0, b = z0;
        if (k > 0) {
          const double2 va = buf[map(perm[k])];
          const double2 vb = buf[map(perm[k2])];
          a = make_double2(x0.x + va.x, x0.y + va.y);
          b = make_double2(x0.x + vb.x, x0.y + vb.y);
        }
        xa = split_bin(a, b, split[k]);
        xb = split_bin(b, a, k == 0 ? make_double2(-1.0, 0.0) : split[k2]);
      }
      const double2 hs = half_weight(
          one_sided_cotangent(xa, g, wts, r, band, k, K, two_sided, mode,
                              true), k, M);
      const double2 ht = half_weight(
          one_sided_cotangent(xb, g, wts, r, band, k2, K, two_sided, mode,
                              true), k2, M);
      buf[map(perm[k])] = inverse_split(hs, ht, split[k]);
      if (k > 0 && k2 != k) buf[map(perm[k2])] = inverse_split(ht, hs,
                                                              split[k2]);
    }
    __syncthreads();
    // 3. the inverse: the Rader transform of conj Z'
    inverse();
    // 4. sample i from z'[i / 2] = conj of the output's value i / 2
    store([&](int i) {
            const double2 y = out_at(i >> 1);
            return (i & 1) ? -y.y : y.x;
          },
          [&](int) { return 0.0; }, false, r, r);
    return;
  }

  // the odd route: frames t and t + 1 of a clip
  const int pairs = (T + 1) >> 1;
  const int clip = blockIdx.x / pairs;
  const int t = (blockIdx.x - clip * pairs) * 2;
  const long long ra = (long long)clip * T + t;
  const bool has_b = t + 1 < T;
  const float* fa = x + (long long)clip * n + (long long)t * hop;
  const float* fb = fa + hop;
  const int H = K >> 1;             // the one-sided bins past 0
  double2 la = make_double2(0.0, 0.0), lb = la;
  bool fwd_pair = false;
  if (!cplx) {
    // the forward's load and guard: a pair shares one transform or each
    // frame is transformed alone, as stft_odd_fft_psd_kernel decides
    la = frame_line(fa, L, detrend, red_sum[0]);
    if (has_b) lb = frame_line(fb, L, detrend, red_sum[1]);
    double2 e = make_double2(0.0, 0.0);
    for (int i = tid; i < K; i += nt) {
      const double va = sample(fa, la, i);
      const double vb = has_b ? sample(fb, lb, i) : 0.0;
      buf[map(perm[i])] = make_double2(va, vb);
      e.x += va * va;
      e.y += vb * vb;
    }
    e = block_sum(e, red_sum[2]);   // also the loads' barrier
    fwd_pair = has_b && isfinite(e.x) && isfinite(e.y) &&
               e.x > 0.0 && e.y > 0.0 &&
               fmax(e.x, e.y) <= PAIR_MAX_RATIO * fmin(e.x, e.y);
  }
  // both frames' cotangents from one pass: the pair's transform, or g
  // alone for the complex outputs
  const bool both = has_b && (cplx || fwd_pair);
  bool inv_pair = false;
  for (int unit = 0; unit < 2; ++unit) {
    // unit 0: the pair or frame a; unit 1: frame b alone
    if (unit == 1 && (!has_b || inv_pair)) break;
    if (unit == 1) __syncthreads();  // unit 0's reads before these writes
    // 1. X
    if (!cplx) {
      if (unit == 1) {
        for (int i = tid; i < K; i += nt)
          buf[map(perm[i])] =
              both ? make_double2(sample(fa, la, i), sample(fb, lb, i))
                   : make_double2(sample(fb, lb, i), 0.0);
        __syncthreads();
      } else if (!both) {
        for (int s = tid; s < K; s += nt) buf[s].y = 0.0;
        __syncthreads();
      }
      forward();
    }
    double2 x0 = make_double2(0.0, 0.0), z0 = x0;
    if constexpr (RADER) {
      if (!cplx) {                  // slot P is bin 0's, written below
        x0 = buf[map(P)];
        z0 = x_sum;
        __syncthreads();
      }
    }
    const auto z_at = [&](int i) {
      if constexpr (RADER) {
        if (i == 0) return z0;
        const double2 v = buf[map(perm[i])];
        return make_double2(x0.x + v.x, x0.y + v.y);
      } else {
        return buf[map(i)];
      }
    };
    // 2. the one-sided S of each frame, bins f and K - f a thread: S_a[f]
    // at bin f, S_b[f] at bin K - f, (S_a[0], S_b[0]) at bin 0; a lone
    // frame's S[f] at bin f
    const long long rl = ra + unit;   // a lone frame's row
    double2 e = make_double2(0.0, 0.0);
    for (int f = tid; f <= H; f += nt) {
      const int m = f == 0 ? 0 : K - f;
      double2 xa = make_double2(0.0, 0.0), xb = xa;
      if (!cplx) {
        const double2 a = z_at(f);
        const double2 b = z_at(m);
        if (both) {
          xa = make_double2(0.5 * (a.x + b.x), 0.5 * (a.y - b.y));
          xb = make_double2(0.5 * (a.y + b.y), 0.5 * (b.x - a.x));
        } else {
          xa = a;
        }
      }
      double2 sa = one_sided_cotangent(xa, g, wts, both ? ra : rl, band, f,
                                       K, two_sided, mode, true);
      sa = f == 0 ? make_double2(sa.x, 0.0)
                  : make_double2(0.5 * sa.x, 0.5 * sa.y);
      if (both) {
        double2 sb = one_sided_cotangent(xb, g, wts, ra + 1, band, f, K,
                                         two_sided, mode, true);
        sb = f == 0 ? make_double2(sb.x, 0.0)
                    : make_double2(0.5 * sb.x, 0.5 * sb.y);
        e.x += sa.x * sa.x + sa.y * sa.y;
        e.y += sb.x * sb.x + sb.y * sb.y;
        if (f == 0) {
          buf[at(0)] = make_double2(sa.x, sb.x);
        } else {
          buf[at(f)] = sa;
          buf[at(m)] = sb;
        }
      } else {
        buf[at(f)] = sa;
      }
    }
    // the cotangents' guard: the pair is inverted together only where
    // both frames' S are finite, nonzero and within PAIR_MAX_RATIO
    if (both && unit == 0) {
      e = block_sum(e, red_sum[3]);
      inv_pair = isfinite(e.x) && isfinite(e.y) && e.x > 0.0 && e.y > 0.0 &&
                 fmax(e.x, e.y) <= PAIR_MAX_RATIO * fmin(e.x, e.y);
    }
    // conj Z' at bins f and K - f: the pair's S_a + i S_b, or a frame's S
    // extended Hermitian
    const int form = inv_pair ? FORM_PAIR
                              : (both && unit == 1 ? FORM_B : FORM_A);
    for (int f = tid; f <= H; f += nt) {
      if (f == 0) {
        const double2 s0 = buf[at(0)];
        buf[at(0)] = form == FORM_PAIR ? make_double2(s0.x, -s0.y)
                                       : make_double2(
                                             form == FORM_B ? s0.y : s0.x,
                                             0.0);
        continue;
      }
      const int m = K - f;
      if (form == FORM_PAIR) {
        const double2 sa = buf[at(f)];
        const double2 sb = buf[at(m)];
        buf[at(f)] = make_double2(sa.x - sb.y, -(sa.y + sb.x));
        buf[at(m)] = make_double2(sa.x + sb.y, sa.y - sb.x);
      } else {
        const double2 s = buf[at(form == FORM_B ? m : f)];
        buf[at(f)] = make_double2(s.x, -s.y);
        buf[at(m)] = s;
      }
    }
    __syncthreads();
    // 3. the inverse, then 4. the store: y = conj(d_a + i d_b) for the
    // pair, conj d for a lone frame
    inverse();
    if (inv_pair) {
      store([&](int i) { return out_at(i).x; },
            [&](int i) { return -out_at(i).y; }, true, ra, ra + 1);
    } else {
      store([&](int i) { return out_at(i).x; }, [&](int) { return 0.0; },
            false, rl, rl);
    }
  }
}

// The Bluestein route's adjoint: one block (RANKS = 1) or a cluster of two
// (RANKS = 2) a unit, as stft_bluestein_psd_kernel: a frame of even K, row
// blockIdx.x, or for odd K frames t = 2j and t + 1 of clip b, unit b
// ceil(T / 2) + j. TWO: two blocks an SM (M up to BLUE_TWO_BLOCK_POINTS).
// EXT: a frame shorter than the transform or an output other than the PSD.
// Rank 0 loads, forms the cotangent and stores; rank 1 only takes part in
// the transforms, as many as rank 0 runs (cluster.sync pairs them), and
// reads rank 0's pair-or-alone decision for the inverse from its shared
// memory.
template <int RANKS, bool TWO, bool EXT>
__global__ void __launch_bounds__(FFT_MAX_THREADS,
                                  TWO ? 2 : BLUE_MIN_BLOCKS)
stft_bluestein_fft_backward_kernel(const float* __restrict__ x,
                                   const float* __restrict__ g,
                                   const double* __restrict__ win,
                                   const double2* __restrict__ tw,
                                   const double* __restrict__ wts,
                                   float* __restrict__ d, long long n, int T,
                                   Band band, int K, int hop, int frame_len,
                                   int detrend, int out_mode, int two_sided,
                                   int M, int bhat, int chirp_row,
                                   int half_row,
                                   const __grid_constant__ ConvPlan plan) {
  extern __shared__ double2 buf[];  // M / RANKS complex values
  __shared__ double2 small[SMALL_ROOTS];
  __shared__ double2 red_sum[4][FFT_MAX_WARPS];
  __shared__ int inv_flag;          // rank 0's: the pair shares the inverse
  const int L = EXT ? frame_len : K;
  const int mode = EXT ? out_mode : OUT_PSD;

  conv_stage_roots(small, tw, plan);
  const SlotMap map{plan.swz_mask, plan.swz_shift};
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int unit = blockIdx.x / RANKS;
  const int H = M / RANKS;
  const double2* chirp = tw + chirp_row;
  const bool cplx = mode == OUT_COMPLEX;
  const double c = 0.5 * (L - 1);
  bool lead = true;                 // rank 0
  if constexpr (RANKS == 2) lead = cg::this_cluster().block_rank() == 0;
  const bool even = RANKS == 1 && K % 2 == 0;
  const int N = even ? K >> 1 : K;
  const BluesteinRead read{buf, chirp, map};
  // the frame's L samples, zero past them, as the forward's
  const auto sample = [&](const float* f, double2 line, int i) {
    return !EXT || i < L
               ? (static_cast<double>(f[i]) - line.x - line.y * (i - c)) *
                     win[i]
               : 0.0;
  };
  const auto transform = [&]() {
    bluestein_transform<RANKS>(buf, small, tw, plan, M, N, bhat, half_row);
  };
  const auto store = [&](auto dv, auto dv2, bool two, long long ra,
                         long long rb) {
    store_frames(d, win, L, detrend, dv, dv2, two, ra, rb, red_sum);
  };

  if (even) {
    // even K: a frame packed as the forward's, N = K/2
    const int r = unit;
    const float* frame =
        x + (long long)(r / T) * n + (long long)(r % T) * hop;
    // 1. X: the forward's load, z_m = (v[2m] + i v[2m + 1]) w_m, and
    // transform
    if (!cplx) {
      const double2 line = frame_line(frame, L, detrend, red_sum[0]);
      for (int i = tid; i < M; i += nt)
        buf[map(i)] = i < N ? cmul(chirp[i],
                                   make_double2(sample(frame, line, 2 * i),
                                                sample(frame, line,
                                                       2 * i + 1)))
                            : make_double2(0.0, 0.0);
      transform();
    }
    // 2. H a pair of bins (k, N - k) a thread, w_k conj Z'[k] where X's
    // slots were read; the slots past N zero
    const double2* split = tw + plan.split;
    for (int k = tid; 2 * k <= N; k += nt) {
      const int k2 = N - k;                 // bin N at k = 0
      const int kb = k == 0 ? 0 : k2;
      double2 xa = make_double2(0.0, 0.0), xb = xa;
      if (!cplx) {
        const double2 a = read(k);
        const double2 b = read(kb);
        xa = split_bin(a, b, split[k]);
        xb = split_bin(b, a, k == 0 ? make_double2(-1.0, 0.0) : split[k2]);
      }
      const double2 hs = half_weight(
          one_sided_cotangent(xa, g, wts, r, band, k, K, two_sided, mode,
                              true), k, N);
      const double2 ht = half_weight(
          one_sided_cotangent(xb, g, wts, r, band, k2, K, two_sided, mode,
                              true), k2, N);
      buf[map(k)] = cmul(chirp[k], inverse_split(hs, ht, split[k]));
      if (k > 0 && k2 != k)
        buf[map(kb)] = cmul(chirp[kb], inverse_split(ht, hs, split[k2]));
    }
    for (int s = N + tid; s < M; s += nt)
      buf[map(s)] = make_double2(0.0, 0.0);
    // 3. the inverse: the same transform of conj Z', y_j = conj z'[j]
    transform();
    // 4. sample i from z'[i / 2] = d_v[2j] + i d_v[2j + 1]
    store([&](int i) {
            const double2 y = read(i >> 1);
            return (i & 1) ? -y.y : y.x;
          },
          [&](int) { return 0.0; }, false, r, r);
    return;
  }

  // odd K: frames t and t + 1 of a clip, N = K
  const int pairs = (T + 1) >> 1;
  const int clip = unit / pairs;
  const int t = (unit - clip * pairs) * 2;
  const long long ra = (long long)clip * T + t;
  const bool has_b = t + 1 < T;
  const float* fa = x + (long long)clip * n + (long long)t * hop;
  const float* fb = fa + hop;
  const int HB = K >> 1;            // the one-sided bins past 0
  double2 la = make_double2(0.0, 0.0), lb = la;
  bool fwd_pair = false;
  if (!cplx) {
    // the forward's load and guard, both ranks computing the lines and
    // energies: a pair shares one transform or each frame is transformed
    // alone, as stft_bluestein_psd_kernel decides
    la = frame_line(fa, L, detrend, red_sum[0]);
    if (has_b) lb = frame_line(fb, L, detrend, red_sum[1]);
    double2 e = make_double2(0.0, 0.0);
    for (int i = tid; i < H; i += nt) {
      double2 z = make_double2(0.0, 0.0);
      if (i < N) {
        const double va = sample(fa, la, i);
        const double vb = has_b ? sample(fb, lb, i) : 0.0;
        z = cmul(chirp[i], make_double2(va, vb));
        e.x += va * va;
        e.y += vb * vb;
      }
      if (lead) buf[map(i)] = z;
    }
    e = block_sum(e, red_sum[2]);   // also orders the loads before reloads
    fwd_pair = has_b && isfinite(e.x) && isfinite(e.y) && e.x > 0.0 &&
               e.y > 0.0 && fmax(e.x, e.y) <= PAIR_MAX_RATIO * fmin(e.x, e.y);
  }
  // both frames' cotangents from one pass: the pair's transform, or g
  // alone for the complex outputs
  const bool both = has_b && (cplx || fwd_pair);
  bool inv_pair = false;
  for (int u = 0; u < 2; ++u) {
    // unit 0: the pair or frame a; unit 1: frame b alone
    if (u == 1 && (!has_b || inv_pair)) break;
    if (u == 1) __syncthreads();    // unit 0's reads before these writes
    // 1. X: the pair again for frame b alone (its S from the pair's B),
    // or a lone frame reloaded, z_i = v[i] w_i
    if (!cplx) {
      if (u == 1 || !both) {
        for (int i = tid; lead && i < H; i += nt)
          buf[map(i)] =
              i < N ? cmul(chirp[i],
                           u == 1 && both
                               ? make_double2(sample(fa, la, i),
                                              sample(fb, lb, i))
                               : make_double2(u ? sample(fb, lb, i)
                                                : sample(fa, la, i),
                                              0.0))
                    : make_double2(0.0, 0.0);
      }
      transform();
    }
    const long long rl = ra + u;    // a lone frame's row
    if (lead) {
      // 2. the one-sided S of each frame, bins f and K - f a thread: S_a[f]
      // at slot f, S_b[f] at slot K - f, (S_a[0], S_b[0]) at slot 0; a
      // lone frame's S[f] at slot f
      double2 e = make_double2(0.0, 0.0);
      for (int f = tid; f <= HB; f += nt) {
        const int m = f == 0 ? 0 : K - f;
        double2 xa = make_double2(0.0, 0.0), xb = xa;
        if (!cplx) {
          const double2 a = read(f);
          const double2 b = read(m);
          if (both) {
            xa = make_double2(0.5 * (a.x + b.x), 0.5 * (a.y - b.y));
            xb = make_double2(0.5 * (a.y + b.y), 0.5 * (b.x - a.x));
          } else {
            xa = a;
          }
        }
        double2 sa = one_sided_cotangent(xa, g, wts, both ? ra : rl, band,
                                         f, K, two_sided, mode, true);
        sa = f == 0 ? make_double2(sa.x, 0.0)
                    : make_double2(0.5 * sa.x, 0.5 * sa.y);
        if (both) {
          double2 sb = one_sided_cotangent(xb, g, wts, ra + 1, band, f, K,
                                           two_sided, mode, true);
          sb = f == 0 ? make_double2(sb.x, 0.0)
                      : make_double2(0.5 * sb.x, 0.5 * sb.y);
          e.x += sa.x * sa.x + sa.y * sa.y;
          e.y += sb.x * sb.x + sb.y * sb.y;
          if (f == 0) {
            buf[map(0)] = make_double2(sa.x, sb.x);
          } else {
            buf[map(f)] = sa;
            buf[map(m)] = sb;
          }
        } else {
          buf[map(f)] = sa;
        }
      }
      // the cotangents' guard: the pair is inverted together only where
      // both frames' S are finite, nonzero and within PAIR_MAX_RATIO
      if (both && u == 0) {
        e = block_sum(e, red_sum[3]);
        inv_pair = isfinite(e.x) && isfinite(e.y) && e.x > 0.0 &&
                   e.y > 0.0 &&
                   fmax(e.x, e.y) <= PAIR_MAX_RATIO * fmin(e.x, e.y);
      }
    }
    if constexpr (RANKS == 2) {
      // rank 1 takes rank 0's decision before the inverse's first sync,
      // past which rank 0 may exit
      if (both && u == 0) {
        cg::cluster_group cluster = cg::this_cluster();
        if (lead && tid == 0) inv_flag = inv_pair ? 1 : 0;
        cluster.sync();
        if (!lead) inv_pair = *cluster.map_shared_rank(&inv_flag, 0) != 0;
      }
    }
    if (lead) {
      // w_f conj Z'[f] at slots f and K - f: the pair's S_a + i S_b, or a
      // frame's S extended Hermitian; the slots past K zero
      const int form = inv_pair ? FORM_PAIR
                                : (both && u == 1 ? FORM_B : FORM_A);
      for (int f = tid; f <= HB; f += nt) {
        if (f == 0) {
          const double2 s0 = buf[map(0)];
          buf[map(0)] = cmul(chirp[0],
                             form == FORM_PAIR
                                 ? make_double2(s0.x, -s0.y)
                                 : make_double2(form == FORM_B ? s0.y : s0.x,
                                                0.0));
          continue;
        }
        const int m = K - f;
        if (form == FORM_PAIR) {
          const double2 sa = buf[map(f)];
          const double2 sb = buf[map(m)];
          buf[map(f)] =
              cmul(chirp[f], make_double2(sa.x - sb.y, -(sa.y + sb.x)));
          buf[map(m)] = cmul(chirp[m], make_double2(sa.x + sb.y, sa.y - sb.x));
        } else {
          const double2 s = buf[map(form == FORM_B ? m : f)];
          buf[map(f)] = cmul(chirp[f], make_double2(s.x, -s.y));
          buf[map(m)] = cmul(chirp[m], s);
        }
      }
      for (int s = K + tid; s < H; s += nt)
        buf[map(s)] = make_double2(0.0, 0.0);
    }
    // 3. the inverse: the same transform, then 4. the store: y = conj(d_a
    // + i d_b) for the pair, conj d for a lone frame
    transform();
    if (!lead) continue;
    if (inv_pair) {
      store([&](int i) { return read(i).x; },
            [&](int i) { return -read(i).y; }, true, ra, ra + 1);
    } else {
      store([&](int i) { return read(i).x; }, [&](int) { return 0.0; },
            false, rl, rl);
    }
  }
}

// the dynamic shared memory limit already set, per device: the mixed
// kernel's three instantiations; the odd kernel's eight and its two PACKED
size_t mixed_bwd_smem_set[3][FFT_MAX_DEVICES] = {};
size_t odd_bwd_smem_set[10][FFT_MAX_DEVICES] = {};
// (the Bluestein kernel's: on one block, at two blocks an SM, and on a
// cluster of two; each with and without EXT)
size_t blue_bwd_smem_set[2][3][FFT_MAX_DEVICES] = {};

// the sizes the launchers take: a band of the K bins when two_sided,
// else of K/2 + 1, and T >= 1 frames of L samples hop apart in n
bool backward_sizes_ok(int B, long long n, int T, int F, int K, int L,
                       int hop, int detrend, int mode, int two_sided,
                       int f_lo) {
  return B >= 0 && T >= 1 && hop >= 1 && L >= 1 && L <= K &&
         band_ok(f_lo, F, two_sided ? K : K / 2 + 1) &&
         static_cast<long long>(T - 1) * hop + L <= n && detrend_ok(detrend) &&
         mode >= OUT_PSD && mode <= OUT_COMPLEX;
}

}  // namespace

extern "C" {

// The mixed route's adjoint, on `stream`; returns the cudaError_t (0 =
// success), or cudaErrorInvalidValue for sizes, a plan, a detrend code or a
// mode the kernel does not take, else that of raising its shared memory
// limit, else that of the launch. x is (B, n) f32, the forward's uncentered
// waveform, T >= 1 frames of L samples hop apart; g (B * T, F) f32, or
// interleaved float2 for mode OUT_COMPLEX, the band of F bins from f_lo of
// the K bins when two_sided, else of K/2 + 1; win, perm, tw, stages, split,
// rader and wts the forward mixed-radix launcher's operands
// (ops/stft_cuda.py::mixed_constants: stages in HOST memory, wts every
// bin's weight of the output); d (B * T, L) f32; the rest contiguous on the
// device. K is even, 32 to 8192, 1 <= L <= K; detrend 0 none, 1 constant, 2
// linear. A Rader plan (rader >= 0) runs the odd kernel's PACKED form, a
// block a frame. The caller keeps B * T within the grid's limit.
int stft_mixed_fft_backward_launch(const float* x, const float* g,
                                   const double* win, const int* perm,
                                   const double* tw, const int* stages,
                                   int n_stages, int split, int rader,
                                   const double* wts, float* d, int B,
                                   long long n, int T, int F, int K, int L,
                                   int hop, int detrend, int mode,
                                   int two_sided, int f_lo, void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  if (K < 32 || K > 8192 || K % 2 || split < 0 ||
      !backward_sizes_ok(B, n, T, F, K, L, hop, detrend, mode, two_sided,
                         f_lo))
    return static_cast<int>(bad);
  const int R = B * T;
  if (R == 0) return 0;
  const Band band{f_lo, F};
  const int ts = two_sided ? 1 : 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double2* tw2 = reinterpret_cast<const double2*>(tw);
  if (rader >= 0) {
    ConvPlan plan;
    int rmax = 0;
    int threads = 0;
    if (!conv_plan(stages, n_stages, K / 2 - 1, rader, split, true, K / 2,
                   K / 2, PACKED_R2_BITS, &plan, &rmax, &threads) ||
        rmax > 1)
      return static_cast<int>(bad);
    const auto kernel = rmax == 0
                            ? stft_odd_fft_backward_kernel<true, 0, true>
                            : stft_odd_fft_backward_kernel<true, 1, true>;
    const size_t smem = static_cast<size_t>(K / 2) * sizeof(double2);
    const int err = raise_smem(kernel, smem, odd_bwd_smem_set[8 + rmax]);
    if (err != 0) return err;
    kernel<<<static_cast<unsigned>(R), threads, smem, st>>>(
        x, g, win, perm, tw2, wts, d, n, T, band, K, hop, L, detrend, mode,
        ts, plan);
    return static_cast<int>(cudaGetLastError());
  }
  MixRegPlan plan;
  int rmax = 0;
  if (!mixed_register_plan(stages, n_stages, split, K / 2, &plan, &rmax))
    return static_cast<int>(bad);
  const int variant = rmax / 4;                 // 0, 1, 2
  const auto kernel = variant == 0   ? stft_mixed_fft_backward_kernel<0>
                      : variant == 1 ? stft_mixed_fft_backward_kernel<4>
                                     : stft_mixed_fft_backward_kernel<8>;
  const size_t smem =
      static_cast<size_t>(plan.frames) * (K / 2) * sizeof(double2);
  const int err = raise_smem(kernel, smem, mixed_bwd_smem_set[variant]);
  if (err != 0) return err;
  const unsigned blocks =
      static_cast<unsigned>((R + plan.frames - 1) / plan.frames);
  kernel<<<blocks, MIX_THREADS, smem, st>>>(x, g, win, perm, tw2, wts, d, n,
                                            R, T, band, K, hop, L, detrend,
                                            mode, ts, plan);
  return static_cast<int>(cudaGetLastError());
}

// The odd route's adjoint, on `stream`; returns a cudaError_t as the mixed
// launcher does. Its operands are the forward odd launcher's (perm (K,)
// int32, a plan of K points, with a Rader stage of K - 1, no split rows)
// and the mixed launcher's g, wts and d; K, the transform length, is odd,
// 33 to 8191. Frames pair as the two guards allow. The kernel runs B *
// ceil(T / 2) blocks.
int stft_odd_fft_backward_launch(const float* x, const float* g,
                                 const double* win, const int* perm,
                                 const double* tw, const int* stages,
                                 int n_stages, int rader, const double* wts,
                                 float* d, int B, long long n, int T, int F,
                                 int K, int L, int hop, int detrend, int mode,
                                 int two_sided, int f_lo, void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  ConvPlan plan;
  int rmax = 0;
  int threads = 0;
  if (K < 33 || K > 8191 || K % 2 == 0 || rader < -1 ||
      !backward_sizes_ok(B, n, T, F, K, L, hop, detrend, mode, two_sided,
                         f_lo) ||
      !conv_plan(stages, n_stages, rader >= 0 ? K - 1 : K, rader, -1,
                 rader >= 0, K,
                 rader >= 0 ? RADER_NARROW_POINTS : ODD_NARROW_POINTS,
                 MIX_R2_BITS, &plan, &rmax, &threads))
    return static_cast<int>(bad);
  if (B == 0) return 0;
  const int variant =
      4 * (rader >= 0) + (rmax == 1 ? 1 : rmax / 4 + (rmax > 0));
  const auto kernel = variant == 0   ? stft_odd_fft_backward_kernel<false, 0>
                      : variant == 1 ? stft_odd_fft_backward_kernel<false, 1>
                      : variant == 2 ? stft_odd_fft_backward_kernel<false, 4>
                      : variant == 3 ? stft_odd_fft_backward_kernel<false, 8>
                      : variant == 4 ? stft_odd_fft_backward_kernel<true, 0>
                      : variant == 5 ? stft_odd_fft_backward_kernel<true, 1>
                      : variant == 6 ? stft_odd_fft_backward_kernel<true, 4>
                                     : stft_odd_fft_backward_kernel<true, 8>;
  const size_t smem = static_cast<size_t>(K) * sizeof(double2);
  const int err = raise_smem(kernel, smem, odd_bwd_smem_set[variant]);
  if (err != 0) return err;
  const unsigned blocks =
      static_cast<unsigned>(B) * static_cast<unsigned>((T + 1) / 2);
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, g, win, perm, reinterpret_cast<const double2*>(tw), wts, d, n, T,
      Band{f_lo, F}, K, hop, L, detrend, mode, two_sided ? 1 : 0, plan);
  return static_cast<int>(cudaGetLastError());
}

// The Bluestein route's adjoint, on `stream`; returns a cudaError_t as the
// mixed launcher does (a cluster that cannot be placed included). Its
// operands are the forward Bluestein launcher's (tw (rows, 2) f64 and
// stages, in HOST memory, of M's plan, with bhat, chirp and split the first
// rows of b^, of the chirp and of the split step, -1 for odd K;
// ops/stft_cuda.py::bluestein_constants) and the mixed launcher's g, wts
// and d; K, the transform length, is 32 to 8192, M >= 2N - 1 (N = K/2, or
// K when odd) with radices 2, 3, 5 and 7; M past BLUE_MAX_BLOCK_POINTS runs
// on clusters of two blocks and must be even with a last stage of radix 2
// at span M/2, and K odd. The kernel runs B * T units for even K and B *
// ceil(T / 2) for odd K, a block or a cluster each.
int stft_bluestein_fft_backward_launch(const float* x, const float* g,
                                       const double* win, const double* tw,
                                       const int* stages, int n_stages,
                                       int M, int bhat, int chirp, int split,
                                       const double* wts, float* d, int B,
                                       long long n, int T, int F, int K,
                                       int L, int hop, int detrend, int mode,
                                       int two_sided, int f_lo,
                                       void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  const bool odd = K % 2 == 1;
  const int N = odd ? K : K / 2;
  const int ranks = M > BLUE_MAX_BLOCK_POINTS ? 2 : 1;
  if (K < 32 || K > 8192 || M < 2 * N - 1 || bhat < 0 || chirp < 0 ||
      (split < 0) != odd || n_stages < 1 || n_stages > MIX_MAX_STAGES ||
      !backward_sizes_ok(B, n, T, F, K, L, hop, detrend, mode, two_sided,
                         f_lo))
    return static_cast<int>(bad);
  for (int s = 0; s < n_stages; ++s)
    if (stages[4 * s] > BLUE_MAX_RADIX) return static_cast<int>(bad);
  int half_row = -1;
  int local_stages = n_stages;
  if (ranks == 2) {
    const int* last = stages + 4 * (n_stages - 1);
    if (!odd || M % 2 || M / 2 > BLUE_MAX_BLOCK_POINTS || last[0] != 2 ||
        last[1] != M / 2)
      return static_cast<int>(bad);
    half_row = last[2];
    local_stages -= 1;              // the halves' stages; the last crosses
  }
  const int local = M / ranks;
  ConvPlan plan;
  int rmax = 0;
  int threads = 0;
  if (!conv_plan(stages, local_stages, local, -1, split, true, local,
                 RADER_NARROW_POINTS, MIX_R2_BITS, &plan, &rmax, &threads) ||
      rmax != 0)
    return static_cast<int>(bad);
  if (B == 0) return 0;
  const int variant =
      ranks == 2 ? 2 : (local <= BLUE_TWO_BLOCK_POINTS ? 1 : 0);
  const bool ext = L < K || mode != OUT_PSD;
  decltype(&stft_bluestein_fft_backward_kernel<1, false, false>)
      const by_variant[2][3] =
      {{stft_bluestein_fft_backward_kernel<1, false, false>,
        stft_bluestein_fft_backward_kernel<1, true, false>,
        stft_bluestein_fft_backward_kernel<2, false, false>},
       {stft_bluestein_fft_backward_kernel<1, false, true>,
        stft_bluestein_fft_backward_kernel<1, true, true>,
        stft_bluestein_fft_backward_kernel<2, false, true>}};
  const auto kernel = by_variant[ext][variant];
  const size_t smem = static_cast<size_t>(local) * sizeof(double2);
  const int err = raise_smem(kernel, smem, blue_bwd_smem_set[ext][variant]);
  if (err != 0) return err;
  const unsigned units =
      static_cast<unsigned>(B) *
      static_cast<unsigned>(odd ? (T + 1) / 2 : T);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double2* tw2 = reinterpret_cast<const double2*>(tw);
  const Band band{f_lo, F};
  const int ts = two_sided ? 1 : 0;
  if (ranks == 1) {
    kernel<<<units, threads, smem, s>>>(x, g, win, tw2, wts, d, n, T, band,
                                        K, hop, L, detrend, mode, ts, M,
                                        bhat, chirp, half_row, plan);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(units * 2);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(
      &config, kernel, x, g, win, tw2, wts, d, n, T, band, K, hop, L,
      detrend, mode, ts, M, bhat, chirp, half_row, plan);
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

const char* stft_grad_mixed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
