// Fused STFT / PSD kernels for NVIDIA Hopper (sm_90a), nperseg up to 8192.
//
// Replace the TPU kernels of spectral_tpu/ops/stft_pallas.py::
// stft_psd_pallas: the auto kernel `_compute` (K1, with the `with_stats` and
// `log10_out` modes) and the manual-DMA kernel `kernel_manual` (K2, A left in
// HBM and one A tile reloaded per frequency tile, nperseg 6145-8192). Both
// compute the same function, which this file computes by five routes:
//
// - stft_psd_kernel (stft_psd_launch), the GEMM route below: any nperseg,
//   any detrend, the real DFT as a GEMM against (K, F) matrices;
// - stft_fft_psd_kernel (stft_fft_psd_launch), the FFT route after it:
//   power-of-two nperseg 32-8192, any detrend, a radix-2 FFT of nperseg/2
//   points, three or four stages at a time in registers, a frame on 2-256
//   threads;
// - stft_mixed_fft_psd_kernel (stft_mixed_fft_psd_launch), the mixed-radix
//   route: the other even nperseg 32-8192 whose nperseg/2 has no odd prime
//   factor past 255 (every other GUI value), any detrend, the same
//   structure with radix-2, 3, 5, 7 and generic odd-radix stages; where
//   nperseg/2 is a prime whose p - 1 has none (a Rader stage), the same
//   launcher runs the odd kernel's template on one packed frame a block;
// - stft_odd_fft_psd_kernel (stft_odd_fft_psd_launch), the odd route: odd
//   nperseg 33-8191 by the same rule, two frames of a clip a transform;
// - stft_bluestein_psd_kernel (stft_bluestein_psd_launch), the Bluestein
//   route at the end of the file: every other nperseg 32-8192, the
//   transform as a cyclic convolution of a 2, 3, 5, 7-smooth length, on
//   one block or a cluster of two.
//
// The wrapper (ops/stft_cuda.py::route) picks the route by config. The
// GEMM route computes:
//
//   row r = b*T + t         : frame t of clip b, all clips' frames flattened
//   frame                   = x[b, t*hop : t*hop + K]        (read in place)
//   X_re, X_im              = frame @ A_re, frame @ A_im      (window and
//                                                             detrend folded
//                                                             into A)
//   p[b, t, f]              = (X_re^2 + X_im^2) * wts[f]
//   log10_out               : p <- log10(p + 1e-20)
//   with_stats              : per (frequency tile, row) (min, max) of p,
//                             NaN-propagating; torch.amin/amax finish them
//                             per clip.
//
// Output is frame-major (B, T, F) f32 with no padding; ragged edges are
// masked.
//
// Accumulation is float64 (a float32 chain breaks the 1e-3 dB display
// contract; the measurements are in ops/stft_cuda.py): x staged to f64 in
// shared memory, A in f64 (the host's f64 constants unrounded), one DFMA
// chain per output, the epilogue (re^2 + im^2) * w in f64, rounded once to
// f32 at the store.
//
// What bounds it on this card: 4*B*T*F*K flops against B*n*4 bytes in and
// B*T*F*4 bytes out, so at large K it is compute-bound: 67 TFLOP/s of FP64
// on the tensor cores, of which this design, on DFMA outside them, can
// reach at most half (about 33.5 TFLOP/s). Below nperseg 32 (F <= 16, the
// route's own configs) it is bound by bytes, and a tile of its own takes
// it (stft_psd_small_kernel, below). The large-K tile is a
// register-blocked GEMM: each block owns a 128-row x 64-bin tile, stages
// 16-sample chunks of its frames and of the A_re/A_im tiles in shared
// memory, and each thread accumulates an 8 x 4 tile of both X_re and X_im
// in registers. Frames are read straight from the signal by pointer, so no
// frame tensor (nperseg/hop times the signal) is written, and the gcd
// framing the TPU kernel needs for hops that do not divide nperseg has no
// counterpart.
//
// Grid order: one linear grid over (row tile, frequency tile) with the
// frequency tiles of a row tile adjacent, so they run together and share
// the row tile's frames in L2. The flattened rows (r = b*T + t) fill row
// tiles across clip boundaries: 10 s clips at scipy_default 8192 have
// T = 22, which would fill 17% of a per-clip tile. The other order, K2's
// "A tile resident, clips innermost" with the frequency tile slow, was
// measured on the card and is no faster even where A (537 MB in f64 at
// K = 8192) is far past the 50 MB L2: 301 ms against 299 ms at
// scipy_default 8192, and 46.3 ms against 41.8 ms on the fp32 headline
// path (PERF.md). Each block's stage loads wait on memory (no double
// buffering); frames found in L2, and frame pointers held in registers,
// are what keep those waits short. (Those timings include the float32
// instantiation this source had then.)

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 128;          // rows (frames) per block
constexpr int BN = 64;           // frequency bins per block
constexpr int BK = 16;           // samples per shared-memory stage
constexpr int TX = 16;           // threads along bins
constexpr int TY = 16;           // threads along rows
constexpr int NT = TX * TY;      // threads per block
constexpr int TM = BM / TY;      // rows per thread (8)
constexpr int TN = BN / TX;      // bins per thread (4)
constexpr int XPAD = 4;          // keeps 16-byte alignment, spreads banks

static_assert(TM == 8 && TN == 4, "the vector loads below assume 8 x 4");
static_assert((BM * BK) % NT == 0 && (BN * BK) % NT == 0, "stage split");
static_assert(TX == 16 && NT % 32 == 0, "row reduction over 16 lanes");

// min/max that propagate NaN like torch.amin/amax (fminf/fmaxf drop it)
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// N consecutive shared-memory values as 16-byte vector loads
template <int N>
__device__ __forceinline__ void load_vec(const double* p, double (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const double2 q = *reinterpret_cast<const double2*>(p + i);
    v[i] = q.x;
    v[i + 1] = q.y;
  }
}

// (re^2 + im^2) * w with every step rounded to nearest: no FMA
// contraction, so it rounds exactly like the plain elementwise version.
// |X|^2 past float32's range gives inf, as the float32 pipeline of the JAX
// package overflows there, so the clip's finite flag trips as it does there.
__device__ __forceinline__ double power(double re, double im, double w) {
  const double s = __dadd_rn(__dmul_rn(re, re), __dmul_rn(im, im));
  return s > 3.4028234663852886e38 ? INFINITY : __dmul_rn(s, w);
}

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

using Acc = double;

__global__ void __launch_bounds__(NT)
stft_psd_kernel(const float* __restrict__ x, const Acc* __restrict__ a_re,
                const Acc* __restrict__ a_im, const Acc* __restrict__ wts,
                float* __restrict__ out, float* __restrict__ part_min,
                float* __restrict__ part_max, long long n, int R, int T,
                int F, int K, int hop, int log10_out, int with_stats) {
  __shared__ __align__(16) Acc xs[BK][BM + XPAD];
  __shared__ __align__(16) Acc ars[BK][BN];
  __shared__ __align__(16) Acc ais[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int n_freq_tiles = (F + BN - 1) / BN;
  const int row_tile = blockIdx.x / n_freq_tiles;
  const int freq_tile = blockIdx.x % n_freq_tiles;
  const int r0 = row_tile * BM;
  const int f0 = freq_tile * BN;

  // the frames this thread stages, as pointers held in registers for the
  // whole k loop, so each stage's loads issue at once; rows past R read
  // nothing
  constexpr int XS = (BM * BK) / NT;  // frame samples a thread stages
  const int xk = tid % BK;            // the sample within the stage
  const float* frame[XS];
#pragma unroll
  for (int s = 0; s < XS; ++s) {
    const int r = r0 + (tid + s * NT) / BK;
    frame[s] = r < R ? x + (long long)(r / T) * n + (long long)(r % T) * hop
                     : nullptr;
  }

  Acc acc_re[TM][TN];
  Acc acc_im[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc_re[i][j] = Acc(0);
      acc_im[i][j] = Acc(0);
    }

  for (int k0 = 0; k0 < K; k0 += BK) {
    // frames: xs[k][m] = x[frame of row r0 + m, k0 + k]; 16 neighbouring
    // threads read 16 neighbouring samples of one frame
#pragma unroll
    for (int s = 0; s < XS; ++s) {
      const int kk = k0 + xk;
      xs[xk][(tid + s * NT) / BK] =
          (frame[s] != nullptr && kk < K) ? Acc(frame[s][kk]) : Acc(0);
    }
    // matrices: ars[k][j] = A_re[k0 + k, f0 + j]
#pragma unroll
    for (int s = 0; s < (BN * BK) / NT; ++s) {
      const int idx = tid + s * NT;
      const int j = idx % BN;
      const int k = idx / BN;
      const int f = f0 + j;
      const int kk = k0 + k;
      const bool ok = f < F && kk < K;
      const long long off = (long long)kk * F + f;
      ars[k][j] = ok ? a_re[off] : Acc(0);
      ais[k][j] = ok ? a_im[off] : Acc(0);
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < BK; ++k) {
      Acc xv[TM];
      Acc cr[TN];
      Acc ci[TN];
      load_vec(&xs[k][ty * TM], xv);
      load_vec(&ars[k][tx * TN], cr);
      load_vec(&ais[k][tx * TN], ci);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc_re[i][j] = fma(xv[i], cr[j], acc_re[i][j]);
          acc_im[i][j] = fma(xv[i], ci[j], acc_im[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty * TM + i;
    float lo = INFINITY;
    float hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int f = f0 + tx * TN + j;
      if (r < R && f < F) {
        const Acc pw = power(acc_re[i][j], acc_im[i][j], wts[f]);
        const float p = static_cast<float>(pw);
        lo = nan_min(lo, p);
        hi = nan_max(hi, p);
        out[(long long)r * F + f] =
            log10_out ? static_cast<float>(log10(pw + 1e-20)) : p;
      }
    }
    if (with_stats) {
      // reduce over the 16 threads that share this row (tx = lane % 16);
      // every lane of the warp takes part, so the shuffles stay converged
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1) {
        lo = nan_min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = nan_max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
      }
      if (tx == 0 && r < R) {
        const long long p_idx = (long long)freq_tile * R + r;
        part_min[p_idx] = lo;
        part_max[p_idx] = hi;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The GEMM route's small-K tile: F <= SK_MAX_F bins (nperseg 2-31, the
// route's own configs), the function above at the same arithmetic.
//
// What bounds it: at path 10 (scipy_default 24 on 1024 clips of 10 s: K =
// 24, hop 21, F = 13, 7,800,832 rows) the bytes, 655 MB read and 406 MB
// written, 0.317 ms at 3.35 TB/s; the useful DFMA, R K 2F = 4.87 G, take
// about 0.29 ms at the 16.7 T DFMA/s outside the tensor cores. The large
// tile computes 64 bins for 13 and 32 samples for 24 there (6.6x the work),
// loads every frame of its rows by pointer, and stores 4-bin pieces of
// 13-float rows.
//
// The design: a block takes RB consecutive rows r0 ... r0 + RB - 1 (rows r =
// b T + t flattened over the clips, as above) with all their bins, so one
// (min, max) partial a row and no frequency tile:
//
// - Its frames, staged once in shared memory as float32 by cp.async, each
//   sample once: row i of the block at offset off(i) = i s + c(i) (K - s),
//   s = min(hop, K) and c(i) the clips crossed since row 0 (b - b0), so the
//   rows of one clip overlap as their frames do in the signal and a row
//   past a clip edge starts a new span (with hop > K each row is its own K
//   samples). Row i copies samples k >= K - s, all K where it starts a
//   span. The block's span fits RB K floats.
// - The (K, F) matrices once a block, as (re, im) pairs, K padded to KP, a
//   multiple of 4 (SK_K_STEP), with zero rows.
// - Threads: `groups` of 256 / groups (2 past SK_BINS bins), group g the
//   NB bins from g NB (NB = ceil(F / groups), the instantiation, so no
//   thread issues products for bins it does not hold but the last
//   group's one); thread i of a group rows i and i + 256 / groups (RB =
//   512 / groups), so a warp's lanes read one (re, im) pair a step (a
//   broadcast) and each their own rows' samples. Each output is the large
//   tile's DFMA chain, k ascending from 0 (k past K adds 0 x 0): both
//   tiles give the same float64 sums.
// - The output: power, log10_out and the NaN-propagating (min, max) as
//   store_bin, the floats staged in shared memory (rows at an odd stride,
//   FS = F | 1, over the frames' buffer once it is read), then the block's
//   rows x F floats stored as one contiguous run of (B, T, F).
constexpr int SK_THREADS = 256;
constexpr int SK_MAX_F = 16;     // the most bins the tile takes
constexpr int SK_BINS = 8;       // bins a thread at most
constexpr int SK_K_STEP = 4;     // K is padded to a multiple of this
// blocks an SM: with 8 bins a thread, three (80 registers) ran 1.194 ms at
// scipy_default 24 on 1024 clips of 10 s, two (128) 1.334, four (64, 576
// bytes spilled) 4.976 (tools/torch_kernel_variants.py small, H100, 700 W)
constexpr int SK_MIN_BLOCKS = 3;

// cp.async of one float from device to shared memory (sm_80 on)
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

template <int NB>
__global__ void __launch_bounds__(SK_THREADS, SK_MIN_BLOCKS)
stft_psd_small_kernel(const float* __restrict__ x,
                      const double* __restrict__ a_re,
                      const double* __restrict__ a_im,
                      const double* __restrict__ wts, float* __restrict__ out,
                      float* __restrict__ part_min,
                      float* __restrict__ part_max, long long n, int R,
                      int F, int K, int hop, int log10_out, int with_stats,
                      int groups, const FastDiv t_div, const FastDiv k_div,
                      const FastDiv f_div) {
  extern __shared__ __align__(16) double2 smem[];
  const int tid = threadIdx.x;
  const int tpg = SK_THREADS / groups;       // threads (and half the rows)
  const int RB = 2 * tpg;                    // a group's rows: the block's
  const int KP = (K + SK_K_STEP - 1) / SK_K_STEP * SK_K_STEP;
  const int FS = F | 1;                      // the output stage's row stride
  const int stage = RB * (K > FS ? K : FS);  // floats: frames, then output
  double2* as = smem;                        // KP x F (re, im)
  float* xs = reinterpret_cast<float*>(as + KP * F);
  int* off = reinterpret_cast<int*>(xs + stage);          // RB
  int* first = off + RB;                                  // RB
  long long* src = reinterpret_cast<long long*>(first + RB);   // RB
  float* red = reinterpret_cast<float*>(src + RB);        // 2 groups RB

  const int r0 = blockIdx.x * RB;
  const int s = hop < K ? hop : K;
  const int b0 = static_cast<int>(t_div.div(r0));
  for (int i = tid; i < RB; i += SK_THREADS) {
    const int r = r0 + i;
    const int b = static_cast<int>(t_div.div(r));
    const int t = r - b * static_cast<int>(t_div.d);
    off[i] = i * s + (b - b0) * (K - s);
    first[i] = i == 0 || t == 0 ? 0 : K - s;
    src[i] = static_cast<long long>(b) * n + static_cast<long long>(t) * hop;
  }
  for (int e = tid; e < KP * F; e += SK_THREADS) {
    const int k = e / F;
    const long long at = static_cast<long long>(k) * F + (e - k * F);
    as[e] = k < K ? make_double2(a_re[at], a_im[at]) : make_double2(0.0, 0.0);
  }
  __syncthreads();
  for (int e = tid; e < RB * K; e += SK_THREADS) {
    const int i = static_cast<int>(k_div.div(e));
    const int k = e - i * K;
    if (r0 + i < R && k >= first[i])
      cp_async_f32(xs + off[i] + k, x + src[i] + k);
  }
  cp_async_wait_all();
  __syncthreads();

  const int g = tid / tpg;
  const int ia = tid - g * tpg;
  const int f0 = g * NB;
  const int fn = F - f0 < NB ? F - f0 : NB;  // this group's bins
  const float* xa = xs + off[ia];
  const float* xb = xs + off[ia + tpg];
  double re[2][NB], im[2][NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    re[0][j] = 0.0;
    im[0][j] = 0.0;
    re[1][j] = 0.0;
    im[1][j] = 0.0;
  }
  for (int k0 = 0; k0 < KP; k0 += SK_K_STEP) {
#pragma unroll
    for (int kk = 0; kk < SK_K_STEP; ++kk) {
      const int k = k0 + kk;
      const double va = k < K ? static_cast<double>(xa[k]) : 0.0;
      const double vb = k < K ? static_cast<double>(xb[k]) : 0.0;
      const double2* ak = as + k * F + f0;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (j < fn) {
          const double2 a = ak[j];
          re[0][j] = fma(va, a.x, re[0][j]);
          im[0][j] = fma(va, a.y, im[0][j]);
          re[1][j] = fma(vb, a.x, re[1][j]);
          im[1][j] = fma(vb, a.y, im[1][j]);
        }
      }
    }
  }
  __syncthreads();                           // every row's samples read

  float* os = xs;                            // the output stage, RB x FS
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = ia + h * tpg;
    float lo = INFINITY;
    float hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (j < fn) {
        const double pw = power(re[h][j], im[h][j], wts[f0 + j]);
        const float p = static_cast<float>(pw);
        lo = nan_min(lo, p);
        hi = nan_max(hi, p);
        os[i * FS + f0 + j] =
            log10_out ? static_cast<float>(log10(pw + 1e-20)) : p;
      }
    }
    red[g * RB + i] = lo;
    red[(groups + g) * RB + i] = hi;
  }
  __syncthreads();

  const int rows = R - r0 < RB ? R - r0 : RB;
  float* dst = out + static_cast<long long>(r0) * F;
  for (int e = tid; e < rows * F; e += SK_THREADS) {
    const int i = static_cast<int>(f_div.div(e));
    dst[e] = os[i * FS + (e - i * F)];
  }
  if (with_stats) {
    for (int i = tid; i < rows; i += SK_THREADS) {
      float lo = red[i];
      float hi = red[groups * RB + i];
      for (int gg = 1; gg < groups; ++gg) {
        lo = nan_min(lo, red[gg * RB + i]);
        hi = nan_max(hi, red[(groups + gg) * RB + i]);
      }
      part_min[r0 + i] = lo;
      part_max[r0 + i] = hi;
    }
  }
}

// ---------------------------------------------------------------------------
// The FFT route: power-of-two nperseg K = 32-8192, any detrend.
//
// The real frame (row r = b*T + t, read in place by pointer) is packed
// into M = K/2 complex values, z[j] = v[2j] + i v[2j + 1], with v[i] =
// ((double)frame[i] - mean - slope (i - c)) * win[i], c = (K - 1)/2, the
// detrend line (mean, slope) being (0, 0) under detrend none, the mean
// under constant and the least-squares line under linear (frame_line's
// arithmetic); an M-point radix-2 decimation-in-time FFT of the buffer
// b[p] = z[bitrev(p)], whose stage h (h = 1, 2, ..., M/2) combines b[i0]
// and b[i0 + h] with the twiddle W_2h^k = tw[h - 1 + k], k = i0 mod h;
// then the split step and the epilogue on bins f < F: with g = min(f, K -
// f), E = (Z[g] + conj Z[M - g]) / 2 and O = -i (Z[g] - conj Z[M - g]) /
// 2 (indices mod M), X[f] = E + W_K^g O (W_K^g = tw[M - 1 + g], -1 at g =
// M); the power, log10_out and the NaN-propagating (min, max) partials,
// one per row; bins in natural order, so a frame's stores coalesce.
//
// Everything between the float32 load and the float32 store is float64;
// the window, twiddles and weights are the host's float64 numpy values,
// unrounded (tw is numpy's cos and sin of -2 pi j / K, j < K/2, laid out
// stage by stage: core/stft.py::fft_twiddles; its first M - 1 rows are
// the M-point transform's, its last M the split step's). The order of
// summation is not the GEMM route's, so the two agree to about log2(K)
// float64 roundings of the clip's largest bin, not bitwise.
// tools/torch_precision.py::psd_fft is this arithmetic in numpy.
//
// What bounds it on this card. The function reads K*4 bytes a frame
// (less with overlap) and writes F*4, and does 2.5 K log2 K operations on
// them, so it is bound by bytes: 0.586 ms on the display spine (1024 clips
// of 10 s at nperseg 1024, hop 256: 636,928 frames). A transform kept in
// shared memory is bound instead by the SM's L1/shared-memory datapath
// (128 bytes a clock): a pass over the M-point buffer for every stage
// reads and writes 32 M bytes, and a twiddle load for every butterfly
// adds 8 M, about 220 KB a frame at K = 1024 with the bit-reversed store
// and the epilogue, 4-5 ms of datapath at the display spine. The float64
// arithmetic (8 DFMA/DMUL/DADD a butterfly, 64 a clock on an SM) is about
// 1.3 ms there. With those trips cut, what is left waits on latency: the
// more warps an SM holds, the faster (PERF.md).
//
// What the design (stft_fft_psd_kernel<LOG2M, LR>, M = 2^LOG2M) does about
// it:
//
// - Stages in registers. A frame is held by P = M / 2^LR threads, 2^LR
//   values each. LR consecutive stages combine only slots that differ in
//   LR index bits, so a thread that holds the 2^LR slots of one setting of
//   the other bits runs those stages on them in registers (a pass). log2 M
//   stages take ceil(log2 M / LR) passes with one exchange through shared
//   memory between two passes: at K = 1024, three passes and two exchanges
//   against nine trips. The launcher's R2_LR picks LR by size, the faster
//   on the card: 8 values (three stages a pass, 64 registers, so an SM
//   holds twice the warps) up to K = 1024, 16 values (four stages a pass,
//   one exchange fewer, 128 registers) from 2048.
// - Pass q runs stages LR q to min(LR q + LR, log2 M) - 1 on register bits
//   s_q to s_q + LR - 1, s_q = min(LR q, log2 M - LR) (the last pass may
//   hold bits whose stages are done). In pass 0 thread u of a frame holds
//   slots 2^LR bitrev(u) + i (bitrev over log2 M - LR bits), which is
//   z[bitrev_LR(i) P + u]: for each register i the frame's threads load
//   consecutive float2 samples straight from device memory (two floats
//   where the frame is not 8-byte aligned) and consecutive double2 window
//   values. In pass q > 0 thread u holds the slots whose bits below s_q
//   are u's low s_q bits, bits s_q to s_q + LR - 1 the register, and the
//   bits above u's other bits.
// - Twiddles: a stage's butterflies in one thread share a table row where
//   their register bits below the stage's bit agree, so a pass loads 2^LR
//   - 1 rows a thread, not one a butterfly; in pass 0 all threads load the
//   same rows.
// - The exchanges: value p of frame fl lives at r2_slot(fl, p) = fl M + (p
//   XOR phi), phi = ((fl P) mod 8) XOR (p's bits from max(LR, log2 M - 3)
//   up, masked to min(P, 8) - 1). A 16-byte value fills a bank group, and
//   in every write and read of every exchange each eight neighbouring
//   lanes hit eight groups (tests/test_torch_fft_registers.py checks them
//   all). A thread writes a pass's results to the slots it read that pass,
//   so one barrier orders an exchange.
// - Frames of at most a warp (K <= 512) share a block of R2_BLOCK threads,
//   R2_BLOCK / P consecutive rows (overlapping frames of a clip, whose
//   loads share L1 lines; a ragged last block is masked), and sync with
//   __syncwarp(): no block barrier at all, the detrend sums and the row's
//   (min, max) by warp shuffles over the frame's lanes. A larger frame (K
//   = 1024-8192, 2-8 warps) takes a block of its own, syncs with
//   __syncthreads() and reduces through shared memory (block_sum,
//   row_extrema); that block's frame and row are compile-time and
//   blockIdx.x (ALONE: computed at run time instead, the kernel took 1.24x
//   as long at nperseg 1024 and 1.6-1.9x at 2048-8192 on the card). The
//   last pass writes the natural-order Z once for the epilogue
//   (r2_epilogue).
//   Registers, not the buffers, set the blocks an SM holds at every size.
// - Every butterfly computes tr = w.x b.x - w.y b.y, ti = w.x b.y + w.y b.x,
//   a + t and a - t in one function (r2_butterfly), and every bin the
//   split step's expressions of split_psd_epilogue, on the operands and
//   table rows of psd_fft, so under detrend none the PSD is the earlier
//   shared-memory design's bit for bit while nvcc contracts the products
//   alike. The detrend sums run in another order (a thread's samples, then
//   shuffles), so under constant and linear detrend the two designs agree
//   to float64 rounding.

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

// One bin f of row r, in the band: the power pw rounded once to float32
// (or its log10), folded into the row's NaN-propagating (lo, hi)
__device__ __forceinline__ void store_bin(double pw, float* __restrict__ out,
                                          long long r, Band band, int f,
                                          int log10_out, float& lo,
                                          float& hi) {
  const float p = static_cast<float>(pw);
  lo = nan_min(lo, p);
  hi = nan_max(hi, p);
  out[r * band.n + (f - band.lo)] =
      log10_out ? static_cast<float>(log10(pw + 1e-20)) : p;
}

// The row's (min, max) over the block, one partial per row; red_lo and
// red_hi hold one float per warp, and a second call in the same phase
// takes other arrays
__device__ __forceinline__ void row_extrema(float lo, float hi, float* red_lo,
                                            float* red_hi,
                                            float* __restrict__ part_min,
                                            float* __restrict__ part_max,
                                            int r) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = nan_min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = nan_max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if ((tid & 31) == 0) {
    red_lo[tid >> 5] = lo;
    red_hi[tid >> 5] = hi;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
      lo = nan_min(lo, red_lo[w]);
      hi = nan_max(hi, red_hi[w]);
    }
    part_min[r] = lo;
    part_max[r] = hi;
  }
}

// The FFT kernels' epilogue for row r, from the M-point transform Z of the
// packed frame (read through z): for bins f < F, with g = min(f, K - f),
// E = (Z[g] + conj Z[M - g]) / 2 and O = -i (Z[g] - conj Z[M - g]) / 2
// (indices mod M), X[f] = E + W_K^g O (W_K^g = split[g], -1 at g = M);
// then the power, log10_out and the NaN-propagating (min, max) of the
// row, one partial per row, over the band's bins; bins in natural order,
// so the stores of one frame coalesce. red_lo/red_hi hold one float per
// warp.
template <typename Read>
__device__ __forceinline__ void split_psd_epilogue(
    Read z, const double2* __restrict__ split,
    const double* __restrict__ wts, float* __restrict__ out,
    float* __restrict__ part_min, float* __restrict__ part_max,
    float* red_lo, float* red_hi, int r, Band band, int K, int log10_out,
    int with_stats) {
  const int M = K >> 1;
  float lo = INFINITY;
  float hi = -INFINITY;
  for (int f = band.lo + threadIdx.x; f < band.end(); f += blockDim.x) {
    const int g = f <= M ? f : K - f;
    const double2 a = z(g == M ? 0 : g);
    const double2 b = z(g == 0 ? 0 : M - g);
    const double2 w = g < M ? split[g] : make_double2(-1.0, 0.0);
    const double er = 0.5 * (a.x + b.x);
    const double ei = 0.5 * (a.y - b.y);
    const double o_r = 0.5 * (a.y + b.y);
    const double o_i = 0.5 * (b.x - a.x);
    const double xr = er + (w.x * o_r - w.y * o_i);
    const double xi = ei + (w.x * o_i + w.y * o_r);
    store_bin(power(xr, xi, wts[f]), out, r, band, f, log10_out, lo, hi);
  }
  if (with_stats)
    row_extrema(lo, hi, red_lo, red_hi, part_min, part_max, r);
}

constexpr int R2_BLOCK = 256;        // threads of a block of frames of a
                                     // warp or less
constexpr int R2_MAX_THREADS = 512;  // the largest frame's
constexpr int R2_WARPS = R2_MAX_THREADS / 32;
constexpr int R2_STATIC_SMEM = R2_WARPS * (16 + 4 + 4);  // the reductions'

// The radix-2 kernel's geometry at M = 2^LOG2M points (K = 2M), 2^LR
// values a thread: LR stages a pass, 8 values at 64 registers a thread or
// 16 at 128
template <int LOG2M, int LR>
struct R2Geometry {
  static_assert(LOG2M >= 4 && LOG2M <= 12, "nperseg 32-8192");
  static_assert((LR == 3 || LR == 4) && LOG2M > LR, "two threads a frame");
  static constexpr int M = 1 << LOG2M;
  static constexpr int P = M >> LR;                          // threads a frame
  static constexpr int FRAMES = P <= 32 ? R2_BLOCK / P : 1;  // frames a block
  static constexpr int THREADS = P * FRAMES;
  static constexpr int PASSES = (LOG2M + LR - 1) / LR;
  static constexpr int SMEM = M * FRAMES * 16;               // the buffers
  static constexpr int VALUES = 1 << LR;
  static constexpr int MIN_BLOCKS = LR == 3 ? 2 : 1;  // of R2_MAX_THREADS
};

// the low `bits` bits of i reversed
__host__ __device__ constexpr int brev_low(int i, int bits) {
  return bits == 0 ? 0 : ((i & 1) << (bits - 1)) | brev_low(i >> 1, bits - 1);
}

// the register base bit s_q of pass Q
template <int LOG2M, int LR, int Q>
__host__ __device__ constexpr int r2_base() {
  return LR * Q < LOG2M - LR ? LR * Q : LOG2M - LR;
}

// The transform slot p that thread u of a frame holds in register i
// during pass Q
template <int LOG2M, int LR, int Q>
__device__ __forceinline__ int r2_index(int u, int i) {
  if constexpr (Q == 0) {
    const int t = static_cast<int>(__brev(static_cast<unsigned>(u)) >>
                                   (32 - (LOG2M - LR)));
    return (t << LR) | i;
  } else {
    constexpr int SB = r2_base<LOG2M, LR, Q>();
    return (u & ((1 << SB) - 1)) | (i << SB) | ((u >> SB) << (SB + LR));
  }
}

// Where slot p of frame fl lives in the block's buffer: the frame's M
// values, p's low three bits XORed with bits of fl and of p's upper part
// (a bijection on each frame's values), so that each eight neighbouring
// lanes of every exchange hit eight bank groups
template <int LOG2M, int LR>
__device__ __forceinline__ int r2_slot(int fl, int p) {
  using G = R2Geometry<LOG2M, LR>;
  constexpr int SHIFT = LOG2M - 3 > LR ? LOG2M - 3 : LR;
  constexpr int MASK = (G::P < 8 ? G::P : 8) - 1;
  return fl * G::M + (p ^ (((fl * G::P) & 7) ^ ((p >> SHIFT) & MASK)));
}

// The radix-2 butterfly of psd_fft: (a, b) <- (a + w b, a - w b)
__device__ __forceinline__ void r2_butterfly(double2& a, double2& b,
                                             double2 w) {
  const double tr = w.x * b.x - w.y * b.y;
  const double ti = w.x * b.y + w.y * b.x;
  const double2 a0 = a;
  a = make_double2(a0.x + tr, a0.y + ti);
  b = make_double2(a0.x - tr, a0.y - ti);
}

// One stage on register bit J of V values: for each setting t of the
// register bits below J, one table row (row[t << SB]) for the butterflies
// that share it
template <int V, int J, int SB>
__device__ __forceinline__ void r2_stage(double2 (&v)[V],
                                         const double2* __restrict__ row) {
#pragma unroll
  for (int t = 0; t < (1 << J); ++t) {
    const double2 w = row[t << SB];
#pragma unroll
    for (int hi = 0; hi < (V >> (J + 1)); ++hi) {
      const int i = t | (hi << (J + 1));
      r2_butterfly(v[i], v[i | (1 << J)], w);
    }
  }
}

// Pass Q's stages, LR Q up to min(LR Q + LR, LOG2M) - 1, in registers:
// stage s takes the table rows 2^s - 1 + k, k = i0 mod 2^s, whose bits
// below s_q are u's (none in pass 0)
template <int LOG2M, int LR, int Q>
__device__ __forceinline__ void r2_pass(double2 (&v)[1 << LR],
                                        const double2* __restrict__ tw,
                                        int u) {
  constexpr int V = 1 << LR;
  constexpr int SB = r2_base<LOG2M, LR, Q>();
  constexpr int S0 = LR * Q;
  constexpr int S1 = S0 + LR < LOG2M ? S0 + LR : LOG2M;
  const int low = u & ((1 << SB) - 1);
  if constexpr (S0 < S1)
    r2_stage<V, S0 - SB, SB>(v, tw + ((1 << S0) - 1) + low);
  if constexpr (S0 + 1 < S1)
    r2_stage<V, S0 + 1 - SB, SB>(v, tw + ((1 << (S0 + 1)) - 1) + low);
  if constexpr (S0 + 2 < S1)
    r2_stage<V, S0 + 2 - SB, SB>(v, tw + ((1 << (S0 + 2)) - 1) + low);
  if constexpr (S0 + 3 < S1)
    r2_stage<V, S0 + 3 - SB, SB>(v, tw + ((1 << (S0 + 3)) - 1) + low);
}

template <int LOG2M, int LR, int Q>
__device__ __forceinline__ void r2_store(const double2 (&v)[1 << LR],
                                         double2* buf, int fl, int u) {
#pragma unroll
  for (int i = 0; i < (1 << LR); ++i)
    buf[r2_slot<LOG2M, LR>(fl, r2_index<LOG2M, LR, Q>(u, i))] = v[i];
}

template <int LOG2M, int LR, int Q>
__device__ __forceinline__ void r2_load(double2 (&v)[1 << LR],
                                        const double2* buf, int fl, int u) {
#pragma unroll
  for (int i = 0; i < (1 << LR); ++i)
    v[i] = buf[r2_slot<LOG2M, LR>(fl, r2_index<LOG2M, LR, Q>(u, i))];
}

// the frame's barrier: a warp's, or the block's when the frame is the block
template <int P>
__device__ __forceinline__ void r2_sync() {
  if constexpr (P <= 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// after pass Q - 1, the exchange into pass Q and its stages
template <int LOG2M, int LR, int Q>
__device__ __forceinline__ void r2_exchange_pass(double2 (&v)[1 << LR],
                                                 double2* buf,
                                                 const double2* tw, int fl,
                                                 int u) {
  r2_store<LOG2M, LR, Q - 1>(v, buf, fl, u);
  r2_sync<R2Geometry<LOG2M, LR>::P>();
  r2_load<LOG2M, LR, Q>(v, buf, fl, u);
  r2_pass<LOG2M, LR, Q>(v, tw, u);
}

// the sums of s.x and s.y over the frame's P threads, in every thread
template <int P>
__device__ __forceinline__ double2 r2_frame_sum(double2 s, double2* scratch) {
  if constexpr (P > 32) {
    return block_sum(s, scratch);                // the frame is the block
  } else {
#pragma unroll
    for (int off = P / 2; off > 0; off >>= 1) {
      s.x += __shfl_xor_sync(0xffffffffu, s.x, off);
      s.y += __shfl_xor_sync(0xffffffffu, s.y, off);
    }
    return s;
  }
}

// The epilogue of row r from its natural-order Z in the buffer: the band's
// bins lo + u, lo + u + P, ... as split_psd_epilogue computes them (the
// buffer is read after the frame's barrier, so a lane may read any
// slot, whatever the swizzle); the (min, max) partial by
// shuffles over the frame's lanes, or by row_extrema when the frame is
// the block. Rows past the last (valid false) store nothing.
template <int LOG2M, int LR>
__device__ __forceinline__ void r2_epilogue(
    const double2* buf, const double2* __restrict__ split,
    const double* __restrict__ wts, float* __restrict__ out,
    float* __restrict__ part_min, float* __restrict__ part_max,
    float* red_lo, float* red_hi, int fl, int u, int r, bool valid,
    Band band, int log10_out, int with_stats) {
  using G = R2Geometry<LOG2M, LR>;
  constexpr int M = G::M;
  constexpr int K = 2 * M;
  constexpr int P = G::P;
  float lo = INFINITY;
  float hi = -INFINITY;
  for (int f = band.lo + u; f < band.end(); f += P) {
    const int g = f <= M ? f : K - f;
    const double2 a = buf[r2_slot<LOG2M, LR>(fl, g == M ? 0 : g)];
    const double2 b = buf[r2_slot<LOG2M, LR>(fl, g == 0 ? 0 : M - g)];
    const double2 w = g < M ? split[g] : make_double2(-1.0, 0.0);
    const double er = 0.5 * (a.x + b.x);
    const double ei = 0.5 * (a.y - b.y);
    const double o_r = 0.5 * (a.y + b.y);
    const double o_i = 0.5 * (b.x - a.x);
    const double xr = er + (w.x * o_r - w.y * o_i);
    const double xi = ei + (w.x * o_i + w.y * o_r);
    if (valid)
      store_bin(power(xr, xi, wts[f]), out, r, band, f, log10_out, lo, hi);
  }
  if (!with_stats) return;
  if constexpr (P > 32) {
    row_extrema(lo, hi, red_lo, red_hi, part_min, part_max, r);
  } else {
#pragma unroll
    for (int off = P / 2; off > 0; off >>= 1) {
      lo = nan_min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = nan_max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (u == 0 && valid) {
      part_min[r] = lo;
      part_max[r] = hi;
    }
  }
}

template <int LOG2M, int LR>
__global__ void __launch_bounds__(R2_MAX_THREADS,
                                  R2Geometry<LOG2M, LR>::MIN_BLOCKS)
stft_fft_psd_kernel(const float* __restrict__ x,
                    const double* __restrict__ win,
                    const double2* __restrict__ tw,
                    const double* __restrict__ wts, float* __restrict__ out,
                    float* __restrict__ part_min, float* __restrict__ part_max,
                    long long n, int R, int T, Band band, int hop,
                    int detrend, int log10_out, int with_stats) {
  using G = R2Geometry<LOG2M, LR>;
  constexpr int V = G::VALUES;
  constexpr int K = 2 * G::M;
  constexpr int P = G::P;
  extern __shared__ double2 buf[];  // G::FRAMES frames of M values
  __shared__ double2 red_sum[R2_WARPS];
  __shared__ float red_lo[R2_WARPS];
  __shared__ float red_hi[R2_WARPS];

  // a block of one frame has no ragged edge: it is row blockIdx.x
  constexpr bool ALONE = G::FRAMES == 1;
  const int fl = ALONE ? 0 : static_cast<int>(threadIdx.x) / P;
  const int u = ALONE ? static_cast<int>(threadIdx.x)
                      : static_cast<int>(threadIdx.x) % P;
  const int r = blockIdx.x * G::FRAMES + fl;
  const bool valid = ALONE || r < R;
  const float* frame =
      x + (valid ? (long long)(r / T) * n + (long long)(r % T) * hop : 0);

  // pass 0's values straight from the frame: register i holds z[j], j =
  // bitrev(i) P + u (over LR bits), samples 2j and 2j + 1
  double2 v[V];
  const bool pairs = (reinterpret_cast<size_t>(frame) & 7) == 0;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int j = brev_low(i, LR) * P + u;
    v[i] = make_double2(0.0, 0.0);
    if (valid) {
      if (pairs) {
        const float2 s = reinterpret_cast<const float2*>(frame)[j];
        v[i] = make_double2(s.x, s.y);
      } else {
        v[i] = make_double2(frame[2 * j], frame[2 * j + 1]);
      }
    }
  }
  const double c = 0.5 * (K - 1);
  double2 line = make_double2(0.0, 0.0);
  if (detrend != DETREND_NONE) {
    double2 s = make_double2(0.0, 0.0);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int i0 = 2 * (brev_low(i, LR) * P + u);
      s.x += v[i].x;
      s.x += v[i].y;
      if (detrend == DETREND_LINEAR) {
        s.y += (i0 - c) * v[i].x;
        s.y += (i0 + 1 - c) * v[i].y;
      }
    }
    s = r2_frame_sum<P>(s, red_sum);
    const double d = K * (static_cast<double>(K) * K - 1.0) / 12.0;
    line = make_double2(s.x / K, detrend == DETREND_LINEAR ? s.y / d : 0.0);
  }
  const double2* win2 = reinterpret_cast<const double2*>(win);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int i0 = 2 * (brev_low(i, LR) * P + u);
    const double2 w = win2[i0 >> 1];
    v[i].x = (v[i].x - line.x - line.y * (i0 - c)) * w.x;
    v[i].y = (v[i].y - line.x - line.y * (i0 + 1 - c)) * w.y;
  }

  r2_pass<LOG2M, LR, 0>(v, tw, u);
  if constexpr (G::PASSES > 1)
    r2_exchange_pass<LOG2M, LR, 1>(v, buf, tw, fl, u);
  if constexpr (G::PASSES > 2)
    r2_exchange_pass<LOG2M, LR, 2>(v, buf, tw, fl, u);
  if constexpr (G::PASSES > 3)
    r2_exchange_pass<LOG2M, LR, 3>(v, buf, tw, fl, u);
  // the natural-order Z, at the slots this thread read
  r2_store<LOG2M, LR, G::PASSES - 1>(v, buf, fl, u);
  r2_sync<P>();
  r2_epilogue<LOG2M, LR>(buf, tw + (G::M - 1), wts, out, part_min,
                         part_max, red_lo, red_hi, fl, u, r, valid, band,
                         log10_out, with_stats);
}

// ---------------------------------------------------------------------------
// The mixed-radix FFT route: even nperseg K = 32-8192, any detrend, whose
// M = K/2 has no odd prime factor past 255 (every GUI value that is not a
// power of two: K = 32 m, m <= 256, so M = 2^q m' with q >= 4 and m' odd,
// m' <= 255), or is a prime p past 255 whose p - 1 has none (a Rader
// stage, which the odd kernel's template runs: see the odd route). It
// replaces the TPU kernels K1 and K2 of stft_pallas.py at those nperseg, as
// the routes above do.
//
// The transform is the host plan's (core/stft.py::fft_plan): odd prime
// radices descending, then the twos, M = p_1 p_2 ... p_S, decimation in
// time from the digit-reversed load order perm. Stage s of radix p and
// span L (the product of the radices before it) takes, for each group g
// of L*p slots and each k < L, the p values y_q at slots g*L*p + k + q*L,
// twiddles y_q (q >= 1) by W_Lp^(q k) (table row (q - 1) L + k; skipped at
// L = 1), and writes their p-point DFT back to the same slots: radix 2 as
// (y_0 + W y_1, y_0 - W y_1); an odd p in the symmetric form, with a_q =
// y_q + y_(p-q), b_q = y_q - y_(p-q) and (c, s) the root W_p^(q m mod p),
// A_m = y_0 + sum_q a_q c, B_m = sum_q b_q s (q, m = 1..(p-1)/2, q
// ascending), out[m] = A_m + i B_m, out[p - m] = A_m - i B_m. Then the
// split step and the PSD epilogue on bins f < F. Everything between the
// float32 load and the float32 store is float64, on the host's float64
// rows (numpy's cos and sin of -2 pi j / K, j reduced exactly mod K),
// unrounded. tools/torch_precision.py::psd_mixed_fft is this arithmetic in
// numpy; tests/test_torch_mixed_registers.py transcribes the kernel's
// geometry below and holds it to that model bit for bit.
//
// What bounds it. The function reads K*4 bytes a frame and writes F*4, so
// it is bound by bytes: 0.46 ms at the GUI's largest nperseg on 256 clips
// of 60 s. The first design made one shared-memory trip per stage (seven at
// 8160), a block of one frame, and a generic stage where each thread
// computed one output pair (m, p - m) and read all p inputs for it: about
// M p / 2 reads of 16 bytes a frame, 500 K at 8032 (p = 251), with the
// roots gathered at a different address in each lane. It ran at 10x its
// bound at 8160 and 35x at 8032 (PERF.md). What is left of the work: the
// generic stage's (p - 1)/2 multiply-adds for each of four sums of each
// output pair, about M p / 2 DFMA a frame (1 M at 8032, 2.1 ms of path 5
// at the 33.5 TFLOP/s of DFMA outside the tensor cores), and a trip
// through shared memory for each pass.
//
// What the design (stft_mixed_fft_psd_kernel<RMAX>, planner
// mixed_register_plan) does about it:
//
// - Passes. Each odd prime is a pass, and the a radix-2 stages are
//   ceil(a/4) passes of up to four stages (16 values) in registers, as
//   the radix-2 kernel's: 8160 (M = 2^4 17 5 3) runs four passes against
//   seven stages, 8032 (2^4 251) two. Each pass is one read and one write
//   of the buffer, in place (a thread's butterflies are its own), and one
//   barrier. Radix 3, 5 and 7 run a butterfly a thread in registers (the
//   symmetric form above), their roots staged in shared memory.
// - The generic radix (any odd prime from 11; 11-31 instantiated at
//   compile time, the rest at run time). The warps split into groups of
//   ceil((h + 1)/RM) (h = (p - 1)/2), the group's warp w computing the
//   output pairs m = RM w ... for 32 butterflies, one a lane: a lane reads
//   each input pair once, forms a_q and b_q once and feeds its RM outputs
//   from them, and the warp's lanes read one root a step (a broadcast):
//   for a compile-time prime from a table staged in the lanes' order, at
//   fixed offsets; else at an index stepped as q m mod p. The sums and
//   their order are the symmetric form's above (q ascending), so the PSD is
//   the model's. Rounds of
//   whole butterflies hold their outputs in registers across one barrier
//   before writing them; at L > 1 a twiddle pass over the buffer runs
//   first.
// - Registers. The generic lane's 4 RM float64 sums are the kernel's
//   largest state, and the compiler sizes every pass's registers by the
//   largest: with 8 pairs compiled in, plans without a generic pass ran
//   up to 1.5x slower (the 368 bytes it spills). So the kernel is
//   instantiated three times by the plan's largest radix (mix_rmax): no
//   generic code up to 7, 4 pairs a lane up to MIX_NARROW_RADIX (16 warps
//   of 4 hold the 64 pairs of 127), 8 past it (16 of 8 at 255). Each runs
//   512 threads at 128 registers, one block an SM.
// - Several frames a block: a frame takes pf threads, the least power of
//   two that loads it in MIX_LOAD sample pairs each (a warp from M = 257),
//   and a block holds MIX_THREADS / pf frames (128 at nperseg 96, two at
//   8160); every pass spreads the block's butterflies over all its
//   threads. The frame loads straight into registers, consecutive float2
//   samples across the frame's threads, its detrend sums from them
//   (shuffles within a warp, the frame's warps in order past one), then
//   into the plan's slots through perm. The epilogue takes bins g and M -
//   g together, which read the same two values of Z.
// - Bank conflicts. A value is 16 bytes, so each eight lanes of a warp
//   must hit eight bank groups (slot mod 8). Radix-2 passes take k (the
//   butterfly's offset within its span) fastest across the lanes, odd
//   passes the group: every pass's access is free of conflicts on every
//   GUI value but a radix-2 pass at a span that is no multiple of 8 (the
//   first, at the odd part m'), whose rows of butterflies straddle the
//   lanes' phases (at most three lanes a group), and the load's scatter
//   through perm (tests/test_torch_mixed_registers.py counts them). The
//   indices are not swizzled: the padded and XOR maps tried broke more
//   accesses than they mended.
// - Twiddles stay in the table in device memory, read through L1, 2^B - 1
//   rows a radix-2 butterfly, not one a stage. Staging them in shared
//   memory does not fit: the plan's rows (65 KB at 8160) are as large as
//   the frame's buffer.

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

template <int RMAX>
__global__ void __launch_bounds__(MIX_THREADS, 1)
stft_mixed_fft_psd_kernel(const float* __restrict__ x,
                          const double* __restrict__ win,
                          const int* __restrict__ perm,
                          const double2* __restrict__ tw,
                          const double* __restrict__ wts,
                          float* __restrict__ out,
                          float* __restrict__ part_min,
                          float* __restrict__ part_max, long long n, int R,
                          int T, Band band, int K, int hop, int detrend,
                          int log10_out, int with_stats,
                          const __grid_constant__ MixRegPlan plan) {
  extern __shared__ double2 buf[];  // plan.frames frames of K/2 values
  __shared__ double2 roots[MIX_MAX_RADIX + 1];
  __shared__ double2 odd_roots[MIX_MAX_PASSES][8];  // radix 3, 5, 7
  __shared__ double2 red_sum[MIX_THREADS / 32];
  __shared__ float red_lo[MIX_THREADS / 32];
  __shared__ float red_hi[MIX_THREADS / 32];

  const int M = K >> 1;
  const int pf = plan.pf;
  const int tid = threadIdx.x;
  const int fl = tid / pf;
  const int u = tid - fl * pf;
  const int r = blockIdx.x * plan.frames + fl;
  const bool valid = r < R;
  const float* frame =
      x + (valid ? (long long)(r / T) * n + (long long)(r % T) * hop : 0);
  double2* fbuf = buf + fl * M;

  // the radix 3, 5 and 7 passes' roots, ordered by the first barrier
  if (tid < MIX_MAX_PASSES * 8) {
    const int q = tid >> 3;
    const int i = tid & 7;
    if (q < plan.n_passes && plan.pass[q].radix <= 7 &&
        plan.pass[q].radix % 2 && i < plan.pass[q].radix)
      odd_roots[q][i] = tw[plan.pass[q].root + i];
  }

  // the frame's sample pairs j = u + i pf straight from device memory,
  // consecutive across the frame's threads
  float2 s[MIX_LOAD];
  const bool pairs = (reinterpret_cast<size_t>(frame) & 7) == 0;
#pragma unroll
  for (int i = 0; i < MIX_LOAD; ++i) {
    const int j = u + i * pf;
    s[i] = make_float2(0.0f, 0.0f);
    if (valid && j < M)
      s[i] = pairs ? reinterpret_cast<const float2*>(frame)[j]
                   : make_float2(frame[2 * j], frame[2 * j + 1]);
  }
  const double c = 0.5 * (K - 1);
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
    const double d = K * (static_cast<double>(K) * K - 1.0) / 12.0;
    line = make_double2(a.x / K, detrend == DETREND_LINEAR ? a.y / d : 0.0);
  }
  const double2* win2 = reinterpret_cast<const double2*>(win);
#pragma unroll
  for (int i = 0; i < MIX_LOAD; ++i) {
    const int j = u + i * pf;
    if (j < M) {
      const double2 w = win2[j];
      const int i0 = 2 * j;
      fbuf[perm[j]] = make_double2(
          (static_cast<double>(s[i].x) - line.x - line.y * (i0 - c)) * w.x,
          (static_cast<double>(s[i].y) - line.x - line.y * (i0 + 1 - c)) *
              w.y);
    }
  }
  __syncthreads();

  for (int q = 0; q < plan.n_passes; ++q) {
    const MixPass& ps = plan.pass[q];
    const int nbt = plan.frames * static_cast<int>(ps.nb.d);
    switch (ps.radix) {
      case 2: mix_r2_pass<1>(buf, tw, ps, M, nbt); break;
      case 4: mix_r2_pass<2>(buf, tw, ps, M, nbt); break;
      case 8: mix_r2_pass<3>(buf, tw, ps, M, nbt); break;
      case 16: mix_r2_pass<4>(buf, tw, ps, M, nbt); break;
      case 3: mix_odd_pass<3>(buf, odd_roots[q], tw, ps, M, nbt); break;
      case 5: mix_odd_pass<5>(buf, odd_roots[q], tw, ps, M, nbt); break;
      case 7: mix_odd_pass<7>(buf, odd_roots[q], tw, ps, M, nbt); break;
      default:
        if constexpr (RMAX > 0) {
          const int fr = plan.frames;
          switch (ps.radix) {
            case 11:
              mix_generic_pass<11, RMAX>(buf, roots, tw, ps, M, fr, nbt);
              break;
            case 13:
              mix_generic_pass<13, RMAX>(buf, roots, tw, ps, M, fr, nbt);
              break;
            case 17:
              mix_generic_pass<17, RMAX>(buf, roots, tw, ps, M, fr, nbt);
              break;
            case 19:
              mix_generic_pass<19, RMAX>(buf, roots, tw, ps, M, fr, nbt);
              break;
            case 23:
              mix_generic_pass<23, RMAX>(buf, roots, tw, ps, M, fr, nbt);
              break;
            case 29:
              mix_generic_pass<29, RMAX>(buf, roots, tw, ps, M, fr, nbt);
              break;
            case 31:
              mix_generic_pass<31, RMAX>(buf, roots, tw, ps, M, fr, nbt);
              break;
            default:
              mix_generic_pass<0, RMAX>(buf, roots, tw, ps, M, fr, nbt);
          }
        }
    }
    __syncthreads();
  }

  // the split step and the PSD epilogue of row r: bins g and M - g from
  // Z[g] and Z[M - g] together, g = u, u + pf, ... up to M/2, each stored
  // where it lies in the band; past M (two sided) bin f as bin K - f
  const double2* split = tw + plan.split;
  float lo = INFINITY;
  float hi = -INFINITY;
  // bin f from a = Z[g], b = Z[M - g], w = W_K^g and its weight, as
  // split_psd_epilogue
  const auto bin = [&](int f, double2 a, double2 b, double2 w, double wt) {
    const double er = 0.5 * (a.x + b.x);
    const double ei = 0.5 * (a.y - b.y);
    const double o_r = 0.5 * (a.y + b.y);
    const double o_i = 0.5 * (b.x - a.x);
    const double xr = er + (w.x * o_r - w.y * o_i);
    const double xi = ei + (w.x * o_i + w.y * o_r);
    if (valid)
      store_bin(power(xr, xi, wt), out, r, band, f, log10_out, lo, hi);
  };
#pragma unroll 2
  for (int g = u; 2 * g <= M; g += pf) {
    const double2 a = fbuf[g];
    const double2 b = fbuf[g == 0 ? 0 : M - g];
    if (band.has(g))
      bin(g, a, b, g < M ? split[g] : make_double2(-1.0, 0.0), wts[g]);
    const int f = M - g;                     // Z[f] is b, Z[M - f] is a
    if (f > g && band.has(f))
      bin(f, b, a, f < M ? split[f] : make_double2(-1.0, 0.0), wts[f]);
  }
  for (int f = (band.lo > M ? band.lo : M + 1) + u; f < band.end();
       f += pf) {
    const int g = K - f;
    bin(f, fbuf[g], fbuf[M - g], split[g], wts[f]);
  }
  if (!with_stats) return;
  const int lanes = pf < 32 ? pf : 32;
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    lo = nan_min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = nan_max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (pf > 32) {
    const int warp = tid >> 5;
    if ((tid & 31) == 0) {
      red_lo[warp] = lo;
      red_hi[warp] = hi;
    }
    __syncthreads();
    for (int w = warp + 1; u == 0 && w < warp + (pf >> 5); ++w) {
      lo = nan_min(lo, red_lo[w]);
      hi = nan_max(hi, red_hi[w]);
    }
  }
  if (u == 0 && valid) {
    part_min[r] = lo;
    part_max[r] = hi;
  }
}

// ---------------------------------------------------------------------------
// The pass engine of the odd and Bluestein kernels (conv_*), which also
// runs the mixed route's Rader plans. A block holds one transform of N
// points (two odd frames, a packed even frame, or one rank's half of a
// Bluestein convolution) and runs the host plan's stages
// grouped into the mixed kernel's passes (group_passes): each odd prime a
// pass, the twos up to four a pass in registers. A Rader or Bluestein
// convolution runs them in both directions: the passes in frequency (the
// plan's stages in reverse order, each transposed: a butterfly's p-point
// DFT first, the twiddles on its outputs: the arithmetic and order of
// tools/torch_precision.py::_stages(dif=True)), each slot's
// product, then the passes in time. tests/test_torch_conv_registers.py
// transcribes this geometry and holds it to the numpy models bit for bit.
//
// What bounds it. The function is bound by bytes, 0.46 ms on paths 7-9
// (PERF.md). Stages run one at a time make one trip through shared memory
// and one barrier a stage, reload an odd stage's roots behind a barrier of
// its own, and read all p inputs of a generic butterfly for each of its (p
// + 1)/2 output pairs: 27 trips a frame at path 9 (M = 8192), 13 in each
// direction. What is left is a trip a pass, the generic passes'
// DFMA and latency: at these sizes a block holds one transform, and its
// buffer (up to 225 KB) keeps one block on an SM.
//
// What the design does about it:
//
// - Passes in both directions (conv_pass): the mixed kernel's pass code,
//   mix_r2_pass, mix_odd_pass and mix_generic_pass, each with a DIF form.
//   Path 9 makes 7 trips for 27; path 7 (P = 8190: 13, 7, 5, 3, 3, 2) 13
//   for 13, but the generic 13 reads each input once, and no pass reloads
//   its roots behind a barrier.
// - The turn-around fused (conv_turn_r2, conv_turn_odd). The last pass in
//   frequency and the first in time are the plan's first stage, at span 1:
//   whole butterflies on contiguous slots. Where that pass is radix 2^B, 3,
//   5 or 7, one thread runs it in frequency, the product and it in time in
//   registers: two trips and a barrier fewer. A generic first stage keeps
//   the trip.
// - Roots: the plan's radix 3, 5 and 7 roots are staged once
//   (conv_stage_roots; a radix's roots are the same rows in every pass of a
//   plan), a generic pass's as the mixed kernel stages them.
// - Bank conflicts. A power-of-two N (61 Bluestein lengths, paths 8 and 9;
//   the Rader stage at nperseg 257) runs radix-2 passes only, and the
//   first, at span 1, gives each lane 2^B contiguous slots, so every lane
//   of a phase would hit one bank group. There slot s lives at s XOR ((s >>
//   B0) & 7), B0 = log2 of pass 0's radix (SlotMap), which keeps each eight
//   aligned slots together and puts the eight lanes of every phase of every
//   pass, load, product and epilogue on eight groups. Other lengths keep
//   plain slots (mask 0): their radix-2 passes start at the odd part's
//   span, and their odd and generic passes never see a mask. Every pass
//   takes k fastest across the lanes (conv_plan), the model's butterfly
//   order, a few lanes a group where a span is below 8
//   (tests/test_torch_conv_registers.py counts them).
// - Instantiated by the largest radix (mix_rmax), as the mixed kernel:
//   Bluestein's M has radices 2-7 and carries no generic code, and runs
//   two blocks an SM at 64 registers where two buffers fit
//   (BLUE_TWO_BLOCK_POINTS); the odd
//   kernel, with and without a Rader stage and on the mixed route's Rader
//   plans, takes 0, 4 or 8 output pairs a generic lane, or 1: generic
//   passes narrow, a thread an output pair, where a pass has at most 16
//   butterflies or
//   the transform is small enough for two blocks an SM (ODD_NARROW_POINTS,
//   RADER_NARROW_POINTS); the narrow plans, and without a Rader stage
//   those of radix 3, 5 and 7 passes only, run two blocks an SM at 64
//   registers (ODD_SMALL_BLOCKS). Registers, not the work, set these: a small
//   block at 128 registers leaves an SM few warps (nperseg 481 took 9.7 ms
//   so against the stages run one at a time's 7.2).

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

// The odd kernels' epilogue: the bins of row r0 from a lone frame's
// transform z, X[f] = Z[f], or of rows r0 and r0 + 1 from a pair's, A[f] =
// (Z[f] + conj Z[K - f]) / 2 and B[f] = (Z[f] - conj Z[K - f]) / 2i, for
// the band's bins f; the power, log10_out and each row's (min, max)
template <typename Read>
__device__ __forceinline__ void pair_psd_epilogue(
    Read z, int r0, bool pair, int K, Band band,
    const double* __restrict__ wts,
    float* __restrict__ out, float* __restrict__ part_min,
    float* __restrict__ part_max, float (*red_lo)[FFT_MAX_WARPS],
    float (*red_hi)[FFT_MAX_WARPS], int log10_out, int with_stats) {
  float lo[2] = {INFINITY, INFINITY};
  float hi[2] = {-INFINITY, -INFINITY};
  for (int f = band.lo + threadIdx.x; f < band.end(); f += blockDim.x) {
    const double2 a = z(f);
    if (pair) {
      const double2 b = z(f == 0 ? 0 : K - f);
      store_bin(power(0.5 * (a.x + b.x), 0.5 * (a.y - b.y), wts[f]), out, r0,
                band, f, log10_out, lo[0], hi[0]);
      store_bin(power(0.5 * (a.y + b.y), 0.5 * (b.x - a.x), wts[f]), out,
                r0 + 1, band, f, log10_out, lo[1], hi[1]);
    } else {
      store_bin(power(a.x, a.y, wts[f]), out, r0, band, f, log10_out, lo[0],
                hi[0]);
    }
  }
  if (with_stats) {
    row_extrema(lo[0], hi[0], red_lo[0], red_hi[0], part_min, part_max, r0);
    if (pair)
      row_extrema(lo[1], hi[1], red_lo[1], red_hi[1], part_min, part_max,
                  r0 + 1);
  }
}

// ---------------------------------------------------------------------------
// The odd route: odd nperseg K = 33-8191 whose transform the mixed plan
// takes (every prime of K at most 255, or K itself a prime whose K - 1
// has none past 255: a Rader stage), any detrend.
//
// No two samples of one odd frame pack into a complex value, so the
// kernel packs two frames: block j of clip b takes frames t = 2j and
// t + 1 of that clip (a clip with odd T leaves its last frame alone). Both
// frames' detrend lines by block reduction (frame_line); z[i] = v_a[i] +
// i v_b[i], v = ((double)frame[i] - mean - slope (i - c)) * win[i], at
// slot perm[i]; the K-point transform on the pass engine above: the plan's
// passes in time (conv_forward), or with a Rader stage (slot q holds
// x[g^q], slot P = K - 1 holds x[0]) the P-point convolution
// (conv_transform: the passes in frequency, X[0] = x[0] + slot 0 and each
// slot times its row of b^, the passes in time) and X[i] = x[0] + slot
// perm[i] (ConvRaderRead); then, with Z the transform, the two frames' bins
//
//   A[f] = (Z[f] + conj Z[K - f]) / 2,  B[f] = (Z[f] - conj Z[K - f]) / 2i
//
// (indices mod K) and the PSD epilogue of both rows (pair_psd_epilogue).
//
// Packing couples the frames: a pair's transform rounds at the scale of
// the louder frame, so a quiet frame beside a loud one would take the
// loud one's rounding (about (eps |A|)^2 in its bins, where the plain
// version of an all-zero frame gives exact zeros), and a NaN would spread
// to both. The load's block reduction sums each frame's energy (v^2), and
// a pair shares a transform only if both sums are finite and positive and
// within PAIR_MAX_RATIO of each other; else each frame is transformed
// alone, z = v + 0i, X[f] = Z[f]. So a frame's bins never depend on a
// frame that is not finite, is all zero or is 48 dB louder.
//
// What bounds it: the function is bound by bytes (0.46 ms at path 7); the
// design by latency and the generic passes' DFMA, as the mixed kernel; a
// Rader stage runs two (K - 1)-point transforms for one K-point transform.
// The buffer holds K complex float64 values, 131 KB at K = 8191, so one
// block fits an SM there; packing two frames per transform halves the
// transforms, as packing two samples does on even K.
// tools/torch_precision.py::psd_odd_fft is this arithmetic in numpy.

// PACKED (with RADER): the mixed route's Rader plans, even K whose M = K/2
// is a prime past 255 with a 255-smooth M - 1 (405 values, 514-8186; the
// mixed-radix launcher runs them). Block r takes row r alone: the frame's
// line, even samples in .x and odd in .y of slot perm[i / 2] (slot P = M -
// 1 holds x[0]), the P-point Rader convolution as above, X[i] = x[0] +
// slot perm[i] (ConvRaderRead) and the even kernels' split step and PSD
// epilogue (split_psd_epilogue); plan and pass engine the odd frames'.

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

template <bool RADER, int RMAX, bool PACKED = false>
__global__ void __launch_bounds__(FFT_MAX_THREADS,
                                  odd_min_blocks(RADER, RMAX, PACKED))
stft_odd_fft_psd_kernel(const float* __restrict__ x,
                        const double* __restrict__ win,
                        const int* __restrict__ perm,
                        const double2* __restrict__ tw,
                        const double* __restrict__ wts,
                        float* __restrict__ out, float* __restrict__ part_min,
                        float* __restrict__ part_max, long long n, int T,
                        Band band, int K, int hop, int detrend,
                        int log10_out, int with_stats, int pack,
                        const __grid_constant__ ConvPlan plan) {
  extern __shared__ double2 buf[];  // K complex values
  __shared__ double2 roots[RMAX > 0 ? MIX_MAX_RADIX + 1 : 1];
  __shared__ double2 small[SMALL_ROOTS];
  __shared__ double2 red_sum[3][FFT_MAX_WARPS];
  __shared__ float red_lo[2][FFT_MAX_WARPS];
  __shared__ float red_hi[2][FFT_MAX_WARPS];
  __shared__ double2 x_sum;         // X[0] under a Rader stage

  conv_stage_roots(small, tw, plan);
  const SlotMap map{plan.swz_mask, plan.swz_shift};
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const double c = 0.5 * (K - 1);
  if constexpr (PACKED) {
    static_assert(RADER, "a packed frame's plan has a Rader stage");
    const int r = blockIdx.x;
    const float* frame =
        x + (long long)(r / T) * n + (long long)(r % T) * hop;
    const double2 line = frame_line(frame, K, detrend, red_sum[0]);
    double* bufd = reinterpret_cast<double*>(buf);
    for (int i = tid; i < K; i += nt)
      bufd[2 * map(perm[i >> 1]) + (i & 1)] =
          (static_cast<double>(frame[i]) - line.x - line.y * (i - c)) *
          win[i];
    __syncthreads();
    const int P = (K >> 1) - 1;
    conv_transform<RMAX>(buf, roots, small, tw, plan, P,
                         RaderProduct{tw + plan.rader, buf + map(P),
                                      &x_sum});
    split_psd_epilogue(ConvRaderRead{buf, perm, &x_sum, P, map},
                       tw + plan.split, wts, out, part_min, part_max,
                       red_lo[0], red_hi[0], r, band, K, log10_out,
                       with_stats);
    return;
  }
  const int pairs = (T + 1) >> 1;
  const int clip = blockIdx.x / pairs;
  const int t = (blockIdx.x - clip * pairs) * 2;
  const int ra = clip * T + t;
  const bool has_b = t + 1 < T;
  const float* fa = x + (long long)clip * n + (long long)t * hop;
  const float* fb = fa + hop;
  const double2 la = frame_line(fa, K, detrend, red_sum[0]);
  const double2 lb = has_b ? frame_line(fb, K, detrend, red_sum[1])
                           : make_double2(0.0, 0.0);

  double2 e = make_double2(0.0, 0.0);
  for (int i = tid; i < K; i += nt) {
    const double va =
        (static_cast<double>(fa[i]) - la.x - la.y * (i - c)) * win[i];
    const double vb =
        has_b ? (static_cast<double>(fb[i]) - lb.x - lb.y * (i - c)) * win[i]
              : 0.0;
    buf[map(perm[i])] = make_double2(va, vb);
    e.x += va * va;
    e.y += vb * vb;
  }
  e = block_sum(e, red_sum[2]);     // also the loads' barrier
  const bool paired = pack && has_b && isfinite(e.x) && isfinite(e.y) &&
                      e.x > 0.0 && e.y > 0.0 &&
                      fmax(e.x, e.y) <= PAIR_MAX_RATIO * fmin(e.x, e.y);

  // the pair's transform, or each frame alone (a with its partner's part
  // zeroed, then b), from one place in the code
  const int units = paired || !has_b ? 1 : 2;
  for (int u = 0; u < units; ++u) {
    if (!paired) {
      if (u == 0) {
        for (int s = tid; s < K; s += nt) buf[s].y = 0.0;
      } else {
        __syncthreads();            // the epilogue's reads before the loads
        for (int i = tid; i < K; i += nt)
          buf[map(perm[i])] = make_double2(
              (static_cast<double>(fb[i]) - lb.x - lb.y * (i - c)) * win[i],
              0.0);
      }
      __syncthreads();
    }
    if constexpr (RADER) {
      const int P = K - 1;
      conv_transform<RMAX>(buf, roots, small, tw, plan, P,
                           RaderProduct{tw + plan.rader, buf + map(P),
                                        &x_sum});
      pair_psd_epilogue(ConvRaderRead{buf, perm, &x_sum, P, map}, ra + u,
                        paired, K, band, wts, out, part_min, part_max, red_lo,
                        red_hi, log10_out, with_stats);
    } else {
      conv_forward<RMAX>(buf, roots, small, tw, plan, K, 0);
      pair_psd_epilogue(ConvRead{buf, map}, ra + u, paired, K, band, wts,
                        out, part_min, part_max, red_lo, red_hi, log10_out,
                        with_stats);
    }
  }
}

// ---------------------------------------------------------------------------
// The Bluestein route: every nperseg K = 32-8192 that the routes above do
// not take (a transform length N, K/2 or an odd K, with a prime past 255
// beside other factors, or a prime p past 255 whose p - 1 has one; 2049,
// 8182, 8185), any detrend.
//
// Bluestein's identity n k = (n^2 + k^2 - (k - n)^2) / 2 turns the N-point
// DFT into a cyclic convolution of any length M >= 2N - 1, taken M = 2^a
// 3^b 5^c 7^d (core/stft.py::bluestein_plan):
//
//   X[k] = w_k y_k,  y = a (*) b,  a_n = x_n w_n (n < N, zero to M),
//   w_n = exp(-i pi n^2 / N),  b the M-periodic conj(w).
//
// In shared memory: a in slots 0..N-1 and zeros to M; the convolution on
// the pass engine above (conv_transform): M's passes in frequency (natural
// order in, digit-reversed out), each slot s <- conj(b^_s s), b^ the
// host's DFT of b times 1/M in slot order, the passes in time
// (digit-reversed in, natural out). The conjugation turns the forward
// passes into the inverse transform read conjugated, so slot k holds
// conj(y_k) and X[k] = w_k conj(slot k) (BluesteinRead), with every output
// in slots 0..N-1. The structure is the Rader stage's: the chirp takes the
// place of the generator permutation and the zero padding that of the N -
// 1 slots.
//
// Even K: one frame per block, two real samples packed a complex value
// (z[m] = v[2m] + i v[2m + 1], N = K/2, M <= 8192), the split step and
// epilogue of the other even kernels (split_psd_epilogue). Odd K: two
// frames of a clip a transform (N = K), with the odd kernel's guard on
// their energies and its pair epilogue (pair_psd_epilogue).
//
// What bounds it: the function is bound by bytes, as on every FFT route
// (0.46 ms on paths 8 and 9); the design by latency, as the mixed kernel:
// 2 M log2 M butterfly values for an N-point transform, 2-4x the mixed
// kernel's at the same N, in passes of up to four radix-2 stages. The
// buffer holds M complex float64 values. Past BLUE_MAX_BLOCK_POINTS (14406
// values, 225 KB; odd K from 7207, M up to 16384, 256 KB) no block holds
// it, so a cluster of two blocks on neighbouring SMs holds M/2 slots each,
// rank 0 the first half, and reads the other's shared memory where a stage
// crosses the halves. M is then even and the plan's last stage is radix 2
// at span M/2 (core/stft.py::bluestein_length), and since N <= M/2 every
// input and every output read lies in rank 0's half: the first stage in
// frequency leaves rank 0's slots as they are (their partners are zeros)
// and gives rank 1 W^j a_j from rank 0's slot j; the last in time gives
// rank 0 a_j + W^j b_j from rank 1's slot j, for j < N; every other stage's
// passes, and the product, run on each half alone (M/2 = 8192 at path 8,
// path 9's passes). Both ranks compute the frames' lines and energies;
// rank 0 loads and stores. The alternative, a global-memory scratch kept
// in L2, would put every pass's traffic through L2 instead of shared
// memory; the cluster keeps it on chip and spreads the butterflies over two
// SMs. tools/torch_precision.py::psd_bluestein is this arithmetic in numpy,
// with the halves modelled as the cluster indexes them.

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
constexpr int BLUE_STATIC_SMEM =
    SMALL_ROOTS * 16 + 3 * FFT_MAX_WARPS * 16 + 4 * FFT_MAX_WARPS * 4;
constexpr int BLUE_MAX_BLOCK_POINTS = 14406;
static_assert(BLUE_MAX_BLOCK_POINTS * 16 + BLUE_STATIC_SMEM <= BLOCK_SMEM,
              "the one-block buffer fits");

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

// One block (RANKS = 1) or cluster (RANKS = 2) per unit: a frame of even
// K, row blockIdx.x; or for odd K frames t = 2j and t + 1 of clip b, unit
// b ceil(T / 2) + j. Even K runs on one block only. TWO: two blocks an SM
// (M up to BLUE_TWO_BLOCK_POINTS).
template <int RANKS, bool TWO>
__global__ void __launch_bounds__(FFT_MAX_THREADS,
                                  TWO ? 2 : BLUE_MIN_BLOCKS)
stft_bluestein_psd_kernel(const float* __restrict__ x,
                          const double* __restrict__ win,
                          const double2* __restrict__ tw,
                          const double* __restrict__ wts,
                          float* __restrict__ out,
                          float* __restrict__ part_min,
                          float* __restrict__ part_max, long long n, int T,
                          Band band, int K, int hop, int detrend,
                          int log10_out, int with_stats, int M, int bhat,
                          int chirp_row, int half_row,
                          const __grid_constant__ ConvPlan plan) {
  extern __shared__ double2 buf[];  // M / RANKS complex values
  __shared__ double2 small[SMALL_ROOTS];
  __shared__ double2 red_sum[3][FFT_MAX_WARPS];
  __shared__ float red_lo[2][FFT_MAX_WARPS];
  __shared__ float red_hi[2][FFT_MAX_WARPS];

  conv_stage_roots(small, tw, plan);
  const SlotMap map{plan.swz_mask, plan.swz_shift};
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int unit = blockIdx.x / RANKS;
  const int H = M / RANKS;
  const double2* chirp = tw + chirp_row;
  const double c = 0.5 * (K - 1);
  bool loads = true;                // rank 0 loads, transforms and stores
  if constexpr (RANKS == 2) loads = cg::this_cluster().block_rank() == 0;

  // even K: frame t of clip b, two samples a value (N = K/2); odd K: its
  // frames t = 2j and t + 1 (N = K)
  const bool even = RANKS == 1 && K % 2 == 0;
  const int N = even ? K >> 1 : K;
  const int pairs = (T + 1) >> 1;
  const int clip = even ? unit / T : unit / pairs;
  const int t = even ? unit - clip * T : (unit - clip * pairs) * 2;
  const int ra = clip * T + t;
  const bool has_b = !even && t + 1 < T;
  const float* fa = x + (long long)clip * n + (long long)t * hop;
  const float* fb = fa + hop;
  const double2 la = frame_line(fa, K, detrend, red_sum[0]);
  const double2 lb = has_b ? frame_line(fb, K, detrend, red_sum[1])
                           : make_double2(0.0, 0.0);
  const auto sample = [&](const float* f, double2 line, int i) {
    return (static_cast<double>(f[i]) - line.x - line.y * (i - c)) * win[i];
  };

  // the load, z_m = (v[2m] + i v[2m + 1]) w_m for even K, z_i = (v_a[i] +
  // i v_b[i]) w_i and both energies for a pair of odd frames
  double2 e = make_double2(0.0, 0.0);
  for (int i = tid; i < H; i += nt) {
    double2 z = make_double2(0.0, 0.0);
    if (i < N) {
      const double va = sample(fa, la, even ? 2 * i : i);
      const double vb = even    ? sample(fa, la, 2 * i + 1)
                        : has_b ? sample(fb, lb, i)
                                : 0.0;
      z = cmul(chirp[i], make_double2(va, vb));
      e.x += va * va;
      e.y += vb * vb;
    }
    if (loads) buf[map(i)] = z;
  }
  if (!even)
    e = block_sum(e, red_sum[2]);   // also orders the loads before reloads
  const bool paired = even || (has_b && isfinite(e.x) && isfinite(e.y) &&
                               e.x > 0.0 && e.y > 0.0 &&
                               fmax(e.x, e.y) <=
                                   PAIR_MAX_RATIO * fmin(e.x, e.y));
  // the transform, or each odd frame alone, z_i = v[i] w_i (a, then b),
  // from one place in the code
  const int units = paired || !has_b ? 1 : 2;
  for (int u = 0; u < units; ++u) {
    if (!paired) {
      if (u == 1) __syncthreads();  // the epilogue's reads before the loads
      for (int i = tid; loads && i < H; i += nt)
        buf[map(i)] = i < K ? cmul(chirp[i],
                                   make_double2(u ? sample(fb, lb, i)
                                                  : sample(fa, la, i),
                                                0.0))
                            : make_double2(0.0, 0.0);
    }
    bluestein_transform<RANKS>(buf, small, tw, plan, M, N, bhat, half_row);
    if (!loads) continue;
    if (even)
      split_psd_epilogue(BluesteinRead{buf, chirp, map}, tw + plan.split,
                         wts, out, part_min, part_max, red_lo[0], red_hi[0],
                         ra, band, K, log10_out, with_stats);
    else
      pair_psd_epilogue(BluesteinRead{buf, chirp, map}, ra + u, paired, K,
                        band, wts, out, part_min, part_max, red_lo, red_hi,
                        log10_out, with_stats);
  }
}

constexpr int FFT_MAX_DEVICES = 64;
// the dynamic shared memory limit already set for the FFT kernels, per
// device (the radix-2 kernel's per LOG2M)
size_t r2_smem_set[13][FFT_MAX_DEVICES] = {};
// (the mixed-radix kernel's three instantiations)
size_t mixed_smem_set[3][FFT_MAX_DEVICES] = {};
// (the odd kernel's eight: without a Rader stage and with, by conv_plan's
// rmax 0, 1, 4 or 8; then its two on the mixed route's Rader plans,
// PACKED, rmax 0 or 1)
size_t odd_smem_set[10][FFT_MAX_DEVICES] = {};
// (the Bluestein kernel's: on one block, at two blocks an SM, and on a
// cluster of two)
size_t blue_smem_set[3][FFT_MAX_DEVICES] = {};
// (the GEMM route's small-K tile, by its bins a thread)
size_t small_smem_set[SK_BINS][FFT_MAX_DEVICES] = {};

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

// log2 of the values a thread of the radix-2 kernel holds at M = 2^LOG2M:
// 8 (three stages a pass, 64 registers, twice the warps) up to nperseg
// 1024, 16 (four stages a pass) from 2048, the faster on the card at each
// size (tools/torch_kernel_variants.py r2; tests/test_torch_fft_registers.py
// pins it)
constexpr int R2_LR[13] = {0, 0, 0, 0, 3, 3, 3, 3, 3, 3, 4, 4, 4};

// The radix-2 kernel at M = 2^LOG2M (R2Geometry): R rows in blocks of
// FRAMES rows, the last block masked
template <int LOG2M>
int r2_launch(const float* x, const double* win, const double* tw,
              const double* wts, float* out, float* part_min,
              float* part_max, int R, long long n, int T, Band band, int hop,
              int detrend, int log10_out, int with_stats, cudaStream_t s) {
  constexpr int LR = R2_LR[LOG2M];
  using G = R2Geometry<LOG2M, LR>;
  static_assert(G::SMEM + R2_STATIC_SMEM <= BLOCK_SMEM,
                "the radix-2 kernel's buffers fit a block");
  static_assert(G::THREADS <= R2_MAX_THREADS && G::THREADS % 32 == 0,
                "whole warps, at most R2_MAX_THREADS threads");
  const int err = raise_smem(stft_fft_psd_kernel<LOG2M, LR>, G::SMEM,
                             r2_smem_set[LOG2M]);
  if (err != 0) return err;
  const unsigned blocks =
      static_cast<unsigned>((R + G::FRAMES - 1) / G::FRAMES);
  stft_fft_psd_kernel<LOG2M, LR><<<blocks, G::THREADS, G::SMEM, s>>>(
      x, win, reinterpret_cast<const double2*>(tw), wts, out, part_min,
      part_max, n, R, T, band, hop, detrend, log10_out, with_stats);
  return static_cast<int>(cudaGetLastError());
}

// The band [f_lo, f_lo + F) of a K-point transform's bins, or false when
// it is empty or lies past them
bool band_ok(int f_lo, int F, int K) {
  return f_lo >= 0 && F >= 1 && f_lo + F <= K;
}

}  // namespace

extern "C" {

// Number of frequency tiles: the (min, max) partials are
// (stft_psd_freq_tiles(F), B * T) each.
int stft_psd_freq_tiles(int F) { return (F + BN - 1) / BN; }

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// x is (B, n) contiguous f32; a_re/a_im are (K, F) contiguous f64 and wts
// is (F,) f64; out is (B, T, F) f32; part_min/part_max are
// (stft_psd_freq_tiles(F), B * T) f32 and may be null when with_stats is
// 0. F <= SK_MAX_F (nperseg 2-31) runs the small-K tile, which refuses K
// past 31 or T < 1 with cudaErrorInvalidValue; else the 128 x 64 tile.
// The caller keeps B * T and the number of blocks, row tiles times
// frequency tiles, within the grid's limits.
int stft_psd_launch(const float* x, const double* a_re, const double* a_im,
                    const double* wts, float* out, float* part_min,
                    float* part_max, int B, long long n, int T, int F, int K,
                    int hop, int log10_out, int with_stats, void* stream) {
  const int R = B * T;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F <= SK_MAX_F && K < 2 * SK_MAX_F) {
    if (K < 1 || T < 1 || hop < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    const int groups = F > SK_BINS ? 2 : 1;
    const int nb = (F + groups - 1) / groups;   // NB, 1 to SK_BINS
    const int rb = 2 * SK_THREADS / groups;
    const int kp = (K + SK_K_STEP - 1) / SK_K_STEP * SK_K_STEP;
    const int fs = F | 1;
    const size_t smem = static_cast<size_t>(kp) * F * sizeof(double2) +
                        static_cast<size_t>(rb) * (K > fs ? K : fs) * 4 +
                        static_cast<size_t>(rb) * (4 + 4 + 8) +
                        static_cast<size_t>(2 * groups * rb) * 4;
    decltype(&stft_psd_small_kernel<1>) const by_nb[SK_BINS] = {
        stft_psd_small_kernel<1>, stft_psd_small_kernel<2>,
        stft_psd_small_kernel<3>, stft_psd_small_kernel<4>,
        stft_psd_small_kernel<5>, stft_psd_small_kernel<6>,
        stft_psd_small_kernel<7>, stft_psd_small_kernel<8>};
    const auto kernel = by_nb[nb - 1];
    const int err = raise_smem(kernel, smem, small_smem_set[nb - 1]);
    if (err != 0) return err;
    const unsigned blocks = static_cast<unsigned>((R + rb - 1) / rb);
    kernel<<<blocks, SK_THREADS, smem, s>>>(
        x, a_re, a_im, wts, out, part_min, part_max, n, R, F, K, hop,
        log10_out, with_stats, groups, make_fastdiv(T), make_fastdiv(K),
        make_fastdiv(F));
    return static_cast<int>(cudaGetLastError());
  }
  const unsigned blocks = (unsigned)((R + BM - 1) / BM) * ((F + BN - 1) / BN);
  stft_psd_kernel<<<blocks, NT, 0, s>>>(x, a_re, a_im, wts, out, part_min,
                                        part_max, n, R, T, F, K, hop,
                                        log10_out, with_stats);
  return static_cast<int>(cudaGetLastError());
}

// The FFT route, on `stream`; returns a cudaError_t (0 = success):
// cudaErrorInvalidValue for a size or detrend code the kernel does not
// take, else that of raising the kernel's shared memory limit, else that
// of the launch. x is (B, n) contiguous f32; win is (K,) f64; tw is
// (K - 1, 2) f64, the
// stage-ordered (cos, sin) rows of core/stft.py::fft_twiddles; wts holds
// every bin's weight, f64, at least f_lo + F of them; out is (B, T, F)
// f32, the band of F bins from bin f_lo (the full band: f_lo 0 and F the
// config's bin count), f_lo + F <= K; part_min/part_max are (B * T,) f32,
// each row's over the band, and may be null when with_stats is 0.
// K is a power of two from 32 to 8192; detrend is 0 for none, 1 for
// constant, 2 for linear, and any other value is refused. The caller keeps
// B * T within the grid's limit.
int stft_fft_psd_launch(const float* x, const double* win, const double* tw,
                        const double* wts, float* out, float* part_min,
                        float* part_max, int B, long long n, int T, int F,
                        int K, int hop, int detrend, int log10_out,
                        int with_stats, int f_lo, void* stream) {
  int log2k = 0;
  while ((1 << log2k) < K) ++log2k;
  if (K < 32 || K > 8192 || (1 << log2k) != K || !band_ok(f_lo, F, K) ||
      !detrend_ok(detrend))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = B * T;
  const Band band{f_lo, F};
  switch (log2k - 1) {
    case 4:
      return r2_launch<4>(x, win, tw, wts, out, part_min, part_max, R, n, T,
                          band, hop, detrend, log10_out, with_stats, s);
    case 5:
      return r2_launch<5>(x, win, tw, wts, out, part_min, part_max, R, n, T,
                          band, hop, detrend, log10_out, with_stats, s);
    case 6:
      return r2_launch<6>(x, win, tw, wts, out, part_min, part_max, R, n, T,
                          band, hop, detrend, log10_out, with_stats, s);
    case 7:
      return r2_launch<7>(x, win, tw, wts, out, part_min, part_max, R, n, T,
                          band, hop, detrend, log10_out, with_stats, s);
    case 8:
      return r2_launch<8>(x, win, tw, wts, out, part_min, part_max, R, n, T,
                          band, hop, detrend, log10_out, with_stats, s);
    case 9:
      return r2_launch<9>(x, win, tw, wts, out, part_min, part_max, R, n, T,
                          band, hop, detrend, log10_out, with_stats, s);
    case 10:
      return r2_launch<10>(x, win, tw, wts, out, part_min, part_max, R, n,
                           T, band, hop, detrend, log10_out, with_stats, s);
    case 11:
      return r2_launch<11>(x, win, tw, wts, out, part_min, part_max, R, n,
                           T, band, hop, detrend, log10_out, with_stats, s);
    case 12:
      return r2_launch<12>(x, win, tw, wts, out, part_min, part_max, R, n,
                           T, band, hop, detrend, log10_out, with_stats, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The mixed-radix FFT route, on `stream`; returns a cudaError_t (0 =
// success): cudaErrorInvalidValue for a plan or detrend code the kernel
// does not take, else that of raising the kernel's shared memory limit,
// else that of the launch. x is (B, n) contiguous f32; win is (K,) f64;
// perm is (K/2,) int32; tw is (rows, 2) f64, and stages, in HOST memory,
// (n_stages, 4) int32 rows (radix, span, twiddle row, root row), both
// from core/stft.py::fft_plan, with split the first row of the split
// step's twiddles and rader the first row of the Rader stage's b^ (-1
// without one); wts, out, part_min, part_max, F and f_lo as the FFT
// route's. K is even, 32 to 8192; detrend is 0 for none, 1 for constant, 2 for
// linear, and any other value is refused. The caller keeps B * T within
// the grid's limit.
int stft_mixed_fft_psd_launch(const float* x, const double* win,
                              const int* perm, const double* tw,
                              const int* stages, int n_stages, int split,
                              int rader, const double* wts, float* out,
                              float* part_min, float* part_max, int B,
                              long long n, int T, int F, int K, int hop,
                              int detrend, int log10_out, int with_stats,
                              int f_lo, void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  if (K < 32 || K > 8192 || K % 2 || !band_ok(f_lo, F, K) ||
      !detrend_ok(detrend) || split < 0)
    return static_cast<int>(bad);
  const Band band{f_lo, F};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double2* tw2 = reinterpret_cast<const double2*>(tw);
  if (rader >= 0) {
    // a Rader plan: the odd kernel's template on one packed frame a block
    // (PACKED), the convolution of M - 1 points on the pass engine
    ConvPlan plan;
    int rmax = 0;
    int threads = 0;
    if (!conv_plan(stages, n_stages, K / 2 - 1, rader, split, true, K / 2,
                   K / 2, PACKED_R2_BITS, &plan, &rmax, &threads) ||
        rmax > 1)
      return static_cast<int>(bad);
    const auto kernel = rmax == 0 ? stft_odd_fft_psd_kernel<true, 0, true>
                                  : stft_odd_fft_psd_kernel<true, 1, true>;
    const size_t smem = static_cast<size_t>(K / 2) * sizeof(double2);
    const int err = raise_smem(kernel, smem, odd_smem_set[8 + rmax]);
    if (err != 0) return err;
    const unsigned blocks =
        static_cast<unsigned>(B) * static_cast<unsigned>(T);
    kernel<<<blocks, threads, smem, st>>>(x, win, perm, tw2, wts, out,
                                          part_min, part_max, n, T, band, K,
                                          hop, detrend, log10_out,
                                          with_stats, 1, plan);
    return static_cast<int>(cudaGetLastError());
  }
  MixRegPlan plan;
  int rmax = 0;
  if (!mixed_register_plan(stages, n_stages, split, K / 2, &plan, &rmax))
    return static_cast<int>(bad);
  const int variant = rmax / 4;                 // 0, 1, 2
  const auto kernel = variant == 0   ? stft_mixed_fft_psd_kernel<0>
                      : variant == 1 ? stft_mixed_fft_psd_kernel<4>
                                     : stft_mixed_fft_psd_kernel<8>;
  const size_t smem =
      static_cast<size_t>(plan.frames) * (K / 2) * sizeof(double2);
  const int err = raise_smem(kernel, smem, mixed_smem_set[variant]);
  if (err != 0) return err;
  const int R = B * T;
  const unsigned blocks =
      static_cast<unsigned>((R + plan.frames - 1) / plan.frames);
  kernel<<<blocks, MIX_THREADS, smem, st>>>(x, win, perm, tw2, wts, out,
                                             part_min, part_max, n, R, T,
                                             band, K, hop, detrend, log10_out,
                                             with_stats, plan);
  return static_cast<int>(cudaGetLastError());
}

// The odd route, on `stream`; returns a cudaError_t as the mixed-radix
// launcher does. Its operands are the mixed-radix launcher's for an odd K,
// 33 to 8191: perm is (K,) int32, the plan transforms K points (with a
// Rader stage, K - 1) and has no split rows. pack 0 transforms every frame
// alone (for timing the packing); 1 packs pairs of frames as the kernel's
// guard allows. The kernel runs B * ceil(T / 2) blocks.
int stft_odd_fft_psd_launch(const float* x, const double* win,
                            const int* perm, const double* tw,
                            const int* stages, int n_stages, int rader,
                            const double* wts, float* out, float* part_min,
                            float* part_max, int B, long long n, int T,
                            int F, int K, int hop, int detrend,
                            int log10_out, int with_stats, int pack,
                            int f_lo, void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  ConvPlan plan;
  int rmax = 0;
  int threads = 0;
  if (K < 33 || K > 8191 || K % 2 == 0 || !band_ok(f_lo, F, K) ||
      !detrend_ok(detrend) || rader < -1 ||
      !conv_plan(stages, n_stages, rader >= 0 ? K - 1 : K, rader, -1,
                 rader >= 0, K,
                 rader >= 0 ? RADER_NARROW_POINTS : ODD_NARROW_POINTS,
                 MIX_R2_BITS, &plan, &rmax, &threads))
    return static_cast<int>(bad);
  const int variant = 4 * (rader >= 0) + (rmax == 1 ? 1 : rmax / 4 + (rmax > 0));
  const auto kernel = variant == 0   ? stft_odd_fft_psd_kernel<false, 0>
                      : variant == 1 ? stft_odd_fft_psd_kernel<false, 1>
                      : variant == 2 ? stft_odd_fft_psd_kernel<false, 4>
                      : variant == 3 ? stft_odd_fft_psd_kernel<false, 8>
                      : variant == 4 ? stft_odd_fft_psd_kernel<true, 0>
                      : variant == 5 ? stft_odd_fft_psd_kernel<true, 1>
                      : variant == 6 ? stft_odd_fft_psd_kernel<true, 4>
                                     : stft_odd_fft_psd_kernel<true, 8>;
  const size_t smem = static_cast<size_t>(K) * sizeof(double2);
  const int err = raise_smem(kernel, smem, odd_smem_set[variant]);
  if (err != 0) return err;
  const unsigned blocks =
      static_cast<unsigned>(B) * static_cast<unsigned>((T + 1) / 2);
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, win, perm, reinterpret_cast<const double2*>(tw), wts, out, part_min,
      part_max, n, T, Band{f_lo, F}, K, hop, detrend, log10_out, with_stats,
      pack != 0, plan);
  return static_cast<int>(cudaGetLastError());
}

// The Bluestein route, on `stream`; returns a cudaError_t (0 = success):
// cudaErrorInvalidValue for a plan or detrend code the kernel does not
// take, else that of raising the kernel's shared memory limit, else that
// of the launch (a cluster that cannot be placed included). x is (B, n)
// contiguous f32; win is (K,) f64; tw is (rows, 2) f64, and stages, in
// HOST memory, the (n_stages, 4) int32 rows of M's plan, both from
// core/stft.py::bluestein_plan, with bhat, chirp and split the first rows
// of b^ (M rows), of the chirp (N rows) and of the split step (N rows;
// -1 for odd K, which has none); wts, out, part_min, part_max, F and f_lo
// as the FFT route's. K is 32 to 8192, M >= 2N - 1 (N = K/2, or K when odd)
// with radices 2, 3, 5 and 7; M past BLUE_MAX_BLOCK_POINTS runs on
// clusters of two blocks and must be even with a last stage of radix 2 at
// span M/2, and K odd. detrend is 0 for none, 1 for constant, 2 for
// linear. The kernel runs B * T units for even K and B * ceil(T / 2) for
// odd K, a block or a cluster each; the caller keeps B * T within the
// grid's limit.
int stft_bluestein_psd_launch(const float* x, const double* win,
                              const double* tw, const int* stages,
                              int n_stages, int M, int bhat, int chirp,
                              int split, const double* wts, float* out,
                              float* part_min, float* part_max, int B,
                              long long n, int T, int F, int K, int hop,
                              int detrend, int log10_out, int with_stats,
                              int f_lo, void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  const bool odd = K % 2 == 1;
  const int N = odd ? K : K / 2;
  const int ranks = M > BLUE_MAX_BLOCK_POINTS ? 2 : 1;
  const Band band{f_lo, F};
  if (K < 32 || K > 8192 || !band_ok(f_lo, F, K) || !detrend_ok(detrend) ||
      M < 2 * N - 1 || bhat < 0 || chirp < 0 || (split < 0) != odd ||
      n_stages < 1 || n_stages > MIX_MAX_STAGES)
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
  const int variant =
      ranks == 2 ? 2 : (local <= BLUE_TWO_BLOCK_POINTS ? 1 : 0);
  const auto kernel = variant == 2   ? stft_bluestein_psd_kernel<2, false>
                      : variant == 1 ? stft_bluestein_psd_kernel<1, true>
                                     : stft_bluestein_psd_kernel<1, false>;
  const size_t smem = static_cast<size_t>(local) * sizeof(double2);
  const int err = raise_smem(kernel, smem, blue_smem_set[variant]);
  if (err != 0) return err;
  const unsigned units =
      static_cast<unsigned>(B) *
      static_cast<unsigned>(odd ? (T + 1) / 2 : T);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double2* tw2 = reinterpret_cast<const double2*>(tw);
  if (ranks == 1) {
    kernel<<<units, threads, smem, s>>>(
        x, win, tw2, wts, out, part_min, part_max, n, T, band, K, hop,
        detrend, log10_out, with_stats, M, bhat, chirp, half_row, plan);
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
      &config, kernel, x, win, tw2, wts, out, part_min, part_max, n, T, band,
      K, hop, detrend, log10_out, with_stats, M, bhat, chirp, half_row, plan);
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

const char* stft_psd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
