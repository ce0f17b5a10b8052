// The STFT/PSD kernels' backward for NVIDIA Hopper (sm_90a).
//
// The JAX package differentiates its STFT/PSD by jax.grad through
// spectral_tpu/core/stft.py::power_spectrogram (:769) and stft (:388): the
// adjoint of the framing, the window- and detrend-folded DFT and the
// epilogue, which XLA derives (its Pallas kernel, stft_pallas.py:431, has
// no gradient, and the JAX package never differentiates through it). The
// port's forward is a hand-written kernel (csrc/stft_psd.cu), so its
// backward is too, launched by the autograd Function in ops/stft_cuda.py
// by ops/stft_cuda.py::backward_route: on the radix-2 route (a
// power-of-two nfft from 32 to 8192) stft_fft_backward_kernel, which
// recomputes X in registers and takes the adjoint as a c2r transform; on
// the GEMM route at the forward's small-K tile's configs (F <= SK_MAX_F
// bins, nperseg below 2 SK_MAX_F) stft_small_backward_kernel, which
// recomputes X in registers by that tile's chains and takes d = H A^T in
// the same launch; on the rest of the GEMM route (two-sided spectra past
// 16 bins, nfft past 8192) and as the cross-check stft_backward_kernel,
// after one launch of the forward route's complex epilogue (OUT_COMPLEX at
// weight 1) has recomputed X; then overlap_add_kernel on every route.
// (The mixed, odd and Bluestein routes' adjoints are csrc/
// stft_grad_mixed.cu's.)
//
// stft_backward_kernel (stft_backward_launch): the transform's adjoint
//   in : g (R, F) f32, the gradient of the forward's output (interleaved
//        float2 for the complex STFT); X (R, F) float2, the unscaled STFT
//        of the same frames, recomputed; the output's weights w (F,) f64
//        (ops/stft_cuda.py::kernel_weights); the folded matrices a_re,
//        a_im (L, F) f64 (core/stft.py::dft_matrices, the band's columns,
//        mirrored when two-sided), L = nperseg
//   out: d (R, L) f32, the gradient of each frame's L samples:
//          d[r, n] = sum_f H_re[r, f] a_re[n, f] + H_im[r, f] a_im[n, f]
//        with the cotangent H = dL/dX_re + i dL/dX_im, formed in float64 in
//        the prologue from g and X:
//          PSD        (re^2 + im^2) w    H = 2 w g X
//          magnitude  sqrt(re^2 + im^2) w    H = w g X / |X|, 0 at |X| = 0
//                     (the minimal-norm subgradient; a frame of equal
//                     samples has X = 0 exactly after its mean is taken
//                     out)
//          complex    X w                H = w g
//        and H = 0 where |X|^2 is past float32's range (the forward's inf
//        there is a constant). The matrices' transposes carry the window,
//        the detrend projection (its own transpose) and nfft > nperseg
//        (their L rows of the nfft-point transform) in one product, so one
//        kernel serves every route and every config: radix-2, mixed, odd,
//        Bluestein and GEMM alike, one- and two-sided, any band.
//   Work: the GEMM forward stft_psd_kernel (csrc/stft_psd.cu) transposed:
//   a register-blocked float64 tile of BM rows x BN samples a block, BK
//   bins a stage staged in shared memory (H computed as it is staged, and
//   the matrices' rows), each thread an 8 x 4 tile of d with one DFMA
//   chain an output, bins ascending from 0, re before im.
//   Bound: on path 1 (1024 clips x 622 frames, nperseg 1024, 513 bins) the
//   bytes, g, X and d moved once, 6.5 GB over 3.35 TB/s; the product is 2 R
//   2F L = 1.34 TFLOP of float64, which this design takes on DFMA outside
//   the tensor cores: it is slow by design, as the forced GEMM forward is.
//   It stays for the GEMM route's configs past the small-K tile and as the
//   cross-check of the adjoints below (``_backward="dense"``).
//
// stft_fft_backward_kernel<LOG2M, LR> (stft_fft_backward_launch): the
//   radix-2 route's adjoint, K = nfft = 2M = 2^(LOG2M + 1), 32-8192
//   in : x (B, n) f32, the forward's (uncentered) waveform; g (R, F) f32
//        as above (float2 for the complex outputs), F the band's bins;
//        the FFT route's constants (ops/stft_cuda.py::fft_constants): the
//        window zero-padded to K, the twiddles (K - 1, 2) of
//        core/stft.py::fft_twiddles and the output's weights, every bin's
//   out: d (R, L) f32, L = nperseg, the same function as
//        stft_backward_kernel's d without the dense matrices or X in
//        memory. A frame on the forward kernel's threads
//        (stft_fft_psd_kernel's geometry, R2Geometry, and its register
//        passes and swizzled exchanges, copied below), all float64:
//   1. X in registers: the frame loaded, detrended (frame_line's mean or
//      least-squares line over L), windowed, packed into M complex values
//      and transformed (the forward's passes); skipped for the complex
//      outputs, whose H needs no X.
//   2. The split step and H a pair of bins (k, M - k) a thread, k <= M/2:
//      X[k] and X[M - k] from Z[k] and Z[M - k] (r2_epilogue's
//      expressions), H from g and X (cotangent's arithmetic) at the band's
//      bins, 0 elsewhere; a two-sided spectrum's mirrored bins K - f
//      folded in as conj H, H1[f] = H[f] + conj H[K - f] (0 < f < M).
//   3. The c2r adjoint d_v[n] = Re sum_f H1[f] e^{+2 pi i f n / K}: with S[0]
//      = Re H1[0], S[M] = Re H1[M], S[f] = H1[f] / 2 otherwise (the
//      Hermitian spectrum whose inverse is d_v), the inverse split step
//      Z'[k] = (S[k] + conj S[M - k]) + i (S[k] - conj S[M - k]) conj W_K^k
//      written in place of Z[k] (the same thread read it), then the
//      M-point inverse transform as the conjugate of the forward passes
//      on conj Z' (a bit-reversed read of the natural-order buffer into
//      pass 0): z'[j] = d_v[2j] + i d_v[2j + 1], in natural order in the
//      registers of the last pass.
//   4. The framing's prologue adjoint: u = window d_v over the first L
//      samples, then the detrend's projection, its own transpose: u less
//      its mean (constant), or less its mean and its least-squares line
//      about c = (L - 1)/2, D = L (L^2 - 1)/12 (linear), one frame
//      reduction as in step 1; d stored as f32, float2 where L is even.
//   Bound: bytes, x and g read once and d written once (two transforms of
//   2.5 K log2 K operations a frame are below it): 1.37 ms on path 1.
//
// overlap_add_kernel (overlap_add_launch): the framing's adjoint
//   in : d (B * T, L) f32; out: dx (B, n) f32,
//          dx[b, i] = sum_t d[b T + t, i - t hop]
//        over the frames t that hold sample i (at most ceil(L / hop)), in
//        gather form: each output sums its frames in ascending order in
//        float64 and rounds once; samples past the last frame get 0. No
//        atomics, so the result is the same in every run.
//   Bound: bytes, d read once and dx written once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared, its own
// library (ops/build.py), so that stft_psd.cu's build is not redone.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 128;          // rows (frames) a block
constexpr int BN = 64;           // frame samples a block
constexpr int BK = 8;            // bins a shared-memory stage
constexpr int TX = 16;           // threads along samples
constexpr int TY = 16;           // threads along rows
constexpr int NT = TX * TY;      // threads a block
constexpr int TM = BM / TY;      // rows a thread (8)
constexpr int TN = BN / TX;      // samples a thread (4)
constexpr int HPAD = 2;          // keeps 16-byte alignment, spreads banks

static_assert(TM == 8 && TN == 4, "the vector loads below assume 8 x 4");
static_assert((BM * BK) % NT == 0 && (BN * BK) % NT == 0, "stage split");

constexpr int OUT_PSD = 0;       // stft_cuda.OUTPUT_MODES
constexpr int OUT_MAGNITUDE = 1;
constexpr int OUT_COMPLEX = 2;
constexpr double F32_MAX = 3.4028234663852886e38;

template <int N>
__device__ __forceinline__ void load_vec(const double* p, double (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const double2 q = *reinterpret_cast<const double2*>(p + i);
    v[i] = q.x;
    v[i + 1] = q.y;
  }
}

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

// The cotangent of bin (r, f) from the recomputed X (R, F) float2
__device__ __forceinline__ double2 cotangent(const float* g, const float2* X,
                                            const double* w, long long i,
                                            int f, int mode) {
  const float2 z = X[i];
  return cotangent_of(z.x, z.y, g, w, i, f, mode);
}

__global__ void __launch_bounds__(NT)
stft_backward_kernel(const float* __restrict__ g, const float2* __restrict__ X,
                     const double* __restrict__ w,
                     const double* __restrict__ a_re,
                     const double* __restrict__ a_im, long long R, int F,
                     int L, int mode, int n_tiles, float* __restrict__ d) {
  __shared__ __align__(16) double hre[BK][BM + HPAD];
  __shared__ __align__(16) double him[BK][BM + HPAD];
  __shared__ __align__(16) double are[BK][BN];
  __shared__ __align__(16) double aim[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  // the sample tiles of a row tile adjacent, so they find its g and X in L2
  const long long r0 = static_cast<long long>(blockIdx.x / n_tiles) * BM;
  const int n0 = static_cast<int>(blockIdx.x % n_tiles) * BN;

  double acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0;

  for (int f0 = 0; f0 < F; f0 += BK) {
    // H: hre[k][m] for row r0 + m, bin f0 + k; neighbouring threads read
    // neighbouring bins of a row
#pragma unroll
    for (int s = 0; s < (BM * BK) / NT; ++s) {
      const int e = tid + s * NT;
      const int k = e % BK;
      const int m = e / BK;
      const long long r = r0 + m;
      const int f = f0 + k;
      double2 h = make_double2(0.0, 0.0);
      if (r < R && f < F) h = cotangent(g, X, w, r * F + f, f, mode);
      hre[k][m] = h.x;
      him[k][m] = h.y;
    }
    // the matrices: are[k][j] = a_re[n0 + j, f0 + k]
#pragma unroll
    for (int s = 0; s < (BN * BK) / NT; ++s) {
      const int e = tid + s * NT;
      const int k = e % BK;
      const int j = e / BK;
      const int n = n0 + j;
      const int f = f0 + k;
      const bool ok = n < L && f < F;
      const long long off = static_cast<long long>(n) * F + f;
      are[k][j] = ok ? a_re[off] : 0.0;
      aim[k][j] = ok ? a_im[off] : 0.0;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      double hr[TM], hi[TM], cr[TN], ci[TN];
      load_vec(&hre[k][ty * TM], hr);
      load_vec(&him[k][ty * TM], hi);
      load_vec(&are[k][tx * TN], cr);
      load_vec(&aim[k][tx * TN], ci);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fma(hi[i], ci[j], fma(hr[i], cr[j], acc[i][j]));
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = r0 + ty * TM + i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < L) d[r * L + n] = static_cast<float>(acc[i][j]);
    }
  }
}

constexpr int OA_THREADS = 256;

__global__ void __launch_bounds__(OA_THREADS)
overlap_add_kernel(const float* __restrict__ d, long long B, long long n,
                   int T, int L, int hop, float* __restrict__ dx) {
  const long long total = B * n;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long b = idx / n;
    const long long i = idx - b * n;
    // the frames t with t hop <= i < t hop + L
    const long long t_hi_all = i / hop;
    const long long t_hi = t_hi_all < T - 1 ? t_hi_all : T - 1;
    const long long t_lo = i >= L ? (i - L) / hop + 1 : 0;
    double acc = 0.0;
    for (long long t = t_lo; t <= t_hi; ++t)
      acc += static_cast<double>(d[(b * T + t) * L + (i - t * hop)]);
    dx[idx] = static_cast<float>(acc);
  }
}


// ---------------------------------------------------------------------------
// The GEMM route's adjoint at F <= SK_MAX_F bins and L < 2 SK_MAX_F samples
// (stft_small_backward_kernel, B1-small): the configs that run the forward's
// small-K tile (csrc/stft_psd.cu::stft_psd_small_kernel), nperseg 2-31
// one-sided in every mode, detrend and band.
//
// The forward's staging and its X chains are copied below from stft_psd.cu
// with their text unchanged (FastDiv, make_fastdiv, cp_async_f32,
// cp_async_wait_all, raise_smem, the SK_* constants, and the kernel's
// staging and product lines; tests/test_torch_grad_small.py holds the
// copies to the source), so this library builds on its own and
// stft_psd.cu's build stays the parent's.
//
// What bounds it: at path 10's shapes (scipy_default 24 on 1024 clips of
// 10 s: L = 24, F = 13, 7,800,832 rows) the bytes, x read once (655 MB), g
// (406 MB) and d (749 MB), 0.54 ms at 3.35 TB/s; the DFMA, 2 L F for X and
// 2 L F for d a row, 9.7 G, 0.58 ms at 64 an SM a clock outside the tensor
// cores. B1 there launched the complex epilogue to write X (811 MB) and
// read it back into a 128 x 64 tile that computes 64 samples for 24 and 16
// bins for 13.
//
// The design: a block takes the forward tile's RB consecutive rows with
// all their bins (RB = 512 / groups, groups 2 past SK_BINS bins):
// - its frames staged once as the clip's span by cp.async (the forward's
//   off / first / src), its g rows (RB x FW floats, one contiguous run)
//   beside them, the folded (K, F) matrices (band columns, mirrored when
//   two-sided) once as (re, im) pairs, K padded to KP;
// - X in registers, the forward tile's DFMA chains (thread ia of group g,
//   rows ia and ia + tpg, the NB bins from g NB, k ascending from 0, re and
//   im apart): X stays in float64 (B1 read it rounded to complex64);
// - H of each bin from X and g by cotangent_of (B1's arithmetic), written
//   over the g rows as (re, im) at an odd row stride HS = F | 1;
// - d of its rows ia and ia + tpg over its sample slices (groups x m of
//   them, tn samples each, tn at most SKB_TN): each output one DFMA chain
//   over the bins ascending from 0, re before im, as B1's
//   (fma(hi, ci, fma(hr, cr, acc))), staged over the frames at an odd row
//   stride, then the block's rows x L floats stored as one contiguous run
//   of (B, T, L).
// No recompute launch and no (R, F) X in memory.
constexpr int SK_THREADS = 256;
constexpr int SK_MAX_F = 16;     // the most bins the tile takes
constexpr int SK_BINS = 8;       // bins a thread at most
constexpr int SK_K_STEP = 4;     // K is padded to a multiple of this

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

constexpr int FFT_MAX_DEVICES = 64;
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

// samples of a row a thread sums at once: 8 ran 1.94-2.04 ms at
// scipy_default 24 and 31 on 1024 clips of 10 s, 12 1.95-2.37, 16
// 2.64-2.87 (tools/torch_kernel_variants.py grad_small, H100, 700 W)
constexpr int SKB_TN = 8;
// blocks an SM: 2 (128 registers); its shared memory (the H rows, 16 bytes
// a bin) holds at most two at F = 16
constexpr int SKB_MIN_BLOCKS = 2;

// the dynamic shared memory limit already set, per device, by bins a
// thread
size_t small_back_smem_set[SK_BINS][FFT_MAX_DEVICES] = {};

template <int NB>
__global__ void __launch_bounds__(SK_THREADS, SKB_MIN_BLOCKS)
stft_small_backward_kernel(const float* __restrict__ x,
                           const float* __restrict__ gy,
                           const double* __restrict__ a_re,
                           const double* __restrict__ a_im,
                           const double* __restrict__ wts,
                           float* __restrict__ d, long long n, int R, int F,
                           int K, int hop, int mode, int groups, int m,
                           int tn, const FastDiv t_div, const FastDiv k_div) {
  extern __shared__ __align__(16) double2 smem[];
  const int tid = threadIdx.x;
  const int tpg = SK_THREADS / groups;       // threads (and half the rows)
  const int RB = 2 * tpg;                    // a group's rows: the block's
  const int KP = (K + SK_K_STEP - 1) / SK_K_STEP * SK_K_STEP;
  const int FW = mode == OUT_COMPLEX ? 2 * F : F;   // floats a g row
  const int HS = F | 1;                      // H's row stride, in pairs
  const int LS = K | 1;                      // d's staged row stride
  double2* as = smem;                        // KP x F (re, im)
  double2* hs = as + KP * F;                 // RB x HS: g's rows, then H
  float* gs = reinterpret_cast<float*>(hs);
  float* xs = reinterpret_cast<float*>(hs + RB * HS);    // RB LS: frames,
                                                          // then d
  int* off = reinterpret_cast<int*>(xs + RB * LS);        // RB
  int* first = off + RB;                                  // RB
  long long* src = reinterpret_cast<long long*>(first + RB);   // RB

  // the block's g rows, one contiguous run, in the frames' commit group
  {
    const long long row0 = static_cast<long long>(blockIdx.x) * RB;
    const int rows = R - row0 < RB ? static_cast<int>(R - row0) : RB;
    const float* gb = gy + row0 * FW;
    for (int e = tid; e < rows * FW; e += SK_THREADS)
      cp_async_f32(gs + e, gb + e);
  }
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

  // H of this thread's bins from X in float64 and the staged g
  const int rows = R - r0 < RB ? R - r0 : RB;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = ia + h * tpg;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (j < fn) {
        const double2 c =
            i < rows ? cotangent_of(re[h][j], im[h][j], gs, wts,
                                    static_cast<long long>(i) * F + f0 + j,
                                    f0 + j, mode)
                     : make_double2(0.0, 0.0);
        re[h][j] = c.x;
        im[h][j] = c.y;
      }
    }
  }
  __syncthreads();                           // every g row and sample read
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = ia + h * tpg;
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (j < fn) hs[i * HS + f0 + j] = make_double2(re[h][j], im[h][j]);
  }
  __syncthreads();

  // d of rows ia and ia + tpg over slices g, g + groups, ..., each a DFMA
  // chain over the bins ascending, re before im
  const double2* ha = hs + ia * HS;
  const double2* hb = hs + (ia + tpg) * HS;
  float* os = xs;                            // the output stage, RB x LS
  for (int q = 0; q < m; ++q) {
    const int n0 = (g + groups * q) * tn;
    const int nn = K - n0 < tn ? K - n0 : tn;
    if (nn <= 0) break;                      // the slices past the row
    double acc[2][SKB_TN];
#pragma unroll
    for (int j = 0; j < SKB_TN; ++j) {
      acc[0][j] = 0.0;
      acc[1][j] = 0.0;
    }
    for (int f = 0; f < F; ++f) {
      const double2 u = ha[f];
      const double2 v = hb[f];
      const double2* af = as + n0 * F + f;
#pragma unroll
      for (int j = 0; j < SKB_TN; ++j) {
        if (j < nn) {
          const double2 a = af[j * F];
          acc[0][j] = fma(u.y, a.y, fma(u.x, a.x, acc[0][j]));
          acc[1][j] = fma(v.y, a.y, fma(v.x, a.x, acc[1][j]));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < SKB_TN; ++j) {
      if (j < nn) {
        os[ia * LS + n0 + j] = static_cast<float>(acc[0][j]);
        os[(ia + tpg) * LS + n0 + j] = static_cast<float>(acc[1][j]);
      }
    }
  }
  __syncthreads();

  float* dst = d + static_cast<long long>(r0) * K;
  for (int e = tid; e < rows * K; e += SK_THREADS) {
    const int i = static_cast<int>(k_div.div(e));
    dst[e] = os[i * LS + (e - i * K)];
  }
}

// The launch geometry of stft_small_backward_kernel for F bins and K
// samples: groups, bins a thread NB, rows a block, sample slices a thread
// m of tn samples, and the dynamic shared memory
struct SmallBackPlan {
  int groups, nb, rb, m, tn;
  size_t smem;
};

SmallBackPlan small_back_plan(int F, int K, int mode) {
  SmallBackPlan p;
  p.groups = F > SK_BINS ? 2 : 1;
  p.nb = (F + p.groups - 1) / p.groups;
  p.rb = 2 * SK_THREADS / p.groups;
  const int per = (K + p.groups - 1) / p.groups;   // samples a thread
  p.m = (per + SKB_TN - 1) / SKB_TN;
  p.tn = (K + p.groups * p.m - 1) / (p.groups * p.m);
  const int kp = (K + SK_K_STEP - 1) / SK_K_STEP * SK_K_STEP;
  const int fw = mode == OUT_COMPLEX ? 2 * F : F;
  const size_t hrow = static_cast<size_t>(F | 1) * sizeof(double2);
  const size_t grow = static_cast<size_t>(fw) * sizeof(float);
  p.smem = static_cast<size_t>(kp) * F * sizeof(double2) +
           static_cast<size_t>(p.rb) * (hrow > grow ? hrow : grow) +
           static_cast<size_t>(p.rb) * (K | 1) * sizeof(float) +
           static_cast<size_t>(p.rb) * (4 + 4 + 8);
  return p;
}


// ---------------------------------------------------------------------------
// The radix-2 route's adjoint (stft_fft_backward_kernel).
//
// The forward kernel's engine, copied from csrc/stft_psd.cu with its text
// unchanged (block_sum, Band, R2Geometry and the r2_* pass functions;
// tests/test_torch_grad_fft.py holds the copies to the source), so that
// this library builds on its own and stft_psd.cu's build and registers
// stay the parent's.

constexpr int DETREND_NONE = 0;  // stft_cuda.DETREND_CODES
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
  static_assert(LOG2M >= 4 && LOG2M <= 13, "a block's 16-8192 points");
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

constexpr int LARGE_SMEM = 48 * 1024;  // past it the limit is raised

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

// The one-sided cotangent H1[f] of row r at bin f <= M from X[f]: H at
// bin f where the band holds it, plus, two-sided, conj H[K - f] (X[K - f]
// = conj X[f]) for 0 < f < M; rows past the last (valid false) give 0
__device__ __forceinline__ double2 folded_cotangent(
    double2 X, const float* __restrict__ g, const double* __restrict__ w,
    long long r, Band band, int f, int M, int two_sided, int mode,
    bool valid) {
  double2 h = make_double2(0.0, 0.0);
  if (!valid) return h;
  const long long row = r * band.n - band.lo;
  if (band.has(f)) h = cotangent_of(X.x, X.y, g, w, row + f, f, mode);
  const int m = 2 * M - f;
  if (two_sided && f > 0 && f < M && band.has(m)) {
    const double2 c = cotangent_of(X.x, -X.y, g, w, row + m, m, mode);
    h.x += c.x;
    h.y -= c.y;
  }
  return h;
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

template <int LOG2M, int LR>
__global__ void __launch_bounds__(R2_MAX_THREADS,
                                  R2Geometry<LOG2M, LR>::MIN_BLOCKS)
stft_fft_backward_kernel(const float* __restrict__ x,
                         const float* __restrict__ g,
                         const double* __restrict__ win,
                         const double2* __restrict__ tw,
                         const double* __restrict__ wts,
                         float* __restrict__ d, long long n, int R, int T,
                         int hop, int L, Band band, int two_sided,
                         int detrend, int mode) {
  using G = R2Geometry<LOG2M, LR>;
  constexpr int V = G::VALUES;
  constexpr int M = G::M;
  constexpr int P = G::P;
  constexpr int LAST = G::PASSES - 1;
  extern __shared__ double2 buf[];  // G::FRAMES frames of M values
  __shared__ double2 red_sum[R2_WARPS];

  constexpr bool ALONE = G::FRAMES == 1;
  const int fl = ALONE ? 0 : static_cast<int>(threadIdx.x) / P;
  const int u = ALONE ? static_cast<int>(threadIdx.x)
                      : static_cast<int>(threadIdx.x) % P;
  const int r = blockIdx.x * G::FRAMES + fl;
  const bool valid = ALONE || r < R;
  const double c = 0.5 * (L - 1);
  const double dd = L * (static_cast<double>(L) * L - 1.0) / 12.0;
  const double2* split = tw + (M - 1);
  const double2* win2 = reinterpret_cast<const double2*>(win);
  double2 v[V];

  // 1. X: stft_fft_psd_kernel's load, detrend, window and passes
  if (mode != OUT_COMPLEX) {
    const float* frame =
        x + (valid ? (long long)(r / T) * n + (long long)(r % T) * hop : 0);
    const bool pairs = (reinterpret_cast<size_t>(frame) & 7) == 0;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int j = brev_low(i, LR) * P + u;
      v[i] = make_double2(0.0, 0.0);
      if (valid) {
        if (pairs && 2 * j + 1 < L) {
          const float2 s = reinterpret_cast<const float2*>(frame)[j];
          v[i] = make_double2(s.x, s.y);
        } else {
          v[i] = make_double2(2 * j < L ? frame[2 * j] : 0.0f,
                              2 * j + 1 < L ? frame[2 * j + 1] : 0.0f);
        }
      }
    }
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
      line = make_double2(s.x / L, detrend == DETREND_LINEAR ? s.y / dd : 0.0);
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int i0 = 2 * (brev_low(i, LR) * P + u);
      const double2 w = win2[i0 >> 1];
      v[i].x = i0 < L ? (v[i].x - line.x - line.y * (i0 - c)) * w.x : 0.0;
      v[i].y = i0 + 1 < L
                   ? (v[i].y - line.x - line.y * (i0 + 1 - c)) * w.y
                   : 0.0;
    }
    r2_pass<LOG2M, LR, 0>(v, tw, u);
    if constexpr (G::PASSES > 1)
      r2_exchange_pass<LOG2M, LR, 1>(v, buf, tw, fl, u);
    if constexpr (G::PASSES > 2)
      r2_exchange_pass<LOG2M, LR, 2>(v, buf, tw, fl, u);
    if constexpr (G::PASSES > 3)
      r2_exchange_pass<LOG2M, LR, 3>(v, buf, tw, fl, u);
    r2_store<LOG2M, LR, LAST>(v, buf, fl, u);
    r2_sync<P>();
  }

  // 2-3. H a pair of bins (k, M - k), and conj Z' in place of Z
  for (int k = u; k <= M / 2; k += P) {
    const int k2 = M - k;                   // bin M at k = 0
    const int sa = r2_slot<LOG2M, LR>(fl, k);
    const int sb = r2_slot<LOG2M, LR>(fl, k == 0 ? 0 : k2);
    double2 xa = make_double2(0.0, 0.0), xb = xa;
    if (mode != OUT_COMPLEX) {
      const double2 a = buf[sa];
      const double2 b = buf[sb];
      xa = split_bin(a, b, split[k]);
      xb = split_bin(b, a, k == 0 ? make_double2(-1.0, 0.0) : split[k2]);
    }
    const long long row = r;
    const double2 s = half_weight(
        folded_cotangent(xa, g, wts, row, band, k, M, two_sided, mode, valid),
        k, M);
    const double2 t = half_weight(
        folded_cotangent(xb, g, wts, row, band, k2, M, two_sided, mode,
                         valid),
        k2, M);
    buf[sa] = inverse_split(s, t, split[k]);
    if (k > 0 && k2 != k) buf[sb] = inverse_split(t, s, split[k2]);
  }
  r2_sync<P>();

  // 3. the inverse transform: pass 0 reads conj Z' bit-reversed (z'[j] of
  // register i is slot brev(i) P + u, as the forward's load), and the
  // barrier before its exchange keeps the slots it overwrites unread by
  // no thread
#pragma unroll
  for (int i = 0; i < V; ++i)
    v[i] = buf[r2_slot<LOG2M, LR>(fl, brev_low(i, LR) * P + u)];
  r2_sync<P>();
  r2_pass<LOG2M, LR, 0>(v, tw, u);
  if constexpr (G::PASSES > 1)
    r2_exchange_pass<LOG2M, LR, 1>(v, buf, tw, fl, u);
  if constexpr (G::PASSES > 2)
    r2_exchange_pass<LOG2M, LR, 2>(v, buf, tw, fl, u);
  if constexpr (G::PASSES > 3)
    r2_exchange_pass<LOG2M, LR, 3>(v, buf, tw, fl, u);

  // 4. u = window d_v, the detrend's projection, the store: register i
  // holds z'[p] (conjugated), p = r2_index(u, i) = u + i P in the last pass
  double2 s = make_double2(0.0, 0.0);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int i0 = 2 * r2_index<LOG2M, LR, LAST>(u, i);
    const double2 w = win2[i0 >> 1];
    v[i].x = i0 < L ? v[i].x * w.x : 0.0;
    v[i].y = i0 + 1 < L ? -v[i].y * w.y : 0.0;
    if (detrend != DETREND_NONE) {
      s.x += v[i].x;
      s.x += v[i].y;
      if (detrend == DETREND_LINEAR) {
        s.y += (i0 - c) * v[i].x;
        s.y += (i0 + 1 - c) * v[i].y;
      }
    }
  }
  double2 line = make_double2(0.0, 0.0);
  if (detrend != DETREND_NONE) {
    s = r2_frame_sum<P>(s, red_sum);
    line = make_double2(s.x / L, detrend == DETREND_LINEAR ? s.y / dd : 0.0);
  }
  if (!valid) return;
  float* out = d + static_cast<long long>(r) * L;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int i0 = 2 * r2_index<LOG2M, LR, LAST>(u, i);
    const float a = static_cast<float>(v[i].x - line.x - line.y * (i0 - c));
    const float b =
        static_cast<float>(v[i].y - line.x - line.y * (i0 + 1 - c));
    if (i0 + 1 < L && (L & 1) == 0) {
      reinterpret_cast<float2*>(out)[i0 >> 1] = make_float2(a, b);
    } else {
      if (i0 < L) out[i0] = a;
      if (i0 + 1 < L) out[i0 + 1] = b;
    }
  }
}

// log2 of the values a thread holds at M = 2^LOG2M, the forward launcher's
// R2_LR (csrc/stft_psd.cu)
constexpr int R2_LR[13] = {0, 0, 0, 0, 3, 3, 3, 3, 3, 3, 4, 4, 4};

template <int LOG2M>
int r2_backward_launch(const float* x, const float* g, const double* win,
                       const double* tw, const double* wts, float* d, int R,
                       long long n, int T, int hop, int L, Band band,
                       int two_sided, int detrend, int mode, cudaStream_t s) {
  constexpr int LR = R2_LR[LOG2M];
  using G = R2Geometry<LOG2M, LR>;
  const auto kernel = stft_fft_backward_kernel<LOG2M, LR>;
  if (G::SMEM + R2_WARPS * 16 > LARGE_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks =
      static_cast<unsigned>((R + G::FRAMES - 1) / G::FRAMES);
  kernel<<<blocks, G::THREADS, G::SMEM, s>>>(
      x, g, win, reinterpret_cast<const double2*>(tw), wts, d, n, R, T, hop,
      L, band, two_sided, detrend, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t (0 = success), or
// cudaErrorInvalidValue for sizes the kernel does not take. g is (R, F)
// f32 ((R, F, 2) for mode OUT_COMPLEX), X (R, F) float2, w (F,) f64,
// a_re/a_im (L, F) f64, d (R, L) f32, all contiguous on the device.
int stft_backward_launch(const float* g, const void* X, const double* w,
                         const double* a_re, const double* a_im, long long R,
                         int F, int L, int mode, float* d, void* stream) {
  if (R < 0 || F < 1 || L < 1 || mode < OUT_PSD || mode > OUT_COMPLEX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const int n_tiles = (L + BN - 1) / BN;
  const long long blocks = (R + BM - 1) / BM * n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  stft_backward_kernel<<<static_cast<unsigned>(blocks), NT, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<const float2*>(X), w, a_re, a_im, R, F, L, mode,
      n_tiles, d);
  return static_cast<int>(cudaGetLastError());
}

// d is (B * T, L) f32, dx (B, n) f32; T >= 1 frames of L samples hop apart.
int overlap_add_launch(const float* d, long long B, long long n, int T,
                       int L, int hop, float* dx, void* stream) {
  if (B < 0 || n < 0 || T < 1 || L < 1 || hop < 1 ||
      static_cast<long long>(T - 1) * hop + L > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = B * n;
  if (total == 0) return 0;
  long long blocks = (total + OA_THREADS - 1) / OA_THREADS;
  if (blocks > 1048576) blocks = 1048576;      // then a grid-stride loop
  overlap_add_kernel<<<static_cast<unsigned>(blocks), OA_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(d, B, n, T, L,
                                                            hop, dx);
  return static_cast<int>(cudaGetLastError());
}

// The radix-2 route's adjoint, on `stream`; returns the cudaError_t (0 =
// success), or cudaErrorInvalidValue for sizes, a detrend code or a mode
// the kernel does not take, else that of raising its shared memory limit,
// else that of the launch. x is (B, n) f32, the forward's uncentered
// waveform, T >= 1 frames of L samples hop apart; g (B * T, F) f32, or
// interleaved float2 for mode OUT_COMPLEX, the band of F bins from f_lo
// of the K bins when two_sided, else of K/2 + 1; win (K,) f64 zero past L,
// tw (K - 1, 2) f64 and wts (every bin's) f64, ops/stft_cuda.py::
// fft_constants; d (B * T, L) f32; all contiguous on the device. K is a
// power of two from 32 to 8192, 1 <= L <= K; detrend 0 none, 1 constant,
// 2 linear. The caller keeps B * T within the grid's limit.
int stft_fft_backward_launch(const float* x, const float* g,
                             const double* win, const double* tw,
                             const double* wts, float* d, int B,
                             long long n, int T, int F, int K, int L,
                             int hop, int detrend, int mode, int two_sided,
                             int f_lo, void* stream) {
  int log2k = 0;
  while ((1 << log2k) < K) ++log2k;
  const int bins = two_sided ? K : K / 2 + 1;
  if (K < 32 || K > 8192 || (1 << log2k) != K || L < 1 || L > K ||
      B < 0 || T < 1 || hop < 1 || f_lo < 0 || F < 1 || f_lo + F > bins ||
      static_cast<long long>(T - 1) * hop + L > n ||
      detrend < DETREND_NONE || detrend > DETREND_LINEAR ||
      mode < OUT_PSD || mode > OUT_COMPLEX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int R = B * T;
  if (R == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Band band{f_lo, F};
  const int ts = two_sided ? 1 : 0;
  switch (log2k - 1) {
    case 4: return r2_backward_launch<4>(x, g, win, tw, wts, d, R, n, T,
                                         hop, L, band, ts, detrend, mode, s);
    case 5: return r2_backward_launch<5>(x, g, win, tw, wts, d, R, n, T,
                                         hop, L, band, ts, detrend, mode, s);
    case 6: return r2_backward_launch<6>(x, g, win, tw, wts, d, R, n, T,
                                         hop, L, band, ts, detrend, mode, s);
    case 7: return r2_backward_launch<7>(x, g, win, tw, wts, d, R, n, T,
                                         hop, L, band, ts, detrend, mode, s);
    case 8: return r2_backward_launch<8>(x, g, win, tw, wts, d, R, n, T,
                                         hop, L, band, ts, detrend, mode, s);
    case 9: return r2_backward_launch<9>(x, g, win, tw, wts, d, R, n, T,
                                         hop, L, band, ts, detrend, mode, s);
    case 10: return r2_backward_launch<10>(x, g, win, tw, wts, d, R, n, T,
                                           hop, L, band, ts, detrend, mode,
                                           s);
    case 11: return r2_backward_launch<11>(x, g, win, tw, wts, d, R, n, T,
                                           hop, L, band, ts, detrend, mode,
                                           s);
    case 12: return r2_backward_launch<12>(x, g, win, tw, wts, d, R, n, T,
                                           hop, L, band, ts, detrend, mode,
                                           s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The GEMM route's adjoint at F <= SK_MAX_F bins and K < 2 SK_MAX_F samples
// (stft_small_backward_kernel), on `stream`; returns the cudaError_t (0 =
// success), or cudaErrorInvalidValue for sizes or a mode the kernel does
// not take, else that of raising its shared memory limit, else that of the
// launch. x is (B, n) f32, the forward's uncentered waveform, T >= 1
// frames of K samples hop apart; g (B * T, F) f32, or interleaved float2
// for mode OUT_COMPLEX; a_re/a_im (K, F) f64, the folded matrices of the
// band's F bins (mirrored when two-sided); w (F,) f64, the output's
// weights; d (B * T, K) f32; all contiguous on the device. The caller keeps
// B * T within the grid's limit.
int stft_small_backward_launch(const float* x, const float* g,
                               const double* a_re, const double* a_im,
                               const double* w, float* d, int B, long long n,
                               int T, int F, int K, int hop, int mode,
                               void* stream) {
  if (F < 1 || F > SK_MAX_F || K < 1 || K >= 2 * SK_MAX_F || B < 0 ||
      T < 1 || hop < 1 || static_cast<long long>(T - 1) * hop + K > n ||
      mode < OUT_PSD || mode > OUT_COMPLEX)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * T;
  if (rows == 0) return 0;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int R = static_cast<int>(rows);
  const SmallBackPlan p = small_back_plan(F, K, mode);
  decltype(&stft_small_backward_kernel<1>) const by_nb[SK_BINS] = {
      stft_small_backward_kernel<1>, stft_small_backward_kernel<2>,
      stft_small_backward_kernel<3>, stft_small_backward_kernel<4>,
      stft_small_backward_kernel<5>, stft_small_backward_kernel<6>,
      stft_small_backward_kernel<7>, stft_small_backward_kernel<8>};
  const auto kernel = by_nb[p.nb - 1];
  const int err = raise_smem(kernel, p.smem, small_back_smem_set[p.nb - 1]);
  if (err != 0) return err;
  const unsigned blocks = static_cast<unsigned>((R + p.rb - 1) / p.rb);
  kernel<<<blocks, SK_THREADS, p.smem, static_cast<cudaStream_t>(stream)>>>(
      x, g, a_re, a_im, w, d, n, R, F, K, hop, mode, p.groups, p.m, p.tn,
      make_fastdiv(T), make_fastdiv(K));
  return static_cast<int>(cudaGetLastError());
}

const char* stft_grad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
