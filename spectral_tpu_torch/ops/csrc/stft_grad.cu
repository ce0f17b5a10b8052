// The STFT/PSD kernels' backward for NVIDIA Hopper (sm_90a).
//
// The JAX package differentiates its STFT/PSD by jax.grad through
// spectral_tpu/core/stft.py::power_spectrogram (:769) and stft (:388): the
// adjoint of the framing, the window- and detrend-folded DFT and the
// epilogue, which XLA derives (its Pallas kernel, stft_pallas.py:431, has
// no gradient, and the JAX package never differentiates through it). The
// port's forward is a hand-written kernel (csrc/stft_psd.cu), so its
// backward is too: two kernels, launched in turn by the autograd Function
// in ops/stft_cuda.py after one launch of the forward route's complex
// epilogue (OUT_COMPLEX at weight 1) has recomputed X.
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
//   The FFT-based adjoint (a c2r transform on the radix-2 engine, then the
//   other families) is the redesign that follows (ROADMAP).
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

// The cotangent of bin (r, f), every step rounded to nearest (no FMA
// contraction), as the plain version's elementwise float64 arithmetic.
__device__ __forceinline__ double2 cotangent(const float* g, const float2* X,
                                            const double* w, long long i,
                                            int f, int mode) {
  const float2 z = X[i];
  const double xr = z.x, xi = z.y;
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

const char* stft_grad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
