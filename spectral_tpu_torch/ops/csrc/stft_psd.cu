// Fused STFT / PSD kernel for NVIDIA Hopper (sm_90a), nperseg up to 8192.
//
// Replaces the TPU kernels of spectral_tpu/ops/stft_pallas.py::
// stft_psd_pallas: the auto kernel `_compute` (K1, with the `with_stats` and
// `log10_out` modes) and the manual-DMA kernel `kernel_manual` (K2, A left in
// HBM and one A tile reloaded per frequency tile, nperseg 6145-8192). Both
// compute the same function, so one kernel source serves both:
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
// B*T*F*4 bytes out, so it is compute-bound: 67 TFLOP/s of FP64 on the
// tensor cores, of which this design, on DFMA outside them, can reach at
// most half (about 33.5 TFLOP/s). It is a register-blocked GEMM: each block owns a 128-row x 64-bin tile, stages
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

}  // namespace

extern "C" {

// Number of frequency tiles: the (min, max) partials are
// (stft_psd_freq_tiles(F), B * T) each.
int stft_psd_freq_tiles(int F) { return (F + BN - 1) / BN; }

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// x is (B, n) contiguous f32; a_re/a_im are (K, F) contiguous f64 and wts
// is (F,) f64; out is (B, T, F) f32; part_min/part_max are
// (stft_psd_freq_tiles(F), B * T) f32 and may be null when with_stats is
// 0. The caller keeps B * T and the number of blocks, row tiles times
// frequency tiles, within the grid's limits.
int stft_psd_launch(const float* x, const double* a_re, const double* a_im,
                    const double* wts, float* out, float* part_min,
                    float* part_max, int B, long long n, int T, int F, int K,
                    int hop, int log10_out, int with_stats, void* stream) {
  const int R = B * T;
  const unsigned blocks = (unsigned)((R + BM - 1) / BM) * ((F + BN - 1) / BN);
  stft_psd_kernel<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      x, a_re, a_im, wts, out, part_min, part_max, n, R, T, F, K, hop,
      log10_out, with_stats);
  return static_cast<int>(cudaGetLastError());
}

const char* stft_psd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
