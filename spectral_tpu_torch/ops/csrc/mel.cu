// The mel projection for NVIDIA Hopper (sm_90a).
//
// The JAX package applies its mel filterbank outside any Pallas kernel, as
// an XLA einsum (spectral_tpu/parallel/sharding.py:99-103): every mel row
// m of the mel band [m_lo, m_hi) (the fmin/fmax mask on the mel-centre
// axis, sharding.py:71-75) is
//
//   mel[b, t, m] = sum_f fb[m, f] * psd[b, t, f]
//
// over all F bins, in float32. Here the same function, in float64:
//
// mel_project_kernel (mel_project_launch)
//   in : psd (R, F) f32, the STFT kernel's frame-major full-band PSD, R =
//        B * T rows; each mel row's span of nonzero weights, from the host
//        (ops/mel_cuda.py::mel_spans): start[m], len[m] and off[m], its
//        len[m] float64 weights at w[off[m]] (the filterbank's columns
//        start[m] .. start[m] + len[m] - 1, zeros inside the span kept)
//   out: mel (R, M) f32, M = m_hi - m_lo rows of the band, and the row's
//        NaN-propagating (min, max) over its M values, part_min / part_max
//        (R,) f32, the STFT kernels' partials layout (2, 1, B, T), so
//        clip_stats and the display map take the mel rows unchanged.
//   The sum: over the span in float64, bin by bin from its first, rounded
//   once to float32 at the store. A triangle holds 2-24 nonzero weights of
//   513 bins at 128 mels (1.5% of the dense product's).
//   Non-finite bins: the dense product multiplies every bin, so a
//   non-finite bin where fb[m, f] == 0 makes row m NaN (0 * inf, 0 * NaN),
//   which the span sum alone would miss. So the warp finds its row's first
//   and last non-finite bin as it stages the row; a row whose span does
//   not hold both is NaN. Inside the span the sum carries them as the
//   dense product does (a NaN bin, or an inf one at a zero weight, NaN; an
//   inf one at a positive weight, inf). A row with no nonzero weight is 0,
//   or NaN by the same rule.
//   Work: a warp a PSD row, WARPS rows a block. The warp stages its row in
//   shared memory with coalesced loads (the whole row is read, for the
//   non-finite test), then lane l sums mel rows l, l + 32, ... from shared
//   memory, so a warp's stores of one row's mel values are consecutive.
//   Bound: bytes, the PSD read once and the mel rows written once (0.49 ms
//   at 1024 clips x 622 frames x 513 bins, 128 mels, on 3.35 TB/s).
//
// mel_backward_kernel (mel_backward_launch): the projection's adjoint, for
// the gradient through the mel rows (the JAX package's jax.grad of its
// einsum)
//   in : dmel (R, M) f32, the gradient of mel; each bin's mel rows, from
//        the host (ops/mel_cuda.py::bin_table, the span table transposed):
//        bstart[f] and bcount[f], the rows m (ascending) whose span holds
//        bin f at brow[bstart[f] ..] and their weights fb[m, f] at bw[..]
//   out: dpsd (R, F) f32,
//          dpsd[r, f] = sum_m fb[m, f] dmel[r, m]
//        over the mel band's rows whose span holds f, in float64, rounded
//        once; a bin no row covers gets 0. Non-finite gradients as the
//        dense product dmel @ fb gives them: a non-finite dmel[r, m] makes
//        every bin outside row m's span NaN (0 * inf).
//   Work: a warp a row, its M gradients staged in shared memory (and a
//   count of the non-finite ones); lane l sums bins l, l + 32, ..., so a
//   warp's stores of one row are consecutive.
//   Bound: bytes, dmel read once and dpsd written once.

#include <cuda_runtime.h>

namespace {

constexpr int MEL_MAX_WARPS = 8;           // rows a block at most
constexpr int MEL_SMEM = 48 * 1024;        // the rows' staging, at most

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__global__ void __launch_bounds__(MEL_MAX_WARPS * 32)
mel_project_kernel(const float* __restrict__ psd, const int* __restrict__ start,
                   const int* __restrict__ len, const int* __restrict__ off,
                   const double* __restrict__ w, long long R, int F, int M,
                   float* __restrict__ out, float* __restrict__ part_min,
                   float* __restrict__ part_max) {
  extern __shared__ float rows[];          // a row of F floats a warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long r =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (r >= R) return;                      // the whole warp: no block sync
  float* row = rows + warp * F;
  const float* src = psd + r * F;
  int first = F;                           // first and last non-finite bin
  int last = -1;
  for (int f = lane; f < F; f += 32) {
    const float v = src[f];
    row[f] = v;
    if (!isfinite(v)) {
      first = f < first ? f : first;
      last = f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int a = __shfl_xor_sync(0xffffffffu, first, o);
    const int b = __shfl_xor_sync(0xffffffffu, last, o);
    first = a < first ? a : first;
    last = b > last ? b : last;
  }
  __syncwarp();                            // the row staged for every lane
  float lo = INFINITY;
  float hi = -INFINITY;
  float* dst = out + r * M;
  for (int m = lane; m < M; m += 32) {
    const int s = start[m];
    const int n = len[m];
    const double* wm = w + off[m];
    double acc = 0.0;
    for (int k = 0; k < n; ++k)
      acc = fma(wm[k], static_cast<double>(row[s + k]), acc);
    // a non-finite bin outside the span meets a zero weight
    if (first < s || last >= s + n)
      acc = __longlong_as_double(0x7ff8000000000000LL);   // NaN
    const float v = static_cast<float>(acc);
    dst[m] = v;
    lo = nan_min(lo, v);
    hi = nan_max(hi, v);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = nan_min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = nan_max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    part_min[r] = lo;
    part_max[r] = hi;
  }
}

// Rows a block takes at F floats a row (the PSD's bins, or the backward's
// mel gradients): as many warps as MEL_SMEM holds rows, at most
// MEL_MAX_WARPS; 0 when one row does not fit.
int mel_rows_per_block(int F) {
  const int rows = F > 0 ? MEL_SMEM / (F * 4) : 0;
  return rows < MEL_MAX_WARPS ? rows : MEL_MAX_WARPS;
}

__global__ void __launch_bounds__(MEL_MAX_WARPS * 32)
mel_backward_kernel(const float* __restrict__ dmel,
                    const int* __restrict__ bstart,
                    const int* __restrict__ bcount,
                    const int* __restrict__ brow,
                    const double* __restrict__ bw, long long R, int F, int M,
                    float* __restrict__ dpsd) {
  extern __shared__ float grads[];         // a row of M floats a warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long r =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (r >= R) return;                      // the whole warp: no block sync
  float* row = grads + warp * M;
  const float* src = dmel + r * M;
  int bad = 0;                             // non-finite gradients in the row
  for (int m = lane; m < M; m += 32) {
    const float v = src[m];
    row[m] = v;
    bad += !isfinite(v);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) bad += __shfl_xor_sync(0xffffffffu, bad, o);
  __syncwarp();
  float* dst = dpsd + r * F;
  for (int f = lane; f < F; f += 32) {
    const int e0 = bstart[f];
    const int e1 = e0 + bcount[f];
    double acc = 0.0;
    int inside = 0;
    for (int e = e0; e < e1; ++e) {
      const float v = row[brow[e]];
      inside += !isfinite(v);
      acc = fma(bw[e], static_cast<double>(v), acc);
    }
    // a non-finite gradient of a row whose span misses this bin
    if (inside < bad) acc = __longlong_as_double(0x7ff8000000000000LL);
    dst[f] = static_cast<float>(acc);
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t (0 = success), or
// cudaErrorInvalidValue for sizes the kernel does not take. psd is (R, F)
// contiguous f32; start, len and off are (M,) int32 and w the packed
// float64 spans, all on the device; out is (R, M) f32; part_min/part_max
// are (R,) f32.
int mel_project_launch(const float* psd, const int* start, const int* len,
                       const int* off, const double* w, long long R, int F,
                       int M, float* out, float* part_min, float* part_max,
                       void* stream) {
  const int rows = mel_rows_per_block(F);
  if (R < 0 || M < 1 || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const long long blocks = (R + rows - 1) / rows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  mel_project_kernel<<<static_cast<unsigned>(blocks), rows * 32,
                       static_cast<size_t>(rows) * F * sizeof(float),
                       static_cast<cudaStream_t>(stream)>>>(
      psd, start, len, off, w, R, F, M, out, part_min, part_max);
  return static_cast<int>(cudaGetLastError());
}

// Launch on `stream`; returns the cudaError_t (0 = success), or
// cudaErrorInvalidValue for sizes the kernel does not take. dmel is (R, M)
// contiguous f32; bstart and bcount are (F,) int32, brow the rows (int32)
// and bw their float64 weights, all on the device; dpsd is (R, F) f32.
int mel_backward_launch(const float* dmel, const int* bstart,
                        const int* bcount, const int* brow, const double* bw,
                        long long R, int F, int M, float* dpsd,
                        void* stream) {
  const int rows = mel_rows_per_block(M);
  if (R < 0 || F < 1 || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const long long blocks = (R + rows - 1) / rows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  mel_backward_kernel<<<static_cast<unsigned>(blocks), rows * 32,
                        static_cast<size_t>(rows) * M * sizeof(float),
                        static_cast<cudaStream_t>(stream)>>>(
      dmel, bstart, bcount, brow, bw, R, F, M, dpsd);
  return static_cast<int>(cudaGetLastError());
}

const char* mel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
