// The Gaussian HMM's recursions for NVIDIA Hopper (sm_90a): Baum-Welch,
// the chunked E-step and Viterbi, in float64.
//
// The JAX package has no Pallas kernel here: its HMM runs as jitted
// lax.scan / lax.while_loop programs vmapped over sweeps
// (spectral_tpu/models/hmm.py:75-208, hmm_pscan.py:289-377,
// models/batch.py:42-45). In eager PyTorch such a loop costs a launch a
// step, so each recursion is a kernel of its own, one launch serving a
// whole batch of sequences. The plain PyTorch versions are
// models/hmm.py::_fit_plain / _viterbi_plain and
// models/hmm_pscan.py::_e_step_stats_plain / _viterbi_plain, which follow
// the arithmetic below operation for operation; ops/hmm_cuda.py holds the
// wrappers and the launch counts.
//
// Arithmetic, shared by every kernel here and by the plain versions:
//   emission  lb[t,k] = -0.5 * sum_d ((x[t,d] - mu[k,d])^2 / v[k,d]
//             + log(2 pi v[k,d])), v = max(covar, 1e-12), d in order;
//   log(0)    safe_log(p) = p > 0 ? log(max(p, 1e-300)) : -1e10 (_LOG_EPS);
//   forward   a[t,j] = lb[t,j] + (m_j + log(sum_i exp(w_ij - m_j))),
//             w_ij = a[t-1,i] + LA[i,j], m_j = max_i w_ij, LA =
//             safe_log(A): the JAX package's forward_log (hmm.py:75-88)
//             term for term;
//   backward  b[t,i] = m_i + log(sum_j exp(w_ij - m_i)),
//             w_ij = LA[i,j] + (lb[t+1,j] + b[t+1,j]), m_i = max_j w_ij
//             (backward_log, :91-101);
//   Viterbi   d[t,j] = max_i (d[t-1,i] + LA[i,j]) + lb[t,j], LA =
//             safe_log(A), the backpointer the first i that attains the
//             max (jnp.argmax's tie rule); log space with -1e10 for a zero
//             probability, as _safe_log does, so structural zeros never
//             become exact ties.
// Sums over states and features run in index order, each product rounded
// before its sum (__dmul_rn / __dadd_rn: no contraction into an FMA), so
// the plain version on the card gives the same bits wherever it sums in
// the same order; sums over frames are reduced in a fixed tree with no
// atomics, so a rerun gives the same bits.
//
// Why this log form: a step in scaled probabilities would need no
// transcendental, but supervised_fit's 1e-6 variances put emission
// log-likelihoods 1e5 apart, and a step whose best-emitting state is
// (nearly) unreachable then underflows the scale to 0; one shared max a
// step (one exp a source state) underflows a state whose only routes lie
// 745 nats below the best to -inf, and the sequential and chunked forms
// then disagree on where. The per-target max above keeps every value
// finite (-1e10 stands for log 0) and exact at any emission scale. A
// lane holds one state: its K exps are independent of each other and
// overlap, so the dependent chain of a step is one exp, one log and one
// round of K shuffles.
//
// hmm_fit_kernel (H1; hmm_fit_launch): Baum-Welch for a batch of
//   sequences, one block of 128 threads a sequence running the whole EM
//   loop in one launch (_em_loop's while_loop, hmm.py:188-208): per
//   iteration the emissions (all threads, into lb), the forward pass on
//   warp 0 and the backward pass on warp 1 side by side (lanes = states),
//   the statistics gamma = exp(a + b - ll) and xi = exp(((a + LA) + (lb +
//   b)) - ll) over frames (all threads, frames strided, then a warp
//   butterfly and the warps in order), the M-step with hmmlearn's rules
//   (hmm.py:152-185) and the convergence rule it == 0 || ll - prev >= tol.
//   lb, a and b (T x K float64 each, 192 KB at T = 2047, K = 4) live in
//   shared memory up to FIT_SMEM bytes, past it in a global scratch the
//   wrapper allocates.
//   Bound: the dependent chain, not bytes or operations: T - 1 steps of
//   (a K-way max, an exp, K products, a log, K shuffles each way) a pass,
//   the two passes concurrent; the roofline's bytes (X read once, the
//   parameters written once) take well under a microsecond.
// hmm_viterbi_kernel (H2, T < 2048 on the main path; hmm_viterbi_launch):
//   one block a sequence: emissions into lb (all threads), the max-plus
//   recursion on warp 0 (lanes = states) writing uint8 backpointers, the
//   end state, then the backtrace by one thread. lb and the backpointers
//   live in shared memory up to VIT_SMEM bytes, past it in a global
//   scratch. Bound: the chain of T - 1 dependent steps, then T dependent
//   loads of the backtrace.
// The chunked forms (T >= 2048), chunks of L frames (CHUNK_MAX at most):
//   hmm_viterbi_chunked_launch (H2 chunked), five kernels:
//     vit_transfer: each chunk c >= 1 runs the recursion from each one-hot
//       start state (a warp a start state) to its K x K max-plus transfer
//       F_c; chunk 0 runs from the initial vector;
//     vit_scan: one warp a sequence walks the chunks in order: each
//       chunk's incoming delta (normalized to max 0) and, at the end, the
//       end state;
//     vit_decode: each chunk re-runs its recursion from its incoming delta,
//       writes its backpointers and composes them into its state map (the
//       state at the chunk's first frame - 1 for each end state);
//     vit_compose: one thread a sequence walks the chunks backwards
//       through the maps (hmm_pscan.py:322-355's suffix composition);
//     vit_backtrace: each chunk walks its own backpointers from its end
//       state.
//   hmm_estep_chunked_launch (H3), four kernels: est_transfer (each chunk's
//     K x K log-semiring transfer, from each one-hot start state; chunk 0
//     its end vector), est_scan (one warp forward and one backward a
//     sequence over the chunk totals: every chunk's incoming alpha and
//     outgoing beta normalized to max 0, the offsets summed into the
//     log-likelihood), est_chunk (each chunk re-runs forward and backward
//     from its boundary vectors and sums gamma = softmax(a + b) and xi =
//     softmax((a + LA) + (lb + b)) and their moments over its frames), and
//     est_reduce (the chunks' partial sums in chunk order). The EM loop
//     for such T runs on the host.
//   Bound: the chains again, L steps a chunk on every chunk at once, plus
//   the scan's one step a chunk; X is read once by each of the chunk
//   kernels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr double LOG_EPS = -1e10;
constexpr double TWO_PI = 2.0 * 3.141592653589793;
constexpr double COVARS_PRIOR = 1e-2;
constexpr int MAX_D = 4;                     // features
constexpr int THREADS = 128;                 // fit, Viterbi, E-step chunk
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK_MAX = 256;               // frames a chunk at most
constexpr int CHUNK_CAP = 1024;              // frames x states a chunk
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t FIT_SMEM = 200 * 1024;      // lb, a, b in shared memory
constexpr size_t VIT_SMEM = 200 * 1024;      // lb, backpointers

__device__ __forceinline__ double safe_log(double p) {
  return p > 0.0 ? log(fmax(p, 1e-300)) : LOG_EPS;
}

// A sequence's parameters and what every step derives from them.
template <int KM>
struct Model {
  double start[KM];
  double trans[KM][KM];
  double means[KM][MAX_D];
  double covars[KM][MAX_D];
  double ls[KM];                 // safe_log(start)
  double la[KM][KM];             // safe_log(trans)
  double var[KM][MAX_D];         // max(covars, 1e-12)
  double l2pv[KM][MAX_D];        // log(2 pi var)
};

template <int KM>
__device__ void load_model(Model<KM>& m, long long b, int K, int D,
                           const double* start, const double* trans,
                           const double* means, const double* covars) {
  const int n = K * (K > D ? K : D);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (i < K * K) m.trans[i / K][i % K] = trans[b * K * K + i];
    if (i < K) m.start[i] = start[b * K + i];
    if (i < K * D) {
      m.means[i / D][i % D] = means[b * K * D + i];
      m.covars[i / D][i % D] = covars[b * K * D + i];
    }
  }
}

// Derived values; the caller synchronizes before and after.
template <int KM>
__device__ void derive(Model<KM>& m, int K, int D) {
  const int n = K * (K > D ? K : D);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (i < K * K) m.la[i / K][i % K] = safe_log(m.trans[i / K][i % K]);
    if (i < K) m.ls[i] = safe_log(m.start[i]);
    if (i < K * D) {
      const double v = fmax(m.covars[i / D][i % D], 1e-12);
      m.var[i / D][i % D] = v;
      m.l2pv[i / D][i % D] = log(__dmul_rn(TWO_PI, v));
    }
  }
}

template <int KM>
__device__ __forceinline__ double emission(const Model<KM>& m,
                                           const double* x, int k, int D) {
  double acc = 0.0;
#pragma unroll
  for (int d = 0; d < MAX_D; ++d) {
    if (d < D) {
      const double diff = __dsub_rn(x[d], m.means[k][d]);
      const double term = __dadd_rn(
          __ddiv_rn(__dmul_rn(diff, diff), m.var[k][d]), m.l2pv[k][d]);
      acc = d == 0 ? term : __dadd_rn(acc, term);
    }
  }
  return __dmul_rn(-0.5, acc);
}

// max over the first K lanes' values, in lane order
template <int KM>
__device__ __forceinline__ double lane_max(double v, int K) {
  double m = __shfl_sync(FULL, v, 0);
#pragma unroll
  for (int i = 1; i < KM; ++i) {
    const double vi = __shfl_sync(FULL, v, i);
    if (i < K && vi > m) m = vi;
  }
  return m;
}

// One forward step on lane j (all 32 lanes call it): a is lane j's
// a[t-1, j], lacol column j of LA, lbt lb[t, j].
template <int KM>
__device__ __forceinline__ double fwd_step(double a, const double (&lacol)[KM],
                                           double lbt, int K) {
  double w[KM];
  double m = 0.0;
#pragma unroll
  for (int i = 0; i < KM; ++i) {
    w[i] = __dadd_rn(__shfl_sync(FULL, a, i), lacol[i]);
    if (i < K && (i == 0 || w[i] > m)) m = w[i];
  }
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < KM; ++i)
    if (i < K) s = i == 0 ? exp(w[i] - m) : __dadd_rn(s, exp(w[i] - m));
  return __dadd_rn(lbt, __dadd_rn(m, log(s)));
}

// One backward step on lane i: b is lane i's b[t+1, i], larow row i of
// LA, lbn lb[t+1, i]; returns b[t, i].
template <int KM>
__device__ __forceinline__ double bwd_step(double b, const double (&larow)[KM],
                                           double lbn, int K) {
  const double u = __dadd_rn(lbn, b);
  double w[KM];
  double m = 0.0;
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    w[j] = __dadd_rn(larow[j], __shfl_sync(FULL, u, j));
    if (j < K && (j == 0 || w[j] > m)) m = w[j];
  }
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < KM; ++j)
    if (j < K) s = j == 0 ? exp(w[j] - m) : __dadd_rn(s, exp(w[j] - m));
  return __dadd_rn(m, log(s));
}

// One Viterbi step on lane j: d is lane j's d[t-1, j], lacol column j of
// LA; arg receives the first i attaining the max.
template <int KM>
__device__ __forceinline__ double vit_step(double d, const double (&lacol)[KM],
                                           double lbt, int K, int& arg) {
  double best = __dadd_rn(__shfl_sync(FULL, d, 0), lacol[0]);
  arg = 0;
#pragma unroll
  for (int i = 1; i < KM; ++i) {
    const double sc = __dadd_rn(__shfl_sync(FULL, d, i), lacol[i]);
    if (i < K && sc > best) {
      best = sc;
      arg = i;
    }
  }
  return __dadd_rn(best, lbt);
}

// logsumexp of the first K lanes' values: M + log(sum exp(v - M)), the
// sum in lane order.
template <int KM>
__device__ __forceinline__ double lane_logsumexp(double v, int K) {
  const double M = lane_max<KM>(v, K);
  const double e = exp(v - M);
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < KM; ++i) {
    const double ei = __shfl_sync(FULL, e, i);
    if (i < K) s = i == 0 ? ei : __dadd_rn(s, ei);
  }
  return __dadd_rn(M, log(s));
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Number of statistics: gamma0 (K), sum gamma (K), gamma^T X (K D),
// gamma^T X^2 (K D), sum xi (K K), in this order (the wrappers' layout).
__host__ __device__ __forceinline__ int n_stats(int K, int D) {
  return 2 * K + 2 * K * D + K * K;
}

// The same statistics padded to KM states and MAX_D features, so a
// thread's accumulators are indexed at compile time (registers).
template <int KM>
struct Lay {
  static constexpr int G0 = 0;
  static constexpr int GS = KM;
  static constexpr int GX = 2 * KM;
  static constexpr int GX2 = 2 * KM + KM * MAX_D;
  static constexpr int XI = 2 * KM + 2 * KM * MAX_D;
  static constexpr int N = 2 * KM + 2 * KM * MAX_D + KM * KM;
};

// n_stats index s -> its padded index
template <int KM>
__device__ __forceinline__ int padded(int s, int K, int D) {
  if (s < K) return Lay<KM>::G0 + s;
  s -= K;
  if (s < K) return Lay<KM>::GS + s;
  s -= K;
  if (s < K * D) return Lay<KM>::GX + (s / D) * MAX_D + s % D;
  s -= K * D;
  if (s < K * D) return Lay<KM>::GX2 + (s / D) * MAX_D + s % D;
  s -= K * D;
  return Lay<KM>::XI + (s / K) * KM + s % K;
}

// The M-step (hmm.py:152-185) from the statistics st (padded layout),
// threads of the block each one piece; the caller synchronizes after.
template <int KM>
__device__ void m_step(Model<KM>& m, const double* st, int K, int D) {
  const double* g0 = st + Lay<KM>::G0;
  const double* gs = st + Lay<KM>::GS;
  const double* gx = st + Lay<KM>::GX;
  const double* gx2 = st + Lay<KM>::GX2;
  const double* xi = st + Lay<KM>::XI;
  const int tid = threadIdx.x;
  if (tid == 0) {
    double ssum = 0.0;
    double num[KM];
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      if (k < K) {
        num[k] = m.start[k] == 0.0 ? 0.0 : g0[k];
        ssum = k == 0 ? num[k] : __dadd_rn(ssum, num[k]);
      }
    }
    const double den = ssum == 0.0 ? 1.0 : ssum;
#pragma unroll
    for (int k = 0; k < KM; ++k)
      if (k < K) m.start[k] = __ddiv_rn(num[k], den);
  }
  if (tid >= 32 && tid < 32 + K) {
    const int i = tid - 32;
    double rsum = 0.0;
    double num[KM];
#pragma unroll
    for (int j = 0; j < KM; ++j) {
      if (j < K) {
        num[j] = m.trans[i][j] == 0.0 ? 0.0 : xi[i * KM + j];
        rsum = j == 0 ? num[j] : __dadd_rn(rsum, num[j]);
      }
    }
    const double den = rsum == 0.0 ? 1.0 : rsum;
#pragma unroll
    for (int j = 0; j < KM; ++j)
      if (j < K) m.trans[i][j] = __ddiv_rn(num[j], den);
  }
  if (tid >= 64 && tid < 64 + K * D) {
    const int k = (tid - 64) / D;
    const int d = (tid - 64) % D;
    const double denom = gs[k];
    const double obs = gx[k * MAX_D + d];
    const double obs2 = gx2[k * MAX_D + d];
    const double mu = denom > 0.0 ? __ddiv_rn(obs, fmax(denom, 1e-30))
                                  : m.means[k][d];
    const double num = __dadd_rn(
        __dsub_rn(obs2, __dmul_rn(__dmul_rn(2.0, mu), obs)),
        __dmul_rn(__dmul_rn(mu, mu), denom));
    m.means[k][d] = mu;
    m.covars[k][d] = __ddiv_rn(__dadd_rn(COVARS_PRIOR, num), fmax(denom, 1e-5));
  }
}

// Reduce each thread's N values (acc) over the block of THREADS into
// out[0..N): a warp butterfly, then the warps in order by thread s for
// value s. part holds WARPS * N doubles. The caller synchronizes after.
template <int N>
__device__ void block_sum(const double (&acc)[N], double* part,
                          double* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < N; ++s) {
    const double v = warp_sum(acc[s]);
    if (lane == 0) part[warp * N + s] = v;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < N; s += blockDim.x) {
    double v = part[s];
    for (int w = 1; w < WARPS; ++w) v = __dadd_rn(v, part[w * N + s]);
    out[s] = v;
  }
}

template <int KM>
__global__ void __launch_bounds__(THREADS)
hmm_fit_kernel(const double* __restrict__ X, int T, int D, int K,
               const double* start0, const double* trans0,
               const double* means0, const double* covars0, int n_iter,
               double tol, double* o_start, double* o_trans, double* o_means,
               double* o_covars, double* o_ll, int* o_it, double* scratch) {
  extern __shared__ double dyn[];
  __shared__ Model<KM> m;
  __shared__ double part[WARPS * Lay<KM>::N];
  __shared__ double st[Lay<KM>::N];
  __shared__ double ll_sh;
  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const double* x = X + b * T * D;
  double* lb = scratch ? scratch + b * 3LL * T * K : dyn;
  double* al = lb + static_cast<long long>(T) * K;
  double* be = al + static_cast<long long>(T) * K;
  load_model<KM>(m, b, K, D, start0, trans0, means0, covars0);
  double prev = -INFINITY;
  double ll = -INFINITY;
  int it = 0;
  while (it < n_iter && (it == 0 || ll - prev >= tol)) {
    __syncthreads();
    derive<KM>(m, K, D);
    __syncthreads();
    for (long long i = tid; i < static_cast<long long>(T) * K; i += THREADS)
      lb[i] = emission<KM>(m, x + (i / K) * D, static_cast<int>(i % K), D);
    __syncthreads();
    const int jj = lane < K ? lane : K - 1;
    if (warp == 0) {                       // forward, lanes = target states
      double lacol[KM];
#pragma unroll
      for (int i = 0; i < KM; ++i) lacol[i] = i < K ? m.la[i][jj] : 0.0;
      double a = __dadd_rn(m.ls[jj], lb[jj]);
      if (lane < K) al[jj] = a;
      for (int t = 1; t < T; ++t) {
        a = fwd_step<KM>(a, lacol, lb[static_cast<long long>(t) * K + jj], K);
        if (lane < K) al[static_cast<long long>(t) * K + jj] = a;
      }
      const double l = lane_logsumexp<KM>(a, K);
      if (lane == 0) ll_sh = l;
    } else if (warp == 1) {                // backward, lanes = source states
      double larow[KM];
#pragma unroll
      for (int j = 0; j < KM; ++j) larow[j] = j < K ? m.la[jj][j] : 0.0;
      double bb = 0.0;
      if (lane < K) be[static_cast<long long>(T - 1) * K + jj] = 0.0;
      for (int t = T - 2; t >= 0; --t) {
        bb = bwd_step<KM>(bb, larow,
                          lb[static_cast<long long>(t + 1) * K + jj], K);
        if (lane < K) be[static_cast<long long>(t) * K + jj] = bb;
      }
    }
    __syncthreads();
    const double cur = ll_sh;
    // statistics: this thread's frames t = tid, tid + THREADS, ...
    double acc[Lay<KM>::N];
#pragma unroll
    for (int s = 0; s < Lay<KM>::N; ++s) acc[s] = 0.0;
    for (int t = tid; t < T; t += THREADS) {
      const long long r = static_cast<long long>(t) * K;
      double xd[MAX_D];
#pragma unroll
      for (int d = 0; d < MAX_D; ++d)
        xd[d] = d < D ? x[static_cast<long long>(t) * D + d] : 0.0;
#pragma unroll
      for (int k = 0; k < KM; ++k) {
        if (k < K) {
          const double g = exp(__dadd_rn(al[r + k], be[r + k]) - cur);
          if (t == 0) acc[Lay<KM>::G0 + k] = g;
          acc[Lay<KM>::GS + k] = __dadd_rn(acc[Lay<KM>::GS + k], g);
#pragma unroll
          for (int d = 0; d < MAX_D; ++d) {
            if (d < D) {
              double& gx = acc[Lay<KM>::GX + k * MAX_D + d];
              double& gx2 = acc[Lay<KM>::GX2 + k * MAX_D + d];
              gx = __dadd_rn(gx, __dmul_rn(g, xd[d]));
              gx2 = __dadd_rn(gx2, __dmul_rn(g, __dmul_rn(xd[d], xd[d])));
            }
          }
        }
      }
      if (t + 1 < T) {
#pragma unroll
        for (int i = 0; i < KM; ++i) {
#pragma unroll
          for (int j = 0; j < KM; ++j) {
            if (i < K && j < K) {
              const double w = __dadd_rn(
                  __dadd_rn(al[r + i], m.la[i][j]),
                  __dadd_rn(lb[r + K + j], be[r + K + j]));
              double& xs = acc[Lay<KM>::XI + i * KM + j];
              xs = __dadd_rn(xs, exp(w - cur));
            }
          }
        }
      }
    }
    block_sum(acc, part, st);
    __syncthreads();
    m_step<KM>(m, st, K, D);
    prev = ll;
    ll = cur;
    ++it;
  }
  __syncthreads();
  for (int i = tid; i < K * (K > D ? K : D); i += THREADS) {
    if (i < K * K) o_trans[b * K * K + i] = m.trans[i / K][i % K];
    if (i < K) o_start[b * K + i] = m.start[i];
    if (i < K * D) {
      o_means[b * K * D + i] = m.means[i / D][i % D];
      o_covars[b * K * D + i] = m.covars[i / D][i % D];
    }
  }
  if (tid == 0) {
    o_ll[b] = ll;
    o_it[b] = it;
  }
}

// Bytes of a sequence's lb (n doubles) and backpointers (n bytes, rounded
// up to 8 so the next sequence's lb stays aligned).
__host__ __device__ __forceinline__ long long vit_stride(long long n) {
  return n * static_cast<long long>(sizeof(double)) + ((n + 7) & ~7LL);
}

// Backtrace from end state s at frame T - 1 through backpointers psi (T x
// K, row t the pointers into frame t - 1), writing states[0..T).
__device__ void backtrace(const uint8_t* psi, int T, int K, int s,
                          int* states) {
  states[T - 1] = s;
  for (int t = T - 1; t >= 1; --t) {
    s = psi[static_cast<long long>(t) * K + s];
    states[t - 1] = s;
  }
}

template <int KM>
__global__ void __launch_bounds__(THREADS)
hmm_viterbi_kernel(const double* __restrict__ X, int T, int D, int K,
                   const double* start, const double* trans,
                   const double* means, const double* covars,
                   int* __restrict__ states, unsigned char* scratch) {
  extern __shared__ double dyn[];
  __shared__ Model<KM> m;
  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const double* x = X + b * T * D;
  const long long n = static_cast<long long>(T) * K;
  double* lb = scratch
      ? reinterpret_cast<double*>(scratch + b * vit_stride(n)) : dyn;
  uint8_t* psi = reinterpret_cast<uint8_t*>(lb + n);
  load_model<KM>(m, b, K, D, start, trans, means, covars);
  __syncthreads();
  derive<KM>(m, K, D);
  __syncthreads();
  for (long long i = tid; i < n; i += THREADS)
    lb[i] = emission<KM>(m, x + (i / K) * D, static_cast<int>(i % K), D);
  __syncthreads();
  if (tid >= 32) return;
  const int jj = lane < K ? lane : K - 1;
  double lacol[KM];
#pragma unroll
  for (int i = 0; i < KM; ++i) lacol[i] = i < K ? m.la[i][jj] : 0.0;
  double d = __dadd_rn(m.ls[jj], lb[jj]);
  for (int t = 1; t < T; ++t) {
    int arg;
    d = vit_step<KM>(d, lacol, lb[static_cast<long long>(t) * K + jj], K,
                     arg);
    if (lane < K) psi[static_cast<long long>(t) * K + jj] =
        static_cast<uint8_t>(arg);
  }
  // end state: the first lane attaining the max
  double best = __shfl_sync(FULL, d, 0);
  int end = 0;
#pragma unroll
  for (int j = 1; j < KM; ++j) {
    const double dj = __shfl_sync(FULL, d, j);
    if (j < K && dj > best) {
      best = dj;
      end = j;
    }
  }
  __syncwarp();
  if (lane == 0) backtrace(psi, T, K, end, states + b * T);
}

// ---------------------------------------------------------------------------
// The chunked forms. Chunk c of a sequence covers frames [c L, min(c L + L,
// T)); F, the chunks' K x K transfers, is (B, n, K, K), chunk 0's slot
// holding its end vector in row 0.
// ---------------------------------------------------------------------------

// Stage the emissions of chunk c's frames into lbs (rows t - c L) and the
// model; the caller synchronizes after.
template <int KM>
__device__ void stage_chunk(Model<KM>& m, double* lbs, const double* x,
                            long long t0, int len, int K, int D) {
  for (int i = threadIdx.x; i < len * K; i += blockDim.x)
    lbs[i] = emission<KM>(m, x + (t0 + i / K) * D, i % K, D);
}

template <int KM>
__device__ void load_chunk(Model<KM>& m, double* lbs, const double* X,
                           long long b, int c, int T, int D, int K, int L,
                           const double* start, const double* trans,
                           const double* means, const double* covars,
                           long long& t0, int& len) {
  load_model<KM>(m, b, K, D, start, trans, means, covars);
  __syncthreads();
  derive<KM>(m, K, D);
  __syncthreads();
  t0 = static_cast<long long>(c) * L;
  len = static_cast<int>(min(static_cast<long long>(L), T - t0));
  stage_chunk<KM>(m, lbs, X + b * T * D, t0, len, K, D);
  __syncthreads();
}

// Transfers: block (KM warps) per (chunk, sequence); warp i runs the
// recursion from one-hot start i (chunk 0: warp 0 from the initial
// vector). LOGSUM picks the forward step (H3) or the Viterbi step (H2).
template <int KM, bool LOGSUM>
__global__ void __launch_bounds__(KM * 32)
chunk_transfer_kernel(const double* __restrict__ X, int T, int D, int K,
                      int L, const double* start, const double* trans,
                      const double* means, const double* covars,
                      double* __restrict__ F) {
  __shared__ Model<KM> m;
  __shared__ double lbs[CHUNK_CAP];
  const int c = blockIdx.x;
  const long long b = blockIdx.y;
  const int n = gridDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long t0;
  int len;
  load_chunk<KM>(m, lbs, X, b, c, T, D, K, L, start, trans, means, covars,
                 t0, len);
  if (warp >= K || (c == 0 && warp > 0)) return;
  const int jj = lane < K ? lane : K - 1;
  double col[KM];
#pragma unroll
  for (int i = 0; i < KM; ++i)
    col[i] = i < K ? m.la[i][jj] : 0.0;
  double v;
  int first;
  if (c == 0) {
    v = __dadd_rn(m.ls[jj], lbs[jj]);
    first = 1;
  } else {
    v = jj == warp ? 0.0 : -INFINITY;
    first = 0;
  }
  for (int s = first; s < len; ++s) {
    if (LOGSUM) {
      v = fwd_step<KM>(v, col, lbs[s * K + jj], K);
    } else {
      int arg;
      v = vit_step<KM>(v, col, lbs[s * K + jj], K, arg);
    }
  }
  if (lane < K) F[((b * n + c) * K + warp) * K + jj] = v;
}

// Viterbi scan: one warp a sequence over the chunks in order. din (B, n,
// K) receives each chunk's incoming delta normalized to max 0; send (B,)
// the end state at frame T - 1.
template <int KM>
__global__ void __launch_bounds__(32)
vit_scan_kernel(int n, int K, const double* __restrict__ F,
                double* __restrict__ din, int* __restrict__ send) {
  const long long b = blockIdx.x;
  const int lane = threadIdx.x;
  const int jj = lane < K ? lane : K - 1;
  const double* Fb = F + b * n * K * K;
  double v = Fb[jj];
  for (int c = 1; c < n; ++c) {
    const double M = lane_max<KM>(v, K);
    const double vin = v - M;
    if (lane < K) din[(b * n + c) * K + jj] = vin;
    const double* Fc = Fb + static_cast<long long>(c) * K * K;
    double best = __dadd_rn(__shfl_sync(FULL, vin, 0), Fc[jj]);
#pragma unroll
    for (int i = 1; i < KM; ++i) {
      const double sc = __dadd_rn(__shfl_sync(FULL, vin, i),
                                  Fc[(i < K ? i : 0) * K + jj]);
      if (i < K && sc > best) best = sc;
    }
    v = best;
  }
  double best = __shfl_sync(FULL, v, 0);
  int end = 0;
#pragma unroll
  for (int j = 1; j < KM; ++j) {
    const double vj = __shfl_sync(FULL, v, j);
    if (j < K && vj > best) {
      best = vj;
      end = j;
    }
  }
  if (lane == 0) send[b] = end;
}

// Viterbi decode: a warp per (chunk, sequence) re-runs the chunk from its
// incoming delta, writes its backpointers (B, T, K) and its state map
// map (B, n, K): for each end state, the state at frame c L - 1.
template <int KM>
__global__ void __launch_bounds__(32)
vit_decode_kernel(const double* __restrict__ X, int T, int D, int K, int L,
                  const double* start, const double* trans,
                  const double* means, const double* covars,
                  const double* __restrict__ din, uint8_t* __restrict__ psi,
                  int* __restrict__ map) {
  __shared__ Model<KM> m;
  __shared__ double lbs[CHUNK_CAP];
  __shared__ uint8_t ps[CHUNK_CAP];
  const int c = blockIdx.x;
  const long long b = blockIdx.y;
  const int n = gridDim.x;
  const int lane = threadIdx.x;
  long long t0;
  int len;
  load_chunk<KM>(m, lbs, X, b, c, T, D, K, L, start, trans, means, covars,
                 t0, len);
  const int jj = lane < K ? lane : K - 1;
  double lacol[KM];
#pragma unroll
  for (int i = 0; i < KM; ++i) lacol[i] = i < K ? m.la[i][jj] : 0.0;
  double d;
  int first;
  if (c == 0) {
    d = __dadd_rn(m.ls[jj], lbs[jj]);
    first = 1;
  } else {
    d = din[(b * n + c) * K + jj];
    first = 0;
  }
  for (int s = first; s < len; ++s) {
    int arg;
    d = vit_step<KM>(d, lacol, lbs[s * K + jj], K, arg);
    if (lane < K) ps[s * K + jj] = static_cast<uint8_t>(arg);
  }
  __syncwarp();
  uint8_t* out = psi + (b * T + t0) * K;
  for (int i = lane + first * K; i < len * K; i += 32) out[i] = ps[i];
  if (c > 0 && lane < K) {
    int s = lane;
    for (int r = len - 1; r >= 0; --r) s = ps[r * K + s];
    map[(b * n + c) * K + lane] = s;
  }
}

// Compose the chunks' maps backwards from the end state: ends (B, n), the
// state at each chunk's last frame.
__global__ void vit_compose_kernel(int B, int n, int K,
                                   const int* __restrict__ send,
                                   const int* __restrict__ map,
                                   int* __restrict__ ends) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (b >= B) return;
  int s = send[b];
  for (int c = n - 1; c >= 1; --c) {
    ends[b * n + c] = s;
    s = map[(b * n + c) * K + s];
  }
  ends[b * n] = s;
}

// Each chunk walks its own backpointers from its end state.
__global__ void __launch_bounds__(32)
vit_backtrace_kernel(int T, int K, int L, const uint8_t* __restrict__ psi,
                     const int* __restrict__ ends, int* __restrict__ states) {
  __shared__ uint8_t ps[CHUNK_CAP];
  const int c = blockIdx.x;
  const long long b = blockIdx.y;
  const int n = gridDim.x;
  const long long t0 = static_cast<long long>(c) * L;
  const int len = static_cast<int>(min(static_cast<long long>(L), T - t0));
  const uint8_t* src = psi + (b * T + t0) * K;
  for (int i = threadIdx.x; i < len * K; i += 32) ps[i] = src[i];
  __syncwarp();
  if (threadIdx.x != 0) return;
  int* out = states + b * T + t0;
  int s = ends[b * n + c];
  out[len - 1] = s;
  for (int r = len - 1; r >= 1; --r) {
    s = ps[r * K + s];
    out[r - 1] = s;
  }
}

// E-step scan: warp 0 forward over the chunk totals (ain (B, n, K), the
// incoming alpha at frame c L - 1 normalized to max 0; ll (B,)), warp 1
// backward (bout (B, n, K), the outgoing beta at the chunk's last frame
// normalized to max 0).
template <int KM>
__global__ void __launch_bounds__(64)
est_scan_kernel(int n, int K, const double* __restrict__ F,
                double* __restrict__ ain, double* __restrict__ bout,
                double* __restrict__ ll) {
  const long long b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int jj = lane < K ? lane : K - 1;
  const double* Fb = F + b * n * K * K;
  if (warp == 0) {
    double v = Fb[jj];
    double off = 0.0;
    for (int c = 1; c < n; ++c) {
      const double M = lane_max<KM>(v, K);
      const double vin = v - M;
      off = __dadd_rn(off, M);
      if (lane < K) ain[(b * n + c) * K + jj] = vin;
      const double* Fc = Fb + static_cast<long long>(c) * K * K;
      double w[KM];
      double mj = 0.0;
#pragma unroll
      for (int i = 0; i < KM; ++i) {
        w[i] = __dadd_rn(__shfl_sync(FULL, vin, i),
                         Fc[(i < K ? i : 0) * K + jj]);
        if (i < K && (i == 0 || w[i] > mj)) mj = w[i];
      }
      double s = 0.0;
#pragma unroll
      for (int i = 0; i < KM; ++i)
        if (i < K) s = i == 0 ? exp(w[i] - mj) : __dadd_rn(s, exp(w[i] - mj));
      v = __dadd_rn(mj, log(s));
    }
    const double l = lane_logsumexp<KM>(v, K);
    if (lane == 0) ll[b] = __dadd_rn(off, l);
  } else {
    double u = 0.0;
    if (lane < K) bout[(b * n + n - 1) * K + jj] = 0.0;
    for (int c = n - 1; c >= 1; --c) {
      const double* Fc = Fb + static_cast<long long>(c) * K * K;
      double w[KM];
      double mi = 0.0;
#pragma unroll
      for (int j = 0; j < KM; ++j) {
        w[j] = __dadd_rn(Fc[jj * K + (j < K ? j : 0)],
                         __shfl_sync(FULL, u, j));
        if (j < K && (j == 0 || w[j] > mi)) mi = w[j];
      }
      double s = 0.0;
#pragma unroll
      for (int j = 0; j < KM; ++j)
        if (j < K) s = j == 0 ? exp(w[j] - mi) : __dadd_rn(s, exp(w[j] - mi));
      const double un = __dadd_rn(mi, log(s));
      const double M = lane_max<KM>(un, K);
      u = un - M;
      if (lane < K) bout[(b * n + c - 1) * K + jj] = u;
    }
  }
}

// E-step chunk pass: a block per (chunk, sequence): forward (warp 0) and
// backward (warp 1) from the chunk's boundary vectors, then every thread's
// frames' gamma and xi, reduced over the block into part (B, n, S).
template <int KM>
__global__ void __launch_bounds__(THREADS)
est_chunk_kernel(const double* __restrict__ X, int T, int D, int K, int L,
                 const double* start, const double* trans,
                 const double* means, const double* covars,
                 const double* __restrict__ ain,
                 const double* __restrict__ bout, double* __restrict__ part) {
  __shared__ Model<KM> m;
  __shared__ double lbs[CHUNK_CAP];
  __shared__ double al[CHUNK_CAP];
  __shared__ double be[CHUNK_CAP];
  __shared__ double prt[WARPS * Lay<KM>::N];
  __shared__ double stp[Lay<KM>::N];
  const int c = blockIdx.x;
  const long long b = blockIdx.y;
  const int n = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int S = n_stats(K, D);
  long long t0;
  int len;
  load_chunk<KM>(m, lbs, X, b, c, T, D, K, L, start, trans, means, covars,
                 t0, len);
  const int jj = lane < K ? lane : K - 1;
  const double* a_in = ain + (b * n + c) * K;
  if (warp == 0) {
    double lacol[KM];
#pragma unroll
    for (int i = 0; i < KM; ++i) lacol[i] = i < K ? m.la[i][jj] : 0.0;
    double a;
    int first;
    if (c == 0) {
      a = __dadd_rn(m.ls[jj], lbs[jj]);
      if (lane < K) al[jj] = a;
      first = 1;
    } else {
      a = a_in[jj];
      first = 0;
    }
    for (int s = first; s < len; ++s) {
      a = fwd_step<KM>(a, lacol, lbs[s * K + jj], K);
      if (lane < K) al[s * K + jj] = a;
    }
  } else if (warp == 1) {
    double larow[KM];
#pragma unroll
    for (int j = 0; j < KM; ++j) larow[j] = j < K ? m.la[jj][j] : 0.0;
    double bb = bout[(b * n + c) * K + jj];
    if (lane < K) be[(len - 1) * K + jj] = bb;
    for (int s = len - 2; s >= 0; --s) {
      bb = bwd_step<KM>(bb, larow, lbs[(s + 1) * K + jj], K);
      if (lane < K) be[s * K + jj] = bb;
    }
  }
  __syncthreads();
  const double* x = X + (b * T + t0) * D;
  double acc[Lay<KM>::N];
#pragma unroll
  for (int s = 0; s < Lay<KM>::N; ++s) acc[s] = 0.0;
  for (int s = tid; s < len; s += THREADS) {
    double xd[MAX_D];
#pragma unroll
    for (int d = 0; d < MAX_D; ++d)
      xd[d] = d < D ? x[static_cast<long long>(s) * D + d] : 0.0;
    // gamma: softmax over states of a + b
    double g[KM];
    double gm = 0.0;
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      g[k] = k < K ? __dadd_rn(al[s * K + k], be[s * K + k]) : 0.0;
      if (k < K && (k == 0 || g[k] > gm)) gm = g[k];
    }
    double gsum = 0.0;
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      if (k < K) {
        g[k] = exp(g[k] - gm);
        gsum = k == 0 ? g[k] : __dadd_rn(gsum, g[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      if (k < K) {
        const double gk = __ddiv_rn(g[k], gsum);
        if (c == 0 && s == 0) acc[Lay<KM>::G0 + k] = gk;
        acc[Lay<KM>::GS + k] = __dadd_rn(acc[Lay<KM>::GS + k], gk);
#pragma unroll
        for (int d = 0; d < MAX_D; ++d) {
          if (d < D) {
            double& gx = acc[Lay<KM>::GX + k * MAX_D + d];
            double& gx2 = acc[Lay<KM>::GX2 + k * MAX_D + d];
            gx = __dadd_rn(gx, __dmul_rn(gk, xd[d]));
            gx2 = __dadd_rn(gx2, __dmul_rn(gk, __dmul_rn(xd[d], xd[d])));
          }
        }
      }
    }
    // xi of the transition into frame s: softmax over (i, j)
    if (c > 0 || s > 0) {
      const double* ap = s == 0 ? a_in : al + (s - 1) * K;
      double w[KM][KM];
      double wm = 0.0;
#pragma unroll
      for (int i = 0; i < KM; ++i) {
#pragma unroll
        for (int j = 0; j < KM; ++j) {
          if (i < K && j < K) {
            w[i][j] = __dadd_rn(__dadd_rn(ap[i], m.la[i][j]),
                                __dadd_rn(lbs[s * K + j], be[s * K + j]));
            if ((i == 0 && j == 0) || w[i][j] > wm) wm = w[i][j];
          }
        }
      }
      double wsum = 0.0;
#pragma unroll
      for (int i = 0; i < KM; ++i) {
#pragma unroll
        for (int j = 0; j < KM; ++j) {
          if (i < K && j < K) {
            w[i][j] = exp(w[i][j] - wm);
            wsum = (i == 0 && j == 0) ? w[i][j] : __dadd_rn(wsum, w[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < KM; ++i) {
#pragma unroll
        for (int j = 0; j < KM; ++j) {
          if (i < K && j < K) {
            double& xs = acc[Lay<KM>::XI + i * KM + j];
            xs = __dadd_rn(xs, __ddiv_rn(w[i][j], wsum));
          }
        }
      }
    }
  }
  block_sum(acc, prt, stp);
  __syncthreads();
  double* out = part + (b * n + c) * S;
  for (int s = tid; s < S; s += THREADS) out[s] = stp[padded<KM>(s, K, D)];
}

// The chunks' partial statistics summed in chunk order: out (B, S).
__global__ void est_reduce_kernel(int n, int S, const double* __restrict__ part,
                                  double* __restrict__ out) {
  const long long b = blockIdx.x;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const double* p = part + b * n * S + s;
    double v = p[0];
    for (int c = 1; c < n; ++c) v = __dadd_rn(v, p[static_cast<long long>(c) * S]);
    out[b * S + s] = v;
  }
}

// The smallest instantiation that holds K states; 0 past 8.
int km_of(int K) { return K <= 2 ? 2 : K <= 4 ? 4 : K <= 8 ? 8 : 0; }

bool bad_shape(long long B, int T, int D, int K) {
  return B < 1 || B > 65535 || T < 1 || D < 1 || D > MAX_D || km_of(K) == 0;
}

template <int KM>
int fit_launch(const double* X, long long B, int T, int D, int K,
               const double* start, const double* trans, const double* means,
               const double* covars, int n_iter, double tol, double* o_start,
               double* o_trans, double* o_means, double* o_covars,
               double* o_ll, int* o_it, double* scratch, cudaStream_t st) {
  const size_t smem = scratch ? 0 : 3 * sizeof(double) * T * K;
  cudaError_t e = cudaFuncSetAttribute(
      hmm_fit_kernel<KM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  hmm_fit_kernel<KM><<<static_cast<unsigned>(B), THREADS, smem, st>>>(
      X, T, D, K, start, trans, means, covars, n_iter, tol, o_start, o_trans,
      o_means, o_covars, o_ll, o_it, scratch);
  return static_cast<int>(cudaGetLastError());
}

template <int KM>
int viterbi_launch(const double* X, long long B, int T, int D, int K,
                   const double* start, const double* trans,
                   const double* means, const double* covars, int* states,
                   unsigned char* scratch, cudaStream_t st) {
  const size_t smem = scratch ? 0 : vit_stride(static_cast<long long>(T) * K);
  cudaError_t e = cudaFuncSetAttribute(
      hmm_viterbi_kernel<KM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  hmm_viterbi_kernel<KM><<<static_cast<unsigned>(B), THREADS, smem, st>>>(
      X, T, D, K, start, trans, means, covars, states, scratch);
  return static_cast<int>(cudaGetLastError());
}

template <int KM>
int viterbi_chunked_launch(const double* X, long long B, int T, int D, int K,
                           int L, const double* start, const double* trans,
                           const double* means, const double* covars,
                           int* states, double* F, double* din,
                           uint8_t* psi, int* map, int* send, int* ends,
                           cudaStream_t st) {
  const int n = (T + L - 1) / L;
  const dim3 grid(n, static_cast<unsigned>(B));
  chunk_transfer_kernel<KM, false><<<grid, KM * 32, 0, st>>>(
      X, T, D, K, L, start, trans, means, covars, F);
  vit_scan_kernel<KM><<<static_cast<unsigned>(B), 32, 0, st>>>(n, K, F, din,
                                                              send);
  vit_decode_kernel<KM><<<grid, 32, 0, st>>>(X, T, D, K, L, start, trans,
                                             means, covars, din, psi, map);
  vit_compose_kernel<<<static_cast<unsigned>((B + 127) / 128), 128, 0, st>>>(
      static_cast<int>(B), n, K, send, map, ends);
  vit_backtrace_kernel<<<grid, 32, 0, st>>>(T, K, L, psi, ends, states);
  return static_cast<int>(cudaGetLastError());
}

template <int KM>
int estep_chunked_launch(const double* X, long long B, int T, int D, int K,
                         int L, const double* start, const double* trans,
                         const double* means, const double* covars,
                         double* stats, double* ll, double* F, double* ain,
                         double* bout, double* part, cudaStream_t st) {
  const int n = (T + L - 1) / L;
  const dim3 grid(n, static_cast<unsigned>(B));
  chunk_transfer_kernel<KM, true><<<grid, KM * 32, 0, st>>>(
      X, T, D, K, L, start, trans, means, covars, F);
  est_scan_kernel<KM><<<static_cast<unsigned>(B), 64, 0, st>>>(n, K, F, ain,
                                                              bout, ll);
  est_chunk_kernel<KM><<<grid, THREADS, 0, st>>>(X, T, D, K, L, start, trans,
                                                 means, covars, ain, bout,
                                                 part);
  est_reduce_kernel<<<static_cast<unsigned>(B), 64, 0, st>>>(
      n, n_stats(K, D), part, stats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Doubles of global scratch a sequence needs for hmm_fit_launch (0: its
// lb, alpha and beta fit in shared memory).
long long hmm_fit_scratch(int T, int K) {
  const size_t bytes = 3 * sizeof(double) * static_cast<size_t>(T) * K;
  return bytes <= FIT_SMEM ? 0 : 3LL * T * K;
}

// Bytes of global scratch a sequence needs for hmm_viterbi_launch.
long long hmm_viterbi_scratch(int T, int K) {
  const long long bytes = vit_stride(static_cast<long long>(T) * K);
  return bytes <= static_cast<long long>(VIT_SMEM) ? 0 : bytes;
}

int hmm_chunk_max() { return CHUNK_MAX; }

int hmm_chunk_cap() { return CHUNK_CAP; }

// Each entry launches on `stream` and returns the cudaError_t (0 =
// success), or cudaErrorInvalidValue for sizes it does not take. Every
// array is contiguous on the device: X (B, T, D), start (B, K), trans (B,
// K, K), means and covars (B, K, D), all float64.
int hmm_fit_launch(const double* X, long long B, int T, int D, int K,
                   const double* start, const double* trans,
                   const double* means, const double* covars, int n_iter,
                   double tol, double* o_start, double* o_trans,
                   double* o_means, double* o_covars, double* o_ll, int* o_it,
                   double* scratch, void* stream) {
  if (bad_shape(B, T, D, K) || n_iter < 0 ||
      (hmm_fit_scratch(T, K) > 0) != (scratch != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (km_of(K)) {
    case 2: return fit_launch<2>(X, B, T, D, K, start, trans, means, covars,
                                 n_iter, tol, o_start, o_trans, o_means,
                                 o_covars, o_ll, o_it, scratch, st);
    case 4: return fit_launch<4>(X, B, T, D, K, start, trans, means, covars,
                                 n_iter, tol, o_start, o_trans, o_means,
                                 o_covars, o_ll, o_it, scratch, st);
    default: return fit_launch<8>(X, B, T, D, K, start, trans, means, covars,
                                  n_iter, tol, o_start, o_trans, o_means,
                                  o_covars, o_ll, o_it, scratch, st);
  }
}

// states (B, T) int32.
int hmm_viterbi_launch(const double* X, long long B, int T, int D, int K,
                       const double* start, const double* trans,
                       const double* means, const double* covars,
                       int* states, unsigned char* scratch, void* stream) {
  if (bad_shape(B, T, D, K) ||
      (hmm_viterbi_scratch(T, K) > 0) != (scratch != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (km_of(K)) {
    case 2: return viterbi_launch<2>(X, B, T, D, K, start, trans, means,
                                     covars, states, scratch, st);
    case 4: return viterbi_launch<4>(X, B, T, D, K, start, trans, means,
                                     covars, states, scratch, st);
    default: return viterbi_launch<8>(X, B, T, D, K, start, trans, means,
                                      covars, states, scratch, st);
  }
}

// states (B, T) int32; scratch, n = ceil(T / L) chunks: F (B, n, K, K)
// and din (B, n, K) float64, psi (B, T, K) uint8, map (B, n, K), send (B,)
// and ends (B, n) int32.
int hmm_viterbi_chunked_launch(const double* X, long long B, int T, int D,
                               int K, int L, const double* start,
                               const double* trans, const double* means,
                               const double* covars, int* states, double* F,
                               double* din, unsigned char* psi, int* map,
                               int* send, int* ends, void* stream) {
  if (bad_shape(B, T, D, K) || L < 1 || L > CHUNK_MAX || L * K > CHUNK_CAP)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (km_of(K)) {
    case 2: return viterbi_chunked_launch<2>(X, B, T, D, K, L, start, trans,
                                             means, covars, states, F, din,
                                             psi, map, send, ends, st);
    case 4: return viterbi_chunked_launch<4>(X, B, T, D, K, L, start, trans,
                                             means, covars, states, F, din,
                                             psi, map, send, ends, st);
    default: return viterbi_chunked_launch<8>(X, B, T, D, K, L, start, trans,
                                              means, covars, states, F, din,
                                              psi, map, send, ends, st);
  }
}

// stats (B, S) float64, S = 2K + 2KD + K^2 (gamma0, sum gamma, gamma^T X,
// gamma^T X^2, sum xi), ll (B,); scratch: F (B, n, K, K), ain and bout
// (B, n, K), part (B, n, S), float64.
int hmm_estep_chunked_launch(const double* X, long long B, int T, int D,
                             int K, int L, const double* start,
                             const double* trans, const double* means,
                             const double* covars, double* stats, double* ll,
                             double* F, double* ain, double* bout,
                             double* part, void* stream) {
  if (bad_shape(B, T, D, K) || L < 1 || L > CHUNK_MAX || L * K > CHUNK_CAP)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (km_of(K)) {
    case 2: return estep_chunked_launch<2>(X, B, T, D, K, L, start, trans,
                                           means, covars, stats, ll, F, ain,
                                           bout, part, st);
    case 4: return estep_chunked_launch<4>(X, B, T, D, K, L, start, trans,
                                           means, covars, stats, ll, F, ain,
                                           bout, part, st);
    default: return estep_chunked_launch<8>(X, B, T, D, K, L, start, trans,
                                            means, covars, stats, ll, F, ain,
                                            bout, part, st);
  }
}

int hmm_n_stats(int K, int D) { return n_stats(K, D); }

const char* hmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
