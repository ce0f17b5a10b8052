// The Gaussian HMM's recursions for NVIDIA Hopper (sm_90a): Baum-Welch,
// the chunked E-step with its EM loop, and Viterbi, in float64.
//
// The JAX package has no Pallas kernel here: its HMM runs as jitted
// lax.scan / lax.while_loop programs vmapped over sweeps
// (spectral_tpu/models/hmm.py:75-208, hmm_pscan.py:289-377,
// models/batch.py:42-45). In eager PyTorch such a loop costs a launch a
// step, so each recursion is a kernel of its own, one launch serving a
// whole batch of sequences. The plain PyTorch versions are
// models/hmm.py::_fit_plain / _viterbi_plain and
// models/hmm_pscan.py::_e_step_stats_plain / _viterbi_plain (the chunked
// EM loop: models/hmm.py::_em_loop over _e_step_stats_plain), which follow
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
// the same order; a max runs in index order with a strict >, the first
// element first; sums over frames are reduced in a fixed tree with no
// atomics, so a rerun gives the same bits.
//
// Why this log form: a step in scaled probabilities would need no
// transcendental, but supervised_fit's 1e-6 variances put emission
// log-likelihoods 1e5 apart, and a step whose best-emitting state is
// (nearly) unreachable then underflows the scale to 0; one shared max a
// step (one exp a source state) underflows a state whose only routes lie
// 745 nats below the best to -inf, and the sequential and chunked forms
// then disagree on where. The per-target max above keeps every value
// finite (-1e10 stands for log 0) and exact at any emission scale.
//
// The K^2-lane step (KM 2 and 4; k2_step, k2_lse): a step's K targets
// each need K exps. With a state a lane, a lane issues all K of them: they
// overlap in latency, but each costs its own float64 instructions, and
// the H100's 64 FP64 units an SM set the pace wherever many chains share
// an SM (the transfers: 2,048 chunks x 4 starts at once). So a group of
// KM^2 lanes (16 at K = 4, 4 at K = 2; two or eight groups a warp, their
// shuffles of width KM^2) holds one term each: lane (o, r), o = q / KM, r =
// q % KM for the lane q of its group, o the state the step computes and r
// the state summed over. Every lane of row o holds that row's value. A
// step: the K previous values by K shuffles (as the one-state-a-lane step
// gathered them), the row's K terms w_o0 .. w_o,K-1 and their max in index
// order (the same adds, compares and order: signed zeros and -1e10 land
// as before), ONE exp, exp(w_or - m_o), then the row's K exps by K
// shuffles summed in index order, the log and the emission's add. The
// operations and their order are the one-state-a-lane step's, so the
// bits are; a lane issues one exp where it issued K, at one more round of
// K shuffles on the chain. Lanes past K (K < KM) compute on clamped
// indices and are never summed. KM 8 (K 5-8, off every driven path)
// keeps the one-state-a-lane step (fwd_step, bwd_step).
//
// hmm_fit_kernel (H1; hmm_fit_launch): Baum-Welch for a batch of
//   sequences, one block of 128 threads a sequence running the whole EM
//   loop in one launch (_em_loop's while_loop, hmm.py:188-208): per
//   iteration the emissions (all threads, into lb), the forward pass on
//   warp 0 and the backward pass on warp 1 side by side (K^2 lanes at KM
//   2 and 4, h1_chains; H1_ONE_WARP puts both in warp 0, lanes 0-15 and
//   16-31), the statistics gamma = exp(a + b - ll) and xi = exp(((a + LA)
//   + (lb + b)) - ll) over frames (all threads, frames strided, then a
//   warp butterfly and the warps in order), the M-step with hmmlearn's
//   rules (hmm.py:152-185) and the convergence rule it == 0 || ll - prev
//   >= tol. lb, a and b (T x K float64 each, 102.7 KB at T = 1,070, K = 4:
//   two blocks an SM) live in shared memory up to FIT_SMEM bytes, past it
//   in a global scratch the wrapper allocates.
//   Bound: the dependent chain, not bytes or operations: T - 1 steps of
//   (K shuffles, K adds and a max, an exp, K shuffles, K adds, a log) a
//   pass, the two passes concurrent; the roofline's bytes (X read once,
//   the parameters written once) take well under a microsecond.
// hmm_viterbi_kernel (H2, T < 2048 on the main path; hmm_viterbi_launch):
//   one block a sequence, three phases:
//   emissions: every thread the first VIT_EM_FIRST frames' lb, then warps
//     1-3 the rest, VIT_EM_TILE frames a tile, each tile published to the
//     chain through a flag in shared memory (after a barrier of the three
//     warps), so they run beside the chain, not before it;
//   the chain on warp 0, a state a lane (vit_step: the K values gathered
//     by shuffles, the adds and strict-> compares in index order), K at
//     compile time where K == KM, waiting on the flag once a tile; lanes
//     below K store the step's uint8 backpointers, then the end state.
//     Every lane holding all K values (vit_scan_kernel's form, no shuffle
//     on the chain) measured three times slower here: at K = 4 a lane then
//     issues four targets' adds and compares a step, so the chain is
//     bound by one warp's issue rather than the shuffles' latency;
//   the backtrace on all 128 threads, exact: thread i takes the i-th run
//     of frames and composes its backpointers into its map (for each
//     state at the run's last frame, the state before its first: K walks
//     side by side), the maps are composed from the end in log2(128)
//     rounds (a suffix scan of integer maps, hmm_pscan.py:322-355's
//     composition inside one block), and each thread re-walks its run from
//     its end state, the states staged in shared memory and stored
//     coalesced. Integer maps compose exactly: the states are the
//     one-thread walk's.
//   lb and the backpointers live in shared memory up to VIT_SMEM bytes,
//   past it in a global scratch (the emissions then all before the chain,
//   the states stored directly). Bound: the chain of T - 1 dependent
//   steps; the roofline's bytes (X read once, the states written once)
//   take under 2 us.
// The chunked forms (T >= 2048), chunks of L frames (CHUNK_MAX at most):
//   hmm_viterbi_chunked_launch (H2 chunked), five kernels:
//     vit_transfer: each chunk c >= 1 runs the recursion from each one-hot
//       start state (a warp a start state) to its K x K max-plus transfer
//       F_c; chunk 0 runs from the initial vector;
//     vit_scan: one warp a sequence walks the chunks in order: each
//       chunk's incoming delta (normalized to max 0) and, at the end, the
//       end state; every lane holds the step's K values (no shuffles on
//       the chain) and the transfers are streamed into shared memory
//       SCAN_TILE chunks ahead of it by cp.async;
//     vit_decode: each chunk re-runs its recursion from its incoming delta,
//       writes its backpointers and composes them into its state map (the
//       state at the chunk's first frame - 1 for each end state);
//     vit_compose: a block a sequence stages its maps in shared memory,
//       COMPOSE_TILE chunks a tile by cp.async, and one thread walks the
//       chunks backwards through them (hmm_pscan.py:322-355's suffix
//       composition);
//     vit_backtrace: each chunk walks its own backpointers from its end
//       state.
//   H3, the chunked E-step, four kernels: est_transfer (each chunk's K x K
//     log-semiring transfer from each one-hot start state, two starts a
//     warp at K = 4; chunk 0 its end vector), est_scan (a forward and a
//     backward chain a sequence over the chunk totals, K^2 lanes each, the
//     transfers streamed into shared memory SCAN_TILE chunks ahead of the
//     chain by cp.async, two buffers a chain: every chunk's incoming alpha
//     and outgoing beta normalized to max 0, the offsets summed into the
//     log-likelihood; the chunks associated one after another), est_chunk
//     (each chunk re-runs forward and backward from its boundary vectors
//     and sums gamma = softmax(a + b) and xi = softmax((a + LA) + (lb +
//     b)) and their moments over its frames) and a reduce (the chunks'
//     partial sums in chunk order, staged through shared memory in
//     coalesced tiles by cp.async, the next tile fetched while one is
//     summed). hmm_estep_chunked_launch runs them once with
//     est_reduce (hmm.score's E-step); hmm_fit_chunked_launch runs the EM
//     loop on the device: n_group iterations a call, each the four kernels
//     with est_mstep in the reduce's place (the reduce, the M-step of
//     hmm_fit_kernel, and _em_loop's bookkeeping prev = ll, ll = cur, it +=
//     1, active = it < n_iter && (it == 0 || ll - prev >= tol)). Every
//     kernel takes the sequence's active flag and a block of an inactive
//     sequence returns at once, so a group may run past convergence at
//     the cost of empty launches; the host reads the flags once a group
//     (ops/hmm_cuda.py::EM_GROUP).
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
constexpr bool K2_ONE_EXP = true;            // one exp a lane, then gathered
constexpr bool H1_ONE_WARP = false;          // H1's two chains in one warp
constexpr bool SCAN_SMEM = true;             // the scan's F from shared memory
constexpr int SCAN_TILE = 32;                // chunks a tile of the scan's F
constexpr int COMPOSE_TILE = 512;            // chunks a tile of the maps
constexpr int COMPOSE_THREADS = 128;         // threads of a compose block
constexpr int RED_TILE = 2048;               // doubles a tile of the reduce
constexpr int RED_SPT = 2;                   // statistics a thread, reduce
constexpr int CHUNK_MIN_BLOCKS = 4;          // chunk pass blocks an SM
constexpr int VIT_EM_FIRST = 32;             // H2's emissions before the chain
constexpr int VIT_EM_TILE = 64;              // frames a tile of the rest
constexpr bool VIT_EM_OVERLAP = true;        // the rest beside the chain

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

// ---------------------------------------------------------------------------
// The K^2-lane step (KM 2 and 4): lane q of a group of KM^2 lanes is (o, r),
// o = q / KM the state the step computes, r = q % KM the state summed over;
// every lane of row o holds that row's value. Shuffles are of width KM^2.
// ---------------------------------------------------------------------------

// The K values of the group's rows (row i's from lane (i, 0)) into vi, and
// their max in index order.
template <int KM>
__device__ __forceinline__ double k2_rows(double v, double (&vi)[KM], int K) {
  double M = 0.0;
#pragma unroll
  for (int i = 0; i < KM; ++i) {
    vi[i] = __shfl_sync(FULL, v, i * KM, KM * KM);
    if (i < K && (i == 0 || vi[i] > M)) M = vi[i];
  }
  return M;
}

// m + log(sum_i exp(w_i - m)) over the row's K terms w (m their max), the
// sum in index order: the lane's own exp, exp(w_r - m), gathered from the
// row's lanes (K2_ONE_EXP), or all K exps on each lane.
template <int KM>
__device__ __forceinline__ double k2_lse(const double (&w)[KM], double m,
                                         int o, int r, int K) {
  double s = 0.0;
  if constexpr (K2_ONE_EXP) {
    double own = w[0];
#pragma unroll
    for (int i = 1; i < KM; ++i)
      if (i == r) own = w[i];
    const double e = exp(own - m);
#pragma unroll
    for (int i = 0; i < KM; ++i) {
      const double ei = __shfl_sync(FULL, e, o * KM + i, KM * KM);
      if (i < K) s = i == 0 ? ei : __dadd_rn(s, ei);
    }
  } else {
#pragma unroll
    for (int i = 0; i < KM; ++i)
      if (i < K) s = i == 0 ? exp(w[i] - m) : __dadd_rn(s, exp(w[i] - m));
  }
  return __dadd_rn(m, log(s));
}

// One step of a chain on K^2 lanes. Forward (fwd): x is row o's a[t-1, o],
// coef[i] = LA[i, o], lbv = lb[t, o]; returns a[t, o] as fwd_step does.
// Backward: x is row o's b[t+1, o], coef[j] = LA[o, j], lbv = lb[t+1, o];
// returns b[t, o] as bwd_step does (u_j = lb[t+1, j] + b[t+1, j], w_oj =
// LA[o, j] + u_j: the same sum, IEEE addition being commutative).
template <int KM>
__device__ __forceinline__ double k2_step(double x, double lbv,
                                          const double (&coef)[KM], bool fwd,
                                          int o, int r, int K) {
  const double u = fwd ? x : __dadd_rn(lbv, x);
  double w[KM];
  double m = 0.0;
#pragma unroll
  for (int i = 0; i < KM; ++i) {
    w[i] = __dadd_rn(__shfl_sync(FULL, u, i * KM, KM * KM), coef[i]);
    if (i < K && (i == 0 || w[i] > m)) m = w[i];
  }
  const double s = k2_lse<KM>(w, m, o, r, K);
  return fwd ? __dadd_rn(lbv, s) : s;
}

// lane_logsumexp over the group's rows: M + log(sum_i exp(v_i - M)), one
// exp a lane (row 0's lane i computes exp(v_i - M)).
template <int KM>
__device__ __forceinline__ double k2_logsumexp(double v, int r, int K) {
  double vi[KM];
  const double M = k2_rows<KM>(v, vi, K);
  double own = vi[0];
#pragma unroll
  for (int i = 1; i < KM; ++i)
    if (i == r) own = vi[i];
  const double e = exp(own - M);
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < KM; ++i) {
    const double ei = __shfl_sync(FULL, e, i, KM * KM);
    if (i < K) s = i == 0 ? ei : __dadd_rn(s, ei);
  }
  return __dadd_rn(M, log(s));
}

// cp.async of one double from device to shared memory (sm_80 on)
__device__ __forceinline__ void cp_async_f64(double* dst, const double* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}
// cp.async of one 32-bit word
__device__ __forceinline__ void cp_async_b32(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
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

// H1's chains on K^2 lanes (KM 2 and 4): DIR 1 the forward pass into al
// (and the log-likelihood into ll_out), -1 the backward pass into be, 0
// both in one warp, lanes 0-15 forward and 16-31 backward. lb, al and be
// are T x K; the first group of the chain (of each half-warp when DIR is
// 0) stores.
template <int KM, int DIR>
__device__ __forceinline__ void h1_chains(const Model<KM>& m, const double* lb,
                                          double* al, double* be, int T, int K,
                                          double* ll_out) {
  constexpr int G = KM * KM;
  const int lane = threadIdx.x & 31;
  const bool fwd = DIR == 0 ? lane < 16 : DIR > 0;
  const int q = lane % G;
  const int o = q / KM;
  const int r = q % KM;
  const int oo = o < K ? o : K - 1;
  const bool lead = (DIR == 0 ? lane & 15 : lane) < G && r == 0 && o < K;
  double coef[KM];
#pragma unroll
  for (int i = 0; i < KM; ++i)
    coef[i] = i < K ? (fwd ? m.la[i][oo] : m.la[oo][i]) : 0.0;
  double x = fwd ? __dadd_rn(m.ls[oo], lb[oo]) : 0.0;
  if (lead) {
    if (fwd) al[o] = x;
    else be[static_cast<long long>(T - 1) * K + o] = 0.0;
  }
  for (int k = 1; k < T; ++k) {
    const int t = fwd ? k : T - 1 - k;
    x = k2_step<KM>(x, lb[static_cast<long long>(fwd ? t : t + 1) * K + oo],
                    coef, fwd, o, r, K);
    if (lead) (fwd ? al : be)[static_cast<long long>(t) * K + o] = x;
  }
  if (DIR >= 0) {
    const double l = k2_logsumexp<KM>(x, r, K);
    if (lane == 0) *ll_out = l;
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
    if constexpr (KM <= 4) {               // K^2 lanes
      if (H1_ONE_WARP && warp == 0)
        h1_chains<KM, 0>(m, lb, al, be, T, K, &ll_sh);
      else if (!H1_ONE_WARP && warp == 0)
        h1_chains<KM, 1>(m, lb, al, be, T, K, &ll_sh);
      else if (!H1_ONE_WARP && warp == 1)
        h1_chains<KM, -1>(m, lb, al, be, T, K, &ll_sh);
    } else if (warp == 0) {                // forward, lanes = target states
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

// A barrier of the n threads from warp 1 on (warps 1-3), id 1.
__device__ __forceinline__ void em_barrier(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// The emissions of frames [t0, t1) into lb (row t at t K) from x (row t at
// t D), by `nthreads` threads, this one the tid-th (i / K and i % K on a
// K known at compile time where K == KM).
template <int KM, int KC>
__device__ __forceinline__ void vit_emissions(const Model<KM>& m, double* lb,
                                              const double* x, int t0,
                                              int t1, int Kr, int D, int tid,
                                              int nthreads) {
  const int K = KC ? KC : Kr;
  for (int i = t0 * K + tid; i < t1 * K; i += nthreads)
    lb[i] = emission<KM>(m, x + (i / K) * D, i % K, D);
}

// H2's chain on warp 0, lane j on state j: d[t, j] = max_i (d[t - 1, i]
// + LA[i, j]) + lb[t, j] by vit_step (the K values gathered by shuffles,
// the adds and strict-> compares in index order), the first i attaining
// the max into psi's row t (lanes below K store). Steps 1 .. first - 1
// first, then a tile of VIT_EM_TILE frames at a time, each once `ready`
// (frames whose lb is written) has passed its last frame; returns the end
// state (the first j attaining the max of d[T - 1]).
template <int KM, int KC>
__device__ __forceinline__ int vit_chain(const Model<KM>& m, const double* lb,
                                         uint8_t* psi, int T, int Kr,
                                         int first, const int* ready) {
  const int K = KC ? KC : Kr;
  const int lane = threadIdx.x & 31;
  const int jj = lane < K ? lane : K - 1;
  double lacol[KM];
#pragma unroll
  for (int i = 0; i < KM; ++i) lacol[i] = i < K ? m.la[i][jj] : 0.0;
  double d = __dadd_rn(m.ls[jj], lb[jj]);
  for (int t0 = 1, t1 = first; t0 < T;
       t0 = t1, t1 = min(T, t1 + VIT_EM_TILE)) {
    if (t1 > first) {
      // every lane sees `ready` reach t1 itself
      while (__reduce_min_sync(FULL, *reinterpret_cast<const volatile int*>(
                                         ready)) < t1) {
      }
      __threadfence_block();
    }
    for (int t = t0; t < t1; ++t) {
      int arg;
      d = vit_step<KM>(d, lacol, lb[static_cast<long long>(t) * K + jj], K,
                       arg);
      if (lane < K) psi[static_cast<long long>(t) * K + jj] =
          static_cast<uint8_t>(arg);
    }
  }
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
  return end;
}

// H2's backtrace on the block, from end state s_end at frame T - 1
// through backpointers psi (T x K, row t the pointers into frame t - 1):
// thread i's run of rows [a, b) composed into its map (a byte a state:
// the state at frame a - 1 for each at frame b - 1), the maps composed
// from the end (maps[i] <- maps[i] o maps[i + d], d = 1, 2, ..., 64: each
// then the map from frame T - 1 to frame a - 1 of its run), then the run
// re-walked from its end state into out[0 .. T); maps is THREADS words of
// shared memory. The caller synchronizes before.
template <int KM>
__device__ __forceinline__ void vit_backtrace_block(
    const uint8_t* psi, int T, int K, int s_end, unsigned long long* maps,
    int* out) {
  const int tid = threadIdx.x;
  const long long rows = T - 1;
  const int a = 1 + static_cast<int>(tid * rows / THREADS);
  const int b = 1 + static_cast<int>((tid + 1) * rows / THREADS);
  int s[KM];
#pragma unroll
  for (int x = 0; x < KM; ++x) s[x] = x;
  for (int t = b - 1; t >= a; --t) {
    const uint8_t* p = psi + static_cast<long long>(t) * K;
#pragma unroll
    for (int x = 0; x < KM; ++x)
      if (x < K) s[x] = p[s[x]];
  }
  unsigned long long map = 0;
#pragma unroll
  for (int x = 0; x < KM; ++x)
    map |= static_cast<unsigned long long>(s[x]) << (8 * x);
  maps[tid] = map;
  __syncthreads();
  for (int d = 1; d < THREADS; d <<= 1) {
    const unsigned long long cur = maps[tid];
    const unsigned long long nxt = tid + d < THREADS ? maps[tid + d] : 0;
    __syncthreads();
    if (tid + d < THREADS) {
      unsigned long long m = 0;
#pragma unroll
      for (int x = 0; x < KM; ++x)
        m |= ((cur >> (8 * ((nxt >> (8 * x)) & 0xff))) & 0xff) << (8 * x);
      maps[tid] = m;
    }
    __syncthreads();
  }
  // the state at frame b - 1: the later runs' map applied to s_end
  int st = tid + 1 < THREADS
      ? static_cast<int>((maps[tid + 1] >> (8 * s_end)) & 0xff) : s_end;
  if (tid == THREADS - 1) out[T - 1] = s_end;
  for (int t = b - 1; t >= a; --t) {
    st = psi[static_cast<long long>(t) * K + st];
    out[t - 1] = st;
  }
}

template <int KM, int KC>
__global__ void __launch_bounds__(THREADS)
hmm_viterbi_kernel(const double* __restrict__ X, int T, int D, int K,
                   const double* start, const double* trans,
                   const double* means, const double* covars,
                   int* __restrict__ states, unsigned char* scratch) {
  extern __shared__ double dyn[];
  __shared__ Model<KM> m;
  __shared__ unsigned long long maps[THREADS];
  __shared__ int ready, s_end;
  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const long long n = static_cast<long long>(T) * K;
  double* lb = scratch
      ? reinterpret_cast<double*>(scratch + b * vit_stride(n)) : dyn;
  uint8_t* psi = reinterpret_cast<uint8_t*>(lb + n);
  const double* x = X + b * T * D;
  load_model<KM>(m, b, K, D, start, trans, means, covars);
  __syncthreads();
  derive<KM>(m, K, D);
  __syncthreads();
  // the global scratch's lb is read through L1: all of it before the chain
  const int first = VIT_EM_OVERLAP && !scratch ? min(T, VIT_EM_FIRST) : T;
  vit_emissions<KM, KC>(m, lb, x, 0, first, K, D, tid, THREADS);
  if (tid == 0) ready = first;
  __syncthreads();
  if (tid >= 32) {
    for (int t0 = first; t0 < T; t0 += VIT_EM_TILE) {
      const int t1 = min(T, t0 + VIT_EM_TILE);
      vit_emissions<KM, KC>(m, lb, x, t0, t1, K, D, tid - 32, THREADS - 32);
      __threadfence_block();
      em_barrier(THREADS - 32);
      if (tid == 32) {
        __threadfence_block();
        *reinterpret_cast<volatile int*>(&ready) = t1;
      }
    }
  } else {
    const int end = vit_chain<KM, KC>(m, lb, psi, T, K, first, &ready);
    if (tid == 0) s_end = end;
  }
  __syncthreads();
  // the states staged over lb (no longer read) when it is in shared
  // memory, then stored coalesced; into `states` directly otherwise
  int* out = scratch ? states + b * T : reinterpret_cast<int*>(dyn);
  vit_backtrace_block<KM>(psi, T, K, s_end, maps, out);
  if (!scratch) {
    __syncthreads();
    for (int i = tid; i < T; i += THREADS) states[b * T + i] = out[i];
  }
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

// Threads of an H3 transfer block: the K^2 form's groups (two a warp at KM
// 4, eight at KM 2) hold a start each; KM 8 a warp a start.
template <int KM>
constexpr int transfer_threads() {
  return KM == 4 ? 64 : KM == 2 ? 32 : KM * 32;
}

// H3's transfers: a block per (chunk, sequence); each group of K^2 lanes
// (KM 8: each warp) runs the forward recursion from one one-hot start
// state; chunk 0's first group from the initial vector. active (B,) or
// null: a block of an inactive sequence returns at once.
template <int KM>
__global__ void __launch_bounds__(transfer_threads<KM>())
est_transfer_kernel(const double* __restrict__ X, int T, int D, int K, int L,
                    const double* start, const double* trans,
                    const double* means, const double* covars,
                    const unsigned char* __restrict__ active,
                    double* __restrict__ F) {
  __shared__ Model<KM> m;
  __shared__ double lbs[CHUNK_CAP];
  const int c = blockIdx.x;
  const long long b = blockIdx.y;
  if (active && !active[b]) return;
  const int n = gridDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long t0;
  int len;
  load_chunk<KM>(m, lbs, X, b, c, T, D, K, L, start, trans, means, covars,
                 t0, len);
  if constexpr (KM > 4) {                  // a warp a start, lanes = states
    if (warp >= K || (c == 0 && warp > 0)) return;
    const int jj = lane < K ? lane : K - 1;
    double col[KM];
#pragma unroll
    for (int i = 0; i < KM; ++i) col[i] = i < K ? m.la[i][jj] : 0.0;
    double v;
    int first;
    if (c == 0) {
      v = __dadd_rn(m.ls[jj], lbs[jj]);
      first = 1;
    } else {
      v = jj == warp ? 0.0 : -INFINITY;
      first = 0;
    }
    for (int s = first; s < len; ++s)
      v = fwd_step<KM>(v, col, lbs[s * K + jj], K);
    if (lane < K) F[((b * n + c) * K + warp) * K + jj] = v;
  } else {                                 // a group of K^2 lanes a start
    constexpr int G = KM * KM;
    if (c == 0 && warp > 0) return;
    const int g = threadIdx.x / G;
    const int from = g < K ? g : K - 1;
    const int q = lane % G;
    const int o = q / KM;
    const int r = q % KM;
    const int oo = o < K ? o : K - 1;
    double col[KM];
#pragma unroll
    for (int i = 0; i < KM; ++i) col[i] = i < K ? m.la[i][oo] : 0.0;
    double v;
    int first;
    if (c == 0) {
      v = __dadd_rn(m.ls[oo], lbs[oo]);
      first = 1;
    } else {
      v = oo == from ? 0.0 : -INFINITY;
      first = 0;
    }
    for (int s = first; s < len; ++s)
      v = k2_step<KM>(v, lbs[s * K + oo], col, true, o, r, K);
    if (r == 0 && o < K && g < (c == 0 ? 1 : K))
      F[((b * n + c) * K + from) * K + o] = v;
  }
}

// Viterbi scan: one warp a sequence over the chunks in order. din (B, n,
// K) receives each chunk's incoming delta normalized to max 0; send (B,)
// the end state at frame T - 1. Every lane holds all K values of the step
// and computes them all (lane 0 stores): the same adds and strict-> maxes
// in index order as a state a lane gave, with no shuffle on the chain. The
// transfers reach the chain from shared memory, SCAN_TILE chunks a tile,
// the next tile fetched by cp.async while the chain walks this one. KC: K
// at compile time (K == KM, the launcher's choice when it is), so a step
// issues no index arithmetic or guard for K; 0 takes K = Kr at run time.
template <int KM, int KC>
__global__ void __launch_bounds__(32)
vit_scan_kernel(int n, int Kr, const double* __restrict__ F,
                double* __restrict__ din, int* __restrict__ send) {
  __shared__ __align__(16) double tiles[2][SCAN_TILE * KM * KM];
  const int K = KC ? KC : Kr;
  const long long b = blockIdx.x;
  const int lane = threadIdx.x;
  const int KK = K * K;
  const double* Fb = F + b * n * KK;
  const int ntiles = (n + SCAN_TILE - 1) / SCAN_TILE;
  // tile t (chunks t SCAN_TILE ..) into buffer t & 1, one commit group a
  // tile (an empty one past the last)
  auto fetch = [&](int t) {
    if (t < ntiles) {
      const long long c0 = static_cast<long long>(t) * SCAN_TILE;
      const int cnt = static_cast<int>(
          min(static_cast<long long>(SCAN_TILE), n - c0)) * KK;
      double* dst = tiles[t & 1];
      const double* src = Fb + c0 * KK;
      for (int i = lane; i < cnt; i += 32) cp_async_f64(dst + i, src + i);
    }
    cp_async_commit();
  };
  // chunk c's transfer in its tile's buffer
  auto transfer = [&](int c) -> const double* {
    return tiles[(c / SCAN_TILE) & 1] + (c % SCAN_TILE) * KK;
  };
  double v[KM];
#pragma unroll
  for (int j = 0; j < KM; ++j) v[j] = Fb[j < K ? j : 0];
  fetch(0);
  for (int t = 0; t < ntiles; ++t) {
    fetch(t + 1);
    cp_async_wait_one();
    __syncwarp();
    const int c1 = min(n, (t + 1) * SCAN_TILE);
    for (int c = t == 0 ? 1 : t * SCAN_TILE; c < c1; ++c) {
      const double* Fc = transfer(c);
      double M = v[0];
#pragma unroll
      for (int i = 1; i < KM; ++i)
        if (i < K && v[i] > M) M = v[i];
      double vin[KM];
#pragma unroll
      for (int i = 0; i < KM; ++i) vin[i] = v[i] - M;
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < KM; ++j)
          if (j < K) din[(b * n + c) * K + j] = vin[j];
      }
#pragma unroll
      for (int j = 0; j < KM; ++j) {
        const int jj = j < K ? j : 0;
        double best = __dadd_rn(vin[0], Fc[jj]);
#pragma unroll
        for (int i = 1; i < KM; ++i) {
          const double sc = __dadd_rn(vin[i], Fc[(i < K ? i : 0) * K + jj]);
          if (i < K && sc > best) best = sc;
        }
        v[j] = best;
      }
    }
    __syncwarp();
  }
  double best = v[0];
  int end = 0;
#pragma unroll
  for (int j = 1; j < KM; ++j) {
    if (j < K && v[j] > best) {
      best = v[j];
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
// state at each chunk's last frame. A block a sequence: its maps (n, K)
// reach shared memory COMPOSE_TILE chunks a tile, coalesced, by cp.async,
// the tile before fetched while thread 0 walks this one backwards, so no
// chunk of the walk waits on a load from global memory.
template <int KM>
__global__ void __launch_bounds__(COMPOSE_THREADS)
vit_compose_kernel(int n, int K, const int* __restrict__ send,
                   const int* __restrict__ map, int* __restrict__ ends) {
  __shared__ __align__(16) int tiles[2][COMPOSE_TILE * KM];
  const long long b = blockIdx.x;
  const int* mb = map + b * n * K;
  const int ntiles = (n + COMPOSE_TILE - 1) / COMPOSE_TILE;
  auto fetch = [&](int t) {
    if (t >= 0) {
      const long long c0 = static_cast<long long>(t) * COMPOSE_TILE;
      const int cnt = static_cast<int>(
          min(static_cast<long long>(COMPOSE_TILE), n - c0)) * K;
      int* dst = tiles[t & 1];
      const int* src = mb + c0 * K;
      for (int i = threadIdx.x; i < cnt; i += COMPOSE_THREADS)
        cp_async_b32(dst + i, src + i);
    }
    cp_async_commit();
  };
  int s = send[b];
  fetch(ntiles - 1);
  for (int t = ntiles - 1; t >= 0; --t) {
    fetch(t - 1);
    cp_async_wait_one();
    __syncthreads();
    if (threadIdx.x == 0) {
      const int c0 = t * COMPOSE_TILE;
      const int* m = tiles[t & 1];
      for (int c = min(n, c0 + COMPOSE_TILE) - 1; c >= (c0 > 1 ? c0 : 1);
           --c) {
        ends[b * n + c] = s;
        s = m[(c - c0) * K + s];
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) ends[b * n] = s;
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

// E-step scan: a block of two warps a sequence; warp 0 forward over the
// chunk totals (ain (B, n, K), the incoming alpha at frame c L - 1
// normalized to max 0; ll (B,)), warp 1 backward (bout (B, n, K), the
// outgoing beta at the chunk's last frame normalized to max 0). At KM 2
// and 4 each chain runs on K^2 lanes (its warp's other groups repeat it)
// and reads the transfers from shared memory, SCAN_TILE chunks a tile,
// the next tile fetched by cp.async while the chain walks this one; KM 8
// keeps a state a lane and reads them from global memory. active (B,) or
// null.
template <int KM>
__global__ void __launch_bounds__(64)
est_scan_kernel(int n, int K, const double* __restrict__ F,
                double* __restrict__ ain, double* __restrict__ bout,
                double* __restrict__ ll,
                const unsigned char* __restrict__ active) {
  const long long b = blockIdx.x;
  if (active && !active[b]) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const double* Fb = F + b * n * K * K;
  if constexpr (KM > 4) {
    const int jj = lane < K ? lane : K - 1;
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
  } else {
    constexpr int G = KM * KM;
    __shared__ double tiles[2][2][SCAN_TILE * KM * KM];   // [warp][buffer]
    const int KK = K * K;
    const int q = lane % G;
    const int o = q / KM;
    const int r = q % KM;
    const int oo = o < K ? o : K - 1;
    const bool lead = lane < G && r == 0 && o < K;
    const int ntiles = (n + SCAN_TILE - 1) / SCAN_TILE;
    // tile t (chunks t SCAN_TILE ..) into buffer t & 1 of this warp, one
    // commit group a tile (an empty one past the last)
    auto fetch = [&](int t) {
      if (SCAN_SMEM && t >= 0 && t < ntiles) {
        const long long c0 = static_cast<long long>(t) * SCAN_TILE;
        const int cnt = static_cast<int>(
            min(static_cast<long long>(SCAN_TILE), n - c0)) * KK;
        double* dst = tiles[warp][t & 1];
        const double* src = Fb + c0 * KK;
        for (int i = lane; i < cnt; i += 32) cp_async_f64(dst + i, src + i);
      }
      cp_async_commit();
    };
    // chunk c's transfer: in the tile buffer, or global memory
    auto transfer = [&](int c) -> const double* {
      if (!SCAN_SMEM) return Fb + static_cast<long long>(c) * KK;
      return tiles[warp][(c / SCAN_TILE) & 1] + (c % SCAN_TILE) * KK;
    };
    if (warp == 0) {
      double v = Fb[oo];
      double off = 0.0;
      fetch(0);
      for (int t = 0; t < ntiles; ++t) {
        fetch(t + 1);
        cp_async_wait_one();
        __syncwarp();
        const int c1 = min(n, (t + 1) * SCAN_TILE);
        for (int c = t == 0 ? 1 : t * SCAN_TILE; c < c1; ++c) {
          const double* Fc = transfer(c);
          double vi[KM];
          const double M = k2_rows<KM>(v, vi, K);
          off = __dadd_rn(off, M);
          if (lead) ain[(b * n + c) * K + o] = v - M;
          double w[KM];
          double mj = 0.0;
#pragma unroll
          for (int i = 0; i < KM; ++i) {
            w[i] = __dadd_rn(vi[i] - M, Fc[(i < K ? i : 0) * K + oo]);
            if (i < K && (i == 0 || w[i] > mj)) mj = w[i];
          }
          v = k2_lse<KM>(w, mj, o, r, K);
        }
        __syncwarp();
      }
      const double l = k2_logsumexp<KM>(v, r, K);
      if (lane == 0) ll[b] = __dadd_rn(off, l);
    } else {
      double u = 0.0;
      if (lead) bout[(b * n + n - 1) * K + o] = 0.0;
      fetch(ntiles - 1);
      for (int t = ntiles - 1; t >= 0; --t) {
        fetch(t - 1);
        cp_async_wait_one();
        __syncwarp();
        for (int c = min(n, (t + 1) * SCAN_TILE) - 1;
             c >= (t == 0 ? 1 : t * SCAN_TILE); --c) {
          const double* Fc = transfer(c);
          double ui[KM];
          k2_rows<KM>(u, ui, K);
          double w[KM];
          double mi = 0.0;
#pragma unroll
          for (int j = 0; j < KM; ++j) {
            w[j] = __dadd_rn(Fc[oo * K + (j < K ? j : 0)], ui[j]);
            if (j < K && (j == 0 || w[j] > mi)) mi = w[j];
          }
          const double un = k2_lse<KM>(w, mi, o, r, K);
          double uni[KM];
          const double M = k2_rows<KM>(un, uni, K);
          u = un - M;
          if (lead) bout[(b * n + c - 1) * K + o] = u;
        }
        __syncwarp();
      }
    }
  }
}

// E-step chunk pass: a block per (chunk, sequence): forward (warp 0) and
// backward (warp 1) from the chunk's boundary vectors (K^2 lanes at KM 2
// and 4, the warp's other groups repeating the chain), then every
// thread's frames' gamma and xi, reduced over the block into part (B, n,
// S). active (B,) or null. At KM 2 and 4, CHUNK_MIN_BLOCKS blocks an SM
// (128 registers): the chains wait on latency, and four blocks' chains
// beside each other beat two blocks' without the statistics' spills.
template <int KM>
__global__ void __launch_bounds__(THREADS, KM <= 4 ? CHUNK_MIN_BLOCKS : 1)
est_chunk_kernel(const double* __restrict__ X, int T, int D, int K, int L,
                 const double* start, const double* trans,
                 const double* means, const double* covars,
                 const double* __restrict__ ain,
                 const double* __restrict__ bout,
                 const unsigned char* __restrict__ active,
                 double* __restrict__ part) {
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
  if (active && !active[b]) return;
  long long t0;
  int len;
  load_chunk<KM>(m, lbs, X, b, c, T, D, K, L, start, trans, means, covars,
                 t0, len);
  const int jj = lane < K ? lane : K - 1;
  const double* a_in = ain + (b * n + c) * K;
  if constexpr (KM <= 4) {
    constexpr int G = KM * KM;
    const int q = lane % G;
    const int o = q / KM;
    const int r = q % KM;
    const int oo = o < K ? o : K - 1;
    const bool lead = lane < G && r == 0 && o < K;
    if (warp == 0) {                       // forward from ain
      double col[KM];
#pragma unroll
      for (int i = 0; i < KM; ++i) col[i] = i < K ? m.la[i][oo] : 0.0;
      double a;
      int first;
      if (c == 0) {
        a = __dadd_rn(m.ls[oo], lbs[oo]);
        if (lead) al[o] = a;
        first = 1;
      } else {
        a = a_in[oo];
        first = 0;
      }
      for (int s = first; s < len; ++s) {
        a = k2_step<KM>(a, lbs[s * K + oo], col, true, o, r, K);
        if (lead) al[s * K + o] = a;
      }
    } else if (warp == 1) {                // backward from bout
      double row[KM];
#pragma unroll
      for (int j = 0; j < KM; ++j) row[j] = j < K ? m.la[oo][j] : 0.0;
      double bb = bout[(b * n + c) * K + oo];
      if (lead) be[(len - 1) * K + o] = bb;
      for (int s = len - 2; s >= 0; --s) {
        bb = k2_step<KM>(bb, lbs[(s + 1) * K + oo], row, false, o, r, K);
        if (lead) be[s * K + o] = bb;
      }
    }
  } else if (warp == 0) {
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

// The chunks' partial statistics p (n x S, one sequence's) summed in chunk
// order into out[0..S), staged through shared memory whole chunks at a
// time in coalesced cp.async copies, two tiles of RED_TILE doubles (tile
// holds both), the next fetched while this one is summed; thread s sums
// statistic s (and s + blockDim.x): the first chunk's value, then each
// next chunk's added. Every thread of the block calls it.
__device__ void reduce_chunks(const double* __restrict__ p, int n, int S,
                              double* tile, double* out) {
  const int per = RED_TILE / S;                 // chunks a tile
  const int ntiles = (n + per - 1) / per;
  auto fetch = [&](int t) {
    if (t < ntiles) {
      const long long c0 = static_cast<long long>(t) * per;
      const int cnt = static_cast<int>(
          min(static_cast<long long>(per), n - c0)) * S;
      double* dst = tile + (t & 1) * RED_TILE;
      for (int i = threadIdx.x; i < cnt; i += blockDim.x)
        cp_async_f64(dst + i, p + c0 * S + i);
    }
    cp_async_commit();
  };
  double v[RED_SPT];
#pragma unroll
  for (int k = 0; k < RED_SPT; ++k) v[k] = 0.0;
  fetch(0);
  for (int t = 0; t < ntiles; ++t) {
    fetch(t + 1);
    cp_async_wait_one();
    __syncthreads();
    const double* tl = tile + (t & 1) * RED_TILE;
    const int nc = static_cast<int>(
        min(static_cast<long long>(per), n - static_cast<long long>(t) * per));
#pragma unroll
    for (int k = 0; k < RED_SPT; ++k) {
      const int s = threadIdx.x + k * blockDim.x;
      if (s < S) {
        int c = 0;
        if (t == 0) v[k] = tl[c++ * S + s];
#pragma unroll 8
        for (; c < nc; ++c) v[k] = __dadd_rn(v[k], tl[c * S + s]);
      }
    }
    __syncthreads();                // this buffer is refilled at t + 2
  }
#pragma unroll
  for (int k = 0; k < RED_SPT; ++k) {
    const int s = threadIdx.x + k * blockDim.x;
    if (s < S) out[s] = v[k];
  }
}

// The chunks' partial statistics summed in chunk order: out (B, S).
__global__ void __launch_bounds__(THREADS)
est_reduce_kernel(int n, int S, const double* __restrict__ part,
                  double* __restrict__ out) {
  __shared__ double tile[2 * RED_TILE];
  const long long b = blockIdx.x;
  reduce_chunks(part + b * n * S, n, S, tile, out + b * S);
}

// The EM loop's last kernel an iteration (hmm_fit_chunked_launch), a block
// a sequence: the chunks' partials reduced as est_reduce does, H1's M-step
// (m_step) on the sequence's parameters in place, then _em_loop's
// bookkeeping (models/hmm.py): prev = ll, ll = cur, it += 1, active = it <
// n_iter && (it == 0 || ll - prev >= tol). A block of an inactive
// sequence returns at once, its parameters and state untouched.
template <int KM>
__global__ void __launch_bounds__(THREADS)
est_mstep_kernel(int n, int K, int D, const double* __restrict__ part,
                 const double* __restrict__ cur, int n_iter, double tol,
                 double* start, double* trans, double* means, double* covars,
                 double* ll, double* prev, int* it, unsigned char* active) {
  __shared__ Model<KM> m;
  __shared__ double tile[2 * RED_TILE];
  __shared__ double raw[RED_SPT * THREADS];
  __shared__ double st[Lay<KM>::N];
  const long long b = blockIdx.x;
  if (!active[b]) return;
  const int tid = threadIdx.x;
  const int S = n_stats(K, D);
  load_model<KM>(m, b, K, D, start, trans, means, covars);
  for (int s = tid; s < Lay<KM>::N; s += THREADS) st[s] = 0.0;
  reduce_chunks(part + b * n * S, n, S, tile, raw);
  __syncthreads();
  for (int s = tid; s < S; s += THREADS) st[padded<KM>(s, K, D)] = raw[s];
  __syncthreads();
  m_step<KM>(m, st, K, D);
  __syncthreads();
  for (int i = tid; i < K * (K > D ? K : D); i += THREADS) {
    if (i < K * K) trans[b * K * K + i] = m.trans[i / K][i % K];
    if (i < K) start[b * K + i] = m.start[i];
    if (i < K * D) {
      means[b * K * D + i] = m.means[i / D][i % D];
      covars[b * K * D + i] = m.covars[i / D][i % D];
    }
  }
  if (tid == 0) {
    const double p = ll[b];
    const double c = cur[b];
    const int i = it[b] + 1;
    prev[b] = p;
    ll[b] = c;
    it[b] = i;
    active[b] = i < n_iter && (i == 0 || __dsub_rn(c, p) >= tol);
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
  const auto kernel = K == KM ? hmm_viterbi_kernel<KM, KM>
                              : hmm_viterbi_kernel<KM, 0>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(B), THREADS, smem, st>>>(
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
  const auto scan = K == KM ? vit_scan_kernel<KM, KM> : vit_scan_kernel<KM, 0>;
  scan<<<static_cast<unsigned>(B), 32, 0, st>>>(n, K, F, din, send);
  vit_decode_kernel<KM><<<grid, 32, 0, st>>>(X, T, D, K, L, start, trans,
                                             means, covars, din, psi, map);
  vit_compose_kernel<KM><<<static_cast<unsigned>(B), COMPOSE_THREADS, 0,
                           st>>>(n, K, send, map, ends);
  vit_backtrace_kernel<<<grid, 32, 0, st>>>(T, K, L, psi, ends, states);
  return static_cast<int>(cudaGetLastError());
}

// H3's first three kernels: transfers, the scan (the log-likelihood into
// ll) and the chunk pass (the chunks' partials into part).
template <int KM>
void estep_kernels(const double* X, long long B, int T, int D, int K, int L,
                   const double* start, const double* trans,
                   const double* means, const double* covars,
                   const unsigned char* active, double* ll, double* F,
                   double* ain, double* bout, double* part, cudaStream_t st) {
  const int n = (T + L - 1) / L;
  const dim3 grid(n, static_cast<unsigned>(B));
  est_transfer_kernel<KM><<<grid, transfer_threads<KM>(), 0, st>>>(
      X, T, D, K, L, start, trans, means, covars, active, F);
  est_scan_kernel<KM><<<static_cast<unsigned>(B), 64, 0, st>>>(
      n, K, F, ain, bout, ll, active);
  est_chunk_kernel<KM><<<grid, THREADS, 0, st>>>(X, T, D, K, L, start, trans,
                                                 means, covars, ain, bout,
                                                 active, part);
}

template <int KM>
int estep_chunked_launch(const double* X, long long B, int T, int D, int K,
                         int L, const double* start, const double* trans,
                         const double* means, const double* covars,
                         double* stats, double* ll, double* F, double* ain,
                         double* bout, double* part, cudaStream_t st) {
  const int n = (T + L - 1) / L;
  estep_kernels<KM>(X, B, T, D, K, L, start, trans, means, covars, nullptr,
                    ll, F, ain, bout, part, st);
  est_reduce_kernel<<<static_cast<unsigned>(B), THREADS, 0, st>>>(
      n, n_stats(K, D), part, stats);
  return static_cast<int>(cudaGetLastError());
}

template <int KM>
int fit_chunked_launch(const double* X, long long B, int T, int D, int K,
                       int L, double* start, double* trans, double* means,
                       double* covars, int n_iter, double tol, int n_group,
                       double* ll, double* prev, int* it,
                       unsigned char* active, double* cur, double* F,
                       double* ain, double* bout, double* part,
                       cudaStream_t st) {
  const int n = (T + L - 1) / L;
  for (int g = 0; g < n_group; ++g) {
    estep_kernels<KM>(X, B, T, D, K, L, start, trans, means, covars, active,
                      cur, F, ain, bout, part, st);
    est_mstep_kernel<KM><<<static_cast<unsigned>(B), THREADS, 0, st>>>(
        n, K, D, part, cur, n_iter, tol, start, trans, means, covars, ll,
        prev, it, active);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
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

// The chunked EM loop on the device: n_group iterations, each the
// E-step's first three kernels and est_mstep, every kernel gated by the
// sequence's active flag. start, trans, means and covars are updated in
// place; ll, prev (B,) float64, it (B,) int32 and active (B,) uint8 are
// the loop's state, which the caller sets before its first call (-inf,
// -inf, 0, n_iter > 0) and reads after any; scratch: cur (B,), F (B, n, K,
// K), ain and bout (B, n, K), part (B, n, S), float64.
int hmm_fit_chunked_launch(const double* X, long long B, int T, int D, int K,
                           int L, double* start, double* trans,
                           double* means, double* covars, int n_iter,
                           double tol, int n_group, double* ll, double* prev,
                           int* it, unsigned char* active, double* cur,
                           double* F, double* ain, double* bout, double* part,
                           void* stream) {
  if (bad_shape(B, T, D, K) || L < 1 || L > CHUNK_MAX || L * K > CHUNK_CAP ||
      n_iter < 0 || n_group < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (km_of(K)) {
    case 2: return fit_chunked_launch<2>(X, B, T, D, K, L, start, trans, means,
                                         covars, n_iter, tol, n_group, ll,
                                         prev, it, active, cur, F, ain, bout,
                                         part, st);
    case 4: return fit_chunked_launch<4>(X, B, T, D, K, L, start, trans, means,
                                         covars, n_iter, tol, n_group, ll,
                                         prev, it, active, cur, F, ain, bout,
                                         part, st);
    default: return fit_chunked_launch<8>(X, B, T, D, K, L, start, trans,
                                          means, covars, n_iter, tol, n_group,
                                          ll, prev, it, active, cur, F, ain,
                                          bout, part, st);
  }
}

int hmm_n_stats(int K, int D) { return n_stats(K, D); }

const char* hmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
