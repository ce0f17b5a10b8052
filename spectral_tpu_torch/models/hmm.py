"""Diagonal-covariance Gaussian HMM in torch, float64.

The port's counterpart of ``spectral_tpu/models/hmm.py``, the replacement
for the reference's hmmlearn dependency (``hmm.GaussianHMM(n_components=4,
covariance_type="diag", n_iter=100, random_state=42)``, PlotEngine.py:20;
2-state variant at :392), with hmmlearn's Baum-Welch conventions:

  * init: uniform startprob/transmat; means from an sklearn-exact KMeans
    (the port's copy, models/kmeans.py); covariances = diag(np.cov(X.T,
    ddof=1)) + min_covar per state (host numpy, as the JAX package does);
  * M-step: covars_prior in the covariance numerator; structural zeros in
    startprob/transmat stay pinned; rows that sum to zero stay
    unnormalized; no covariance floor after init;
  * convergence: stop when the log-likelihood gain drops below tol, the
    first iteration always runs (hmmlearn's ConvergenceMonitor).

Everything is float64, as hmmlearn is: the JAX package's float32
sequential E-step drifts from a float64 oracle (0.012 at T = 601, O(1)
from T ~ 4096; spectral_tpu/models/hmm.py:20-27), this one does not.

Every function takes one sequence, X (T, D) with params of shapes (K,),
(K, K), (K, D), (K, D), or a batch, X (B, T, D) with a leading B on every
parameter (the counterpart of the JAX package's ``jax.vmap``). The private
``_*_plain`` functions are the plain torch forms; :func:`fit` and
:func:`viterbi` take them for a CPU tensor and launch the kernels of
``ops/hmm_cuda.py`` for a CUDA tensor (H1 and H2, a block a sequence).
The plain forms follow the kernels' arithmetic (``csrc/hmm.cu``, its
header), which is the JAX package's log-space recursion term for term
(-1e10 for log 0, a per-target logsumexp each step), so the kernel and
its plain version agree to rounding on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from spectral_tpu_torch.models.kmeans import kmeans_fit
from spectral_tpu_torch.ops import hmm_cuda
from spectral_tpu_torch.utils.device import DeviceLike, resolve_device

MIN_COVAR = 1e-3      # hmmlearn GaussianHMM default min_covar
COVARS_PRIOR = 1e-2   # hmmlearn default covars_prior for 'diag'
DEFAULT_TOL = 1e-2    # hmmlearn default convergence tolerance
_LOG_EPS = -1e10      # effective log(0)
_TWO_PI = 2.0 * math.pi


class HMMParams(NamedTuple):
    """HMM parameters, float64 tensors on one device (K states, D
    features; a leading batch axis on each for a batch)."""
    startprob: torch.Tensor  # (K,)
    transmat: torch.Tensor   # (K, K)
    means: torch.Tensor      # (K, D)
    covars: torch.Tensor     # (K, D) diagonal variances


def params_from_jax(startprob, transmat, means, covars,
                    device: DeviceLike = "cuda") -> HMMParams:
    """A model given as numpy arrays (the JAX package's HMMParams fields
    through ``np.asarray``) as float64 :class:`HMMParams` on device."""
    dev = resolve_device(device)
    return HMMParams(*(torch.as_tensor(np.asarray(a, np.float64), device=dev)
                       for a in (startprob, transmat, means, covars)))


def params_to_jax(params: HMMParams) -> Tuple[np.ndarray, ...]:
    """The inverse of :func:`params_from_jax`: the four fields as float64
    numpy arrays, ``spectral_tpu.models.hmm.HMMParams(*map(jnp.asarray,
    ...))`` builds the JAX package's model from them."""
    return tuple(p.detach().cpu().numpy().astype(np.float64) for p in params)


# ---------------------------------------------------------------------------
# Batch handling
# ---------------------------------------------------------------------------

def _as_batch(params: HMMParams, X: torch.Tensor
              ) -> Tuple[HMMParams, torch.Tensor, bool]:
    """(params, X) with a batch axis, and whether one was added."""
    if X.dim() == 2:
        return HMMParams(*(p.unsqueeze(0) for p in params)), X[None], True
    if X.dim() != 3:
        raise ValueError(f"X must be (T, D) or (B, T, D), got "
                         f"{tuple(X.shape)}")
    B = X.shape[0]
    if params.startprob.dim() == 1:
        params = HMMParams(*(p.unsqueeze(0).expand((B,) + p.shape)
                             for p in params))
    return params, X, False


def _kernel_operands(params: HMMParams, X: torch.Tensor):
    """Contiguous float64 operands of the kernels."""
    return (X.to(torch.float64).contiguous(),
            tuple(p.to(torch.float64).contiguous() for p in params))


def _unbatch(squeeze: bool, *ts):
    return tuple(t[0] for t in ts) if squeeze else ts


def _cpu_only(t: torch.Tensor, name: str) -> None:
    """The lattice functions have no kernel (the kernels return statistics
    and paths, not lattices): they run for a CPU tensor and refuse any
    other, so a CUDA tensor never reaches a plain version."""
    if t.device.type != "cpu":
        raise ValueError(
            f"{name} computes the plain lattice on CPU tensors only; on "
            f"{t.device} use fit, score or viterbi, which launch the "
            "kernels")


# ---------------------------------------------------------------------------
# The plain forms (batched: X (B, T, D), params with a leading B)
# ---------------------------------------------------------------------------

def _safe_log(p: torch.Tensor) -> torch.Tensor:
    return torch.where(p > 0, torch.log(torch.clamp_min(p, 1e-300)),
                       torch.full_like(p, _LOG_EPS))


def _seq_sum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over dim in index order, as the kernels sum over states and
    features."""
    out = t.select(dim, 0)
    for i in range(1, t.shape[dim]):
        out = out + t.select(dim, i)
    return out


def _log_emission_b(params: HMMParams, X: torch.Tensor) -> torch.Tensor:
    v = torch.clamp_min(params.covars, 1e-12)
    l2pv = torch.log(_TWO_PI * v)
    diff = X[..., :, None, :] - params.means[..., None, :, :]
    term = diff * diff / v[..., None, :, :] + l2pv[..., None, :, :]
    return -0.5 * _seq_sum(term, -1)


def _lse_b(v: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last axis: M + log(sum exp(v - M))."""
    M = v.amax(dim=-1, keepdim=True)
    return M[..., 0] + torch.log(_seq_sum(torch.exp(v - M), -1))


def _fwd_step(a: torch.Tensor, LA: torch.Tensor, lbt: torch.Tensor
              ) -> torch.Tensor:
    """One forward step: a (..., K) the previous log alpha, LA (..., K, K)
    the log transition matrix, lbt (..., K): lb_j + logsumexp_i(a_i +
    LA[i, j]), as max + log(sum exp(w - max))."""
    w = a[..., :, None] + LA
    m = w.amax(dim=-2, keepdim=True)
    s = torch.exp(w - m).sum(dim=-2)
    return lbt + (m[..., 0, :] + torch.log(s))


def _bwd_step(b: torch.Tensor, LA: torch.Tensor, lbn: torch.Tensor
              ) -> torch.Tensor:
    """One backward step from b = log beta[t+1], lbn = lb[t+1]:
    logsumexp_j(LA[i, j] + (lbn_j + b_j))."""
    w = LA + (lbn + b)[..., None, :]
    m = w.amax(dim=-1, keepdim=True)
    return m[..., 0] + torch.log(torch.exp(w - m).sum(dim=-1))


def _vit_step(d: torch.Tensor, LA: torch.Tensor, lbt: torch.Tensor):
    """One Viterbi step: (max_i (d_i + LA[i, j]) + lb_j, the first i
    attaining the max)."""
    sc = d[..., :, None] + LA
    best = sc[..., 0, :]
    arg = torch.zeros(best.shape, dtype=torch.int64, device=d.device)
    for i in range(1, sc.shape[-2]):
        better = sc[..., i, :] > best
        best = torch.where(better, sc[..., i, :], best)
        arg = torch.where(better, torch.full_like(arg, i), arg)
    return best + lbt, arg


def _first_argmax(v: torch.Tensor) -> torch.Tensor:
    """The first index of the max over the last axis (jnp.argmax)."""
    best = v[..., 0]
    arg = torch.zeros(best.shape, dtype=torch.int64, device=v.device)
    for j in range(1, v.shape[-1]):
        better = v[..., j] > best
        best = torch.where(better, v[..., j], best)
        arg = torch.where(better, torch.full_like(arg, j), arg)
    return arg


def _forward_b(params: HMMParams, lb: torch.Tensor):
    A = _safe_log(params.transmat)
    a = _safe_log(params.startprob) + lb[:, 0]
    out = [a]
    for t in range(1, lb.shape[1]):
        a = _fwd_step(a, A, lb[:, t])
        out.append(a)
    return torch.stack(out, dim=1), _lse_b(a)


def _backward_b(params: HMMParams, lb: torch.Tensor) -> torch.Tensor:
    A = _safe_log(params.transmat)
    b = torch.zeros_like(lb[:, 0])
    out = [b]
    for t in range(lb.shape[1] - 2, -1, -1):
        b = _bwd_step(b, A, lb[:, t + 1])
        out.append(b)
    return torch.stack(out[::-1], dim=1)


def _moments(gamma: torch.Tensor, X: torch.Tensor):
    """(sum gamma, gamma^T X, gamma^T X^2) over frames: (B, T, K) and (B,
    T, D) -> (B, K), (B, K, D), (B, K, D); elementwise products and sums,
    no matrix product (so no TF32 path exists)."""
    g = gamma[..., None]
    return (gamma.sum(dim=1), (g * X[:, :, None, :]).sum(dim=1),
            (g * (X * X)[:, :, None, :]).sum(dim=1))


def _e_step_b(params: HMMParams, X: torch.Tensor):
    """Sequential E-step: (gamma (B, T, K), xi_sum (B, K, K), ll (B,))."""
    lb = _log_emission_b(params, X)
    al, ll = _forward_b(params, lb)
    be = _backward_b(params, lb)
    gamma = torch.exp((al + be) - ll[:, None, None])
    LA = _safe_log(params.transmat)
    xi_log = ((al[:, :-1, :, None] + LA[:, None])
              + (lb[:, 1:] + be[:, 1:])[:, :, None, :]) - ll[:, None, None,
                                                             None]
    return gamma, torch.exp(xi_log).sum(dim=1), ll


def _stats_from(gamma: torch.Tensor, xi_sum: torch.Tensor, X: torch.Tensor):
    """The statistics tuple (gamma0, sum gamma, gamma^T X, gamma^T X^2,
    sum xi) of ops/hmm_cuda.py::split_stats."""
    gs, gx, gx2 = _moments(gamma, X)
    return gamma[:, 0], gs, gx, gx2, xi_sum


def _e_step_stats_plain(params: HMMParams, X: torch.Tensor):
    """The sequential E-step's statistics and log-likelihood (batched)."""
    gamma, xi_sum, ll = _e_step_b(params, X)
    return _stats_from(gamma, xi_sum, X), ll


def _m_step_stats(params: HMMParams, stats,
                  covars_prior: float = COVARS_PRIOR) -> HMMParams:
    """hmmlearn's M-step (_BaseHMM._do_mstep and GaussianHMM._do_mstep
    'diag', priors at their defaults) from the statistics, batched; the
    same operations, in the same order over states, as the H1 kernel's."""
    g0, gs, gx, gx2, xi = stats
    num_s = torch.where(params.startprob == 0, torch.zeros_like(g0), g0)
    ssum = _seq_sum(num_s, -1)[..., None]
    start = num_s / torch.where(ssum == 0, torch.ones_like(ssum), ssum)
    num_t = torch.where(params.transmat == 0, torch.zeros_like(xi), xi)
    rsum = _seq_sum(num_t, -1)[..., None]
    trans = num_t / torch.where(rsum == 0, torch.ones_like(rsum), rsum)
    denom = gs[..., None]
    means = torch.where(denom > 0, gx / torch.clamp_min(denom, 1e-30),
                        params.means)
    num = (gx2 - (2.0 * means) * gx) + (means * means) * denom
    covars = (covars_prior + num) / torch.clamp_min(denom, 1e-5)
    return HMMParams(start, trans, means, covars)


def _select(mask: torch.Tensor, new: HMMParams, old: HMMParams) -> HMMParams:
    return HMMParams(*(torch.where(mask.view((-1,) + (1,) * (n.dim() - 1)),
                                   n, o) for n, o in zip(new, old)))


def _em_loop(e_step_stats, params0: HMMParams, X: torch.Tensor, n_iter: int,
             tol: float):
    """The Baum-Welch loop on the host (batched): each sequence runs
    while ``it < n_iter and (it == 0 or ll - prev_ll >= tol)``, as each
    element of the JAX package's vmapped while_loop does
    (spectral_tpu/models/hmm.py:188-208); one device-to-host read of the
    continue flags an iteration. e_step_stats(params, X) -> (stats, ll)."""
    B = X.shape[0]
    dev = X.device
    params = params0
    prev = torch.full((B,), -math.inf, dtype=torch.float64, device=dev)
    ll = prev.clone()
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    while True:
        active = (it < n_iter) & ((it == 0) | (ll - prev >= tol))
        if not bool(active.any()):
            break
        stats, cur = e_step_stats(params, X)
        params = _select(active, _m_step_stats(params, stats), params)
        prev = torch.where(active, ll, prev)
        ll = torch.where(active, cur, ll)
        it = torch.where(active, it + 1, it)
    return params, ll, it


def _fit_plain(params0: HMMParams, X: torch.Tensor, n_iter: int, tol: float):
    """The plain version of the H1 kernel (batched)."""
    return _em_loop(_e_step_stats_plain, params0, X, n_iter, tol)


def _viterbi_plain(params: HMMParams, X: torch.Tensor) -> torch.Tensor:
    """The plain version of the H2 kernel's block-a-sequence form
    (batched): (B, T) int32."""
    lb = _log_emission_b(params, X)
    LA = _safe_log(params.transmat)
    d = _safe_log(params.startprob) + lb[:, 0]
    psi = []
    for t in range(1, lb.shape[1]):
        d, arg = _vit_step(d, LA, lb[:, t])
        psi.append(arg)
    s = _first_argmax(d)
    states = [s]
    for arg in reversed(psi):
        s = arg.gather(1, s[:, None])[:, 0]
        states.append(s)
    return torch.stack(states[::-1], dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# The JAX package's functions
# ---------------------------------------------------------------------------

def log_emission(params: HMMParams, X: torch.Tensor) -> torch.Tensor:
    """Framewise diagonal-Gaussian log-likelihood: (..., T, D) -> (..., T,
    K)."""
    return _log_emission_b(params, X)


def forward_log(params: HMMParams, log_b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log-space forward pass: (log_alpha (T, K), loglik); batched too.
    CPU tensors only (the kernels run it inside fit and score)."""
    _cpu_only(log_b, "forward_log")
    params, lb, sq = _as_batch(params, log_b)
    return _unbatch(sq, *_forward_b(params, lb))


def backward_log(params: HMMParams, log_b: torch.Tensor) -> torch.Tensor:
    """Log-space backward pass: log_beta (T, K); batched too. CPU tensors
    only."""
    _cpu_only(log_b, "backward_log")
    params, lb, sq = _as_batch(params, log_b)
    return _unbatch(sq, _backward_b(params, lb))[0]


def score(params: HMMParams, X: torch.Tensor) -> torch.Tensor:
    """Sequence log-likelihood under the model; batched too. For a CUDA
    tensor the H3 kernel's log-likelihood (one launch), the plain forward
    pass for a CPU tensor."""
    params, X, sq = _as_batch(params, X)
    if X.device.type == "cpu":
        ll = _forward_b(params, _log_emission_b(params, X))[1]
    else:
        K = params.startprob.shape[-1]
        _, ll = hmm_cuda.estep_chunked(*_kernel_operands(params, X),
                                       hmm_cuda.chunk_len(K))
    return _unbatch(sq, ll)[0]


def _e_step(params: HMMParams, X: torch.Tensor):
    """(gamma (T, K), xi_sum (K, K), loglik); batched too. CPU tensors
    only (gamma is a lattice; on the card fit runs the E-step)."""
    _cpu_only(X, "_e_step")
    params, X, sq = _as_batch(params, X)
    return _unbatch(sq, *_e_step_b(params, X))


def _m_step(params: HMMParams, X: torch.Tensor, gamma: torch.Tensor,
            xi_sum: torch.Tensor, covars_prior: float = COVARS_PRIOR
            ) -> HMMParams:
    """The M-step from the E-step's gamma and xi_sum (the JAX package's
    signature); batched too."""
    params, X, sq = _as_batch(params, X)
    if sq:
        gamma, xi_sum = gamma[None], xi_sum[None]
    out = _m_step_stats(params, _stats_from(gamma, xi_sum, X), covars_prior)
    return HMMParams(*_unbatch(sq, *out))


def viterbi(params: HMMParams, X: torch.Tensor) -> torch.Tensor:
    """Most-likely state sequence (hmmlearn .predict): (T, D) -> (T,)
    int32, or (B, T, D) -> (B, T). One launch of the H2 kernel (a block a
    sequence) for a CUDA tensor, the plain form for a CPU tensor."""
    params, X, sq = _as_batch(params, X)
    if X.device.type == "cpu":
        states = _viterbi_plain(params, X)
    else:
        states = hmm_cuda.viterbi_seq(*_kernel_operands(params, X))
    return _unbatch(sq, states)[0]


def fit(params0: HMMParams, X: torch.Tensor, n_iter: int = 100,
        tol: float = DEFAULT_TOL):
    """Baum-Welch EM: (params, final loglik, n_iterations_run); a batch
    fits every sequence to its own convergence. One launch of the H1
    kernel for a CUDA tensor (the whole loop on the card), the plain loop
    for a CPU tensor."""
    params0, X, sq = _as_batch(params0, X)
    if X.device.type == "cpu":
        params, ll, it = _fit_plain(params0, X.to(torch.float64), n_iter,
                                    tol)
    else:
        Xk, pk = _kernel_operands(params0, X)
        p, ll, it = hmm_cuda.fit_seq(Xk, pk, n_iter, tol)
        params = HMMParams(*p)
    if sq:
        return HMMParams(*(p[0] for p in params)), ll[0], it[0]
    return params, ll, it


# ---------------------------------------------------------------------------
# Initialization (host-side, deterministic)
# ---------------------------------------------------------------------------

def kmeans(X: np.ndarray, k: int, seed: int = 42, n_init: int = 10,
           max_iter: int = 300) -> np.ndarray:
    """hmmlearn's GaussianHMM means initialization: sklearn
    ``cluster.KMeans(n_clusters=k, random_state=seed, n_init=10)`` on the
    features, through the port's copy of the sklearn-exact k-means."""
    centers, _labels, _inertia = kmeans_fit(X, k, seed=seed, n_init=n_init,
                                            max_iter=max_iter)
    return centers


def _host(X) -> np.ndarray:
    if isinstance(X, torch.Tensor):
        return X.detach().cpu().numpy().astype(np.float64)
    return np.asarray(X, dtype=np.float64)


def init_params(X, k: int, seed: int = 42, min_covar: float = MIN_COVAR,
                device: DeviceLike = "cuda") -> HMMParams:
    """hmmlearn GaussianHMM._init, on the host in numpy: uniform
    start/trans, sklearn-KMeans means, diagonal of ``np.cov(X.T) +
    min_covar*I`` (ddof=1) tiled per state; float64 on device."""
    dev = resolve_device(device)
    Xh = _host(X)
    means = kmeans(Xh, k, seed=seed)
    if Xh.shape[0] > 1:
        var = np.var(Xh, axis=0, ddof=1) + min_covar
    else:
        var = np.full(Xh.shape[1], min_covar)
    return params_from_jax(np.full((k,), 1.0 / k), np.full((k, k), 1.0 / k),
                           means, np.tile(var, (k, 1)), dev)


# ---------------------------------------------------------------------------
# Closed-form supervised fit (PlotEngine._train_supervised, :328-387)
# ---------------------------------------------------------------------------

def supervised_fit(features, labels, n_states: int,
                   device: DeviceLike = "cuda") -> HMMParams:
    """Exact reproduction of the reference's closed-form supervised fit, on
    the host in float64.

    Per state: >1 samples -> (mean, var + 1e-6); ==1 sample -> (x, 1e-6);
    ==0 samples -> (0, 1e-6). Transition counts row-normalized; rows with no
    outgoing transitions get self-probability 1; if n_states > 3 row 3 is
    forced to a deterministic 3 -> 0 transition; startprob = [1, 0, 0, ...].
    """
    X = _host(features)
    labels = np.asarray(labels)
    D = X.shape[1]
    means, covars = [], []
    for i in range(n_states):
        sf = X[labels == i]
        if sf.shape[0] > 1:
            means.append(sf.mean(axis=0))
            covars.append(sf.var(axis=0) + 1e-6)
        elif sf.shape[0] == 1:
            means.append(sf[0])
            covars.append(np.ones(D) * 1e-6)
        else:
            means.append(np.zeros(D))
            covars.append(np.ones(D) * 1e-6)

    transmat = np.zeros((n_states, n_states))
    for i in range(len(labels) - 1):
        transmat[labels[i], labels[i + 1]] += 1
    row_sums = transmat.sum(axis=1, keepdims=True)
    with np.errstate(invalid="ignore"):
        transmat_prob = np.divide(transmat, row_sums,
                                  out=np.zeros_like(transmat),
                                  where=row_sums != 0)
    for s in np.where(row_sums.flatten() == 0)[0]:
        transmat_prob[s, s] = 1.0
    if n_states > 3:
        transmat_prob[3, :] = 0.0
        transmat_prob[3, 0] = 1.0

    startprob = np.zeros(n_states)
    startprob[0] = 1.0
    return params_from_jax(startprob, transmat_prob, np.asarray(means),
                           np.asarray(covars), device)


# ---------------------------------------------------------------------------
# Unsupervised transmat "escape route" patch (PlotEngine.py:423-437)
# ---------------------------------------------------------------------------

def patch_escape_routes(transmat, baseline_state: int) -> np.ndarray:
    """For every non-baseline state with < 1e-5 probability of reaching the
    baseline and self-transition > 0.1, donate min(5% of self, 0.05) to the
    baseline transition (host numpy)."""
    tm = np.array(_host(transmat), dtype=np.float64, copy=True)
    k = tm.shape[0]
    for i in range(k):
        if i == baseline_state:
            continue
        if tm[i, baseline_state] < 1e-5 and tm[i, i] > 0.1:
            donation = min(tm[i, i] * 0.05, 0.05)
            tm[i, i] -= donation
            tm[i, baseline_state] += donation
    return tm


def patch_escape_routes_traced(transmat: torch.Tensor,
                               baseline_state: torch.Tensor) -> torch.Tensor:
    """:func:`patch_escape_routes` in torch on transmat's device, batched
    too (transmat (..., K, K), baseline_state (...,)): the same arithmetic
    with one-hot masks, no host read."""
    K = transmat.shape[-1]
    idx = torch.arange(K, device=transmat.device)
    base = torch.as_tensor(baseline_state, device=transmat.device)[..., None]
    onehot_b = (idx == base).to(transmat.dtype)
    diag = torch.diagonal(transmat, dim1=-2, dim2=-1)
    tm_b = torch.gather(transmat, -1, base[..., None].expand(
        transmat.shape[:-1] + (1,)))[..., 0]
    cond = (idx != base) & (tm_b < 1e-5) & (diag > 0.1)
    donation = torch.where(cond, torch.clamp_max(diag * 0.05, 0.05),
                           torch.zeros_like(diag))
    return ((transmat - torch.diag_embed(donation))
            + donation[..., :, None] * onehot_b[..., None, :])


def _decode_patched(fit_fn, viterbi_fn, params0, X, n_iter, tol):
    params, ll, it = fit_fn(params0, X, n_iter=n_iter, tol=tol)
    baseline = torch.argmin(params.means[..., 0], dim=-1)   # PlotEngine.py:445
    params = params._replace(
        transmat=patch_escape_routes_traced(params.transmat, baseline))
    states = viterbi_fn(params, X)
    return params, states, baseline, ll, it


def unsupervised_fit_decode(params0: HMMParams, X: torch.Tensor,
                            n_iter: int = 100, tol: float = DEFAULT_TOL):
    """The reference's whole unrefined detection compute
    (PlotEngine.py:411-445): EM fit, baseline = argmin mean log-power,
    transmat escape-route patch, Viterbi decode; batched too. On the card:
    the H1 launch, the patch in torch, the H2 launch, no host read.
    Returns (patched_params, states, baseline_state, loglik, n_iters)."""
    return _decode_patched(fit, viterbi, params0, X, n_iter, tol)
