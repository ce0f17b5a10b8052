"""Chunked-scan HMM inference for long recordings, float64.

The port's counterpart of ``spectral_tpu/models/hmm_pscan.py``: the same
contracts as :mod:`spectral_tpu_torch.models.hmm` (signatures, return
values), computed as a two-level scan over chunks of L frames, the form
the card runs (``ops/hmm_cuda.py``: H3 for the E-step, H2's chunked form
for Viterbi):

  1. every chunk c >= 1 computes its K x K transfer from each one-hot start
     state (log-semiring for the E-step, max-plus for Viterbi); chunk 0
     its end vector from the initial distribution;
  2. a scan over the chunk totals gives every chunk its incoming alpha (or
     delta) and outgoing beta, each normalized to max 0, the offsets
     summed into the log-likelihood;
  3. every chunk re-runs its recursions from its boundary vectors: the
     E-step sums gamma_t = softmax(a_t + b_t) and xi_t = softmax over (i,
     j) of (a_{t-1,i} + logA_ij) + (lb_tj + b_tj), the offsets cancelling
     inside each softmax; Viterbi writes its backpointers, composes them
     into a state map per chunk, and a backward walk over the maps gives
     each chunk its end state (the JAX module's suffix composition,
     :322-355) before each chunk backtraces alone.

The plain forms here vectorize step s of every chunk at once; the kernels
run a chunk a block. Both follow csrc/hmm.cu's arithmetic, so on the card
the kernel and the plain version agree to rounding (the same paths, the
statistics and log-likelihood to ~1e-12 relative).

The JAX module carries its offsets as a compensated (hi, lo) float32
pair (Knuth's two-sum, :87) because float32 would lose the per-state
differences at large T; in float64 the offset of a 524,288-frame
recording (~1e7) keeps 1e-9 absolute resolution, so the two-sum is not
needed: the tests hold the log-likelihood to the float64 oracle instead.

Routing is the JAX package's: ``BurstDetector(engine='auto')`` takes this
engine from :data:`SEQ_SAFE_T` frames. In float64 the sequential form would
serve at any T; the threshold is kept so both packages route the same
problems the same way.
"""

from __future__ import annotations

import math

import torch

from spectral_tpu_torch.models import hmm
from spectral_tpu_torch.ops import hmm_cuda
from spectral_tpu_torch.ops.hmm_cuda import chunk_len, n_stats, split_stats
from spectral_tpu_torch.models.hmm import (
    DEFAULT_TOL, HMMParams, _as_batch, _bwd_step, _cpu_only, _first_argmax,
    _fwd_step,
    _kernel_operands, _log_emission_b, _lse_b, _moments, _safe_log,
    _unbatch, _vit_step)

# At or above this many frames BurstDetector(engine='auto') and
# models/batch.py take this engine (spectral_tpu/models/hmm_pscan.py:84).
SEQ_SAFE_T = 2048


class _Chunks:
    """Frame t = c L + s of a (B, T, ...) tensor at [:, c, s]: n chunks,
    the last padded; ``valid`` (n, L) marks real frames, ``last`` (n,) each
    chunk's last frame."""

    def __init__(self, T: int, L: int, device):
        self.T, self.L = T, L
        self.n = math.ceil(T / L)
        frame = torch.arange(self.n * L, device=device).view(self.n, L)
        self.valid = frame < T
        self.last = torch.clamp_max(torch.full((self.n,), L - 1,
                                               device=device),
                                    T - 1 - torch.arange(self.n,
                                                         device=device) * L)
        first = torch.zeros((self.n, L), dtype=torch.bool, device=device)
        first[0, 0] = True
        self.first = first                   # frame 0 (no step into it)

    def split(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.n * self.L - self.T
        if pad:
            x = torch.cat([x, x[:, -1:].expand((x.shape[0], pad)
                                                + x.shape[2:])], dim=1)
        return x.reshape((x.shape[0], self.n, self.L) + x.shape[2:])


def _where(mask, new, old):
    """mask (n,) or (n, ...) over the chunk axis of (B, n, ...) tensors."""
    while mask.dim() < new.dim() - 1:
        mask = mask[..., None]
    return torch.where(mask[None], new, old)


def _transfers(params: HMMParams, lbc: torch.Tensor, ch: _Chunks,
               logsum: bool) -> torch.Tensor:
    """(B, n, K, K): chunk c >= 1's transfer from each one-hot start state
    (rows), chunk 0's end vector in every row."""
    B, n, L, K = lbc.shape
    dev = lbc.device
    onehot = torch.where(torch.eye(K, dtype=torch.bool, device=dev),
                         torch.zeros((), dtype=torch.float64, device=dev),
                         torch.full((), -math.inf, dtype=torch.float64,
                                    device=dev))
    v = onehot.expand(B, n, K, K).clone()
    v[:, 0] = (_safe_log(params.startprob) + lbc[:, 0, 0])[:, None, :]
    LA = _safe_log(params.transmat)[:, None, None]
    for s in range(L):
        lbt = lbc[:, :, s, None, :]
        new = _fwd_step(v, LA, lbt) if logsum else _vit_step(v, LA, lbt)[0]
        v = _where(ch.valid[:, s] & ~ch.first[:, s], new, v)
    return v


def _scan_forward(F: torch.Tensor, logsum: bool):
    """(incoming vectors (B, n, K) normalized to max 0, their offsets (B,
    n), the final vector (B, K) and its offset (B,))."""
    B, n, K, _ = F.shape
    v = F[:, 0, 0]
    off = torch.zeros(B, dtype=torch.float64, device=F.device)
    vin_all = torch.zeros((B, n, K), dtype=torch.float64, device=F.device)
    offs = torch.zeros((B, n), dtype=torch.float64, device=F.device)
    for c in range(1, n):
        M = v.amax(dim=-1, keepdim=True)
        vin = v - M
        off = off + M[:, 0]
        vin_all[:, c] = vin
        offs[:, c] = off
        w = vin[:, :, None] + F[:, c]
        if logsum:
            mj = w.amax(dim=1, keepdim=True)
            v = mj[:, 0] + torch.log(torch.exp(w - mj).sum(dim=1))
        else:
            v = w.amax(dim=1)
    return vin_all, offs, v, off


def _scan_backward(F: torch.Tensor):
    """(outgoing beta (B, n, K) at each chunk's last frame, normalized to
    max 0, and its offset (B, n))."""
    B, n, K, _ = F.shape
    u = torch.zeros((B, K), dtype=torch.float64, device=F.device)
    off = torch.zeros(B, dtype=torch.float64, device=F.device)
    bout = torch.zeros((B, n, K), dtype=torch.float64, device=F.device)
    offs = torch.zeros((B, n), dtype=torch.float64, device=F.device)
    for c in range(n - 1, 0, -1):
        w = F[:, c] + u[:, None, :]
        mi = w.amax(dim=-1, keepdim=True)
        un = mi[..., 0] + torch.log(torch.exp(w - mi).sum(dim=-1))
        M = un.amax(dim=-1, keepdim=True)
        u = un - M
        off = off + M[:, 0]
        bout[:, c - 1] = u
        offs[:, c - 1] = off
    return bout, offs


def _chunk_passes(params: HMMParams, lbc: torch.Tensor, ch: _Chunks,
                  ain: torch.Tensor, bout: torch.Tensor):
    """Every chunk's forward and backward re-run from its boundary
    vectors: (alpha, beta), each (B, n, L, K)."""
    A = _safe_log(params.transmat)[:, None]
    a0 = _safe_log(params.startprob) + lbc[:, 0, 0]
    a = ain.clone()
    al = []
    for s in range(ch.L):
        new = _fwd_step(a, A, lbc[:, :, s])
        if s == 0:
            new[:, 0] = a0
        a = _where(ch.valid[:, s], new, a)
        al.append(a)
    b = bout.clone()
    be = [None] * ch.L
    for s in range(ch.L - 1, -1, -1):
        if s + 1 < ch.L:
            stepped = _bwd_step(b, A, lbc[:, :, s + 1])
            b = _where(s < ch.last, stepped, _where(s == ch.last, bout, b))
        else:
            b = bout
        be[s] = b
    return torch.stack(al, dim=2), torch.stack(be, dim=2)


def _e_step_parts(params: HMMParams, X: torch.Tensor, L: int):
    """(gamma (B, n, L, K), xi (B, n, L, K, K) of the transition into each
    frame, the frames' mask (n, L), ll (B,), chunks, alpha, beta and the
    offsets) of the chunked E-step."""
    B, T, D = X.shape
    ch = _Chunks(T, L, X.device)
    lbc = ch.split(_log_emission_b(params, X))
    F = _transfers(params, lbc, ch, logsum=True)
    ain, aoff, v, off = _scan_forward(F, logsum=True)
    ll = off + _lse_b(v)
    bout, boff = _scan_backward(F)
    al, be = _chunk_passes(params, lbc, ch, ain, bout)
    g = al + be
    e = torch.exp(g - g.amax(dim=-1, keepdim=True))
    gamma = e / e.sum(dim=-1, keepdim=True)
    aprev = torch.cat([ain[:, :, None], al[:, :, :-1]], dim=2)
    LA = _safe_log(params.transmat)[:, None, None]
    w = (aprev[..., :, None] + LA) + (lbc + be)[..., None, :]
    ew = torch.exp(w - w.amax(dim=(-2, -1), keepdim=True))
    xi = ew / ew.sum(dim=(-2, -1), keepdim=True)
    return gamma, xi, ll, ch, (al, aoff, be, boff)


def _e_step_stats_plain(params: HMMParams, X: torch.Tensor, L: int):
    """The plain version of the H3 kernel (batched): (statistics (B, S) in
    ops/hmm_cuda.py's layout, ll (B,))."""
    B, T, D = X.shape
    gamma, xi, ll, ch, _ = _e_step_parts(params, X, L)
    K = gamma.shape[-1]
    gmask = ch.valid[None, :, :, None]
    gamma = torch.where(gmask, gamma, torch.zeros_like(gamma))
    xmask = (ch.valid & ~ch.first)[None, :, :, None, None]
    xi = torch.where(xmask, xi, torch.zeros_like(xi))
    Xc = ch.split(X)
    gs, gx, gx2 = _moments(gamma.reshape(B, -1, K),
                           Xc.reshape(B, -1, D))
    st = torch.cat([gamma[:, 0, 0], gs, gx.reshape(B, -1),
                    gx2.reshape(B, -1), xi.sum(dim=(1, 2)).reshape(B, -1)],
                   dim=1)
    assert st.shape[1] == n_stats(K, D)
    return st, ll


def _e_step_stats_b(params: HMMParams, X: torch.Tensor):
    """One chunked E-step (batched): (statistics tuple, ll). The H3
    kernel for a CUDA tensor, the plain form for a CPU tensor."""
    K, D = params.startprob.shape[-1], X.shape[-1]
    L = chunk_len(K)
    if X.device.type == "cpu":
        st, ll = _e_step_stats_plain(params, X, L)
    else:
        st, ll = hmm_cuda.estep_chunked(*_kernel_operands(params, X), L)
    return split_stats(st, K, D), ll


def _viterbi_plain(params: HMMParams, X: torch.Tensor, L: int
                   ) -> torch.Tensor:
    """The plain version of the H2 kernel's chunked form (batched): (B, T)
    int32."""
    B, T, D = X.shape
    ch = _Chunks(T, L, X.device)
    lbc = ch.split(_log_emission_b(params, X))
    F = _transfers(params, lbc, ch, logsum=False)
    din, _, v, _ = _scan_forward(F, logsum=False)
    end = _first_argmax(v)
    LA = _safe_log(params.transmat)[:, None]
    d = din.clone()
    d[:, 0] = _safe_log(params.startprob) + lbc[:, 0, 0]
    psi = []
    for s in range(L):
        new, arg = _vit_step(d, LA, lbc[:, :, s])
        step = ch.valid[:, s] & ~ch.first[:, s]
        d = _where(step, new, d)
        psi.append(arg)
    psi = torch.stack(psi, dim=2)                     # (B, n, L, K)
    K = psi.shape[-1]
    # each chunk's map: end state -> the state at the chunk's frame - 1
    m = torch.arange(K, device=X.device).expand(B, ch.n, K).clone()
    for s in range(L - 1, -1, -1):
        stepped = psi[:, :, s].gather(-1, m)
        m = _where(s <= ch.last, stepped, m)
    ends = torch.empty((B, ch.n), dtype=torch.int64, device=X.device)
    s_end = end
    for c in range(ch.n - 1, 0, -1):
        ends[:, c] = s_end
        s_end = m[:, c].gather(-1, s_end[:, None])[:, 0]
    ends[:, 0] = s_end
    cur = ends
    states = torch.zeros((B, ch.n, L), dtype=torch.int64, device=X.device)
    for s in range(L - 1, -1, -1):
        active = (s <= ch.last)[None].expand(B, -1)
        states[:, :, s] = torch.where(active, cur, torch.zeros_like(cur))
        if s >= 1:
            nxt = psi[:, :, s].gather(-1, cur[..., None])[..., 0]
            cur = torch.where(active, nxt, cur)
    return states.reshape(B, -1)[:, :T].to(torch.int32)


# ---------------------------------------------------------------------------
# The JAX module's functions
# ---------------------------------------------------------------------------

def forward_log(params: HMMParams, log_b: torch.Tensor):
    """Drop-in for :func:`hmm.forward_log` (same (log_alpha, loglik)),
    from the chunked passes plus their offsets; batched too. CPU tensors
    only."""
    _cpu_only(log_b, "forward_log")
    params, lb, sq = _as_batch(params, log_b)
    B, T, K = lb.shape
    L = chunk_len(K)
    ch = _Chunks(T, L, lb.device)
    lbc = ch.split(lb)
    F = _transfers(params, lbc, ch, logsum=True)
    ain, aoff, v, off = _scan_forward(F, logsum=True)
    bout, _ = _scan_backward(F)
    al, _ = _chunk_passes(params, lbc, ch, ain, bout)
    alpha = (al + aoff[:, :, None, None]).reshape(B, -1, K)[:, :T]
    return _unbatch(sq, alpha, off + _lse_b(v))


def backward_log(params: HMMParams, log_b: torch.Tensor) -> torch.Tensor:
    """Drop-in for :func:`hmm.backward_log` (same log_beta); batched too.
    CPU tensors only."""
    _cpu_only(log_b, "backward_log")
    params, lb, sq = _as_batch(params, log_b)
    B, T, K = lb.shape
    L = chunk_len(K)
    ch = _Chunks(T, L, lb.device)
    lbc = ch.split(lb)
    F = _transfers(params, lbc, ch, logsum=True)
    ain, _, _, _ = _scan_forward(F, logsum=True)
    bout, boff = _scan_backward(F)
    _, be = _chunk_passes(params, lbc, ch, ain, bout)
    beta = (be + boff[:, :, None, None]).reshape(B, -1, K)[:, :T]
    return _unbatch(sq, beta)[0]


def e_step(params: HMMParams, X: torch.Tensor):
    """Offset-free E-step: (gamma (T, K), xi_sum (K, K), loglik), matching
    :func:`hmm._e_step` up to rounding; batched too. CPU tensors only
    (gamma is a lattice; on the card e_step_stats runs the H3 kernel)."""
    _cpu_only(X, "e_step")
    params, X, sq = _as_batch(params, X)
    B, T, D = X.shape
    K = params.startprob.shape[-1]
    gamma, xi, ll, ch, _ = _e_step_parts(params, X.to(torch.float64),
                                         chunk_len(K))
    xmask = (ch.valid & ~ch.first)[None, :, :, None, None]
    xi_sum = torch.where(xmask, xi, torch.zeros_like(xi)).sum(dim=(1, 2))
    return _unbatch(sq, gamma.reshape(B, -1, K)[:, :T], xi_sum, ll)


def e_step_stats(params: HMMParams, X: torch.Tensor):
    """One E-step's statistics (gamma0, sum gamma, gamma^T X, gamma^T X^2,
    sum xi) and log-likelihood, batched: one launch of the H3 kernel for a
    CUDA tensor, the plain form for a CPU tensor."""
    params, X, sq = _as_batch(params, X)
    st, ll = _e_step_stats_b(params, X.to(torch.float64))
    if sq:
        return tuple(s[0] for s in st), ll[0]
    return st, ll


def score(params: HMMParams, X: torch.Tensor) -> torch.Tensor:
    """Sequence log-likelihood (hmm.score contract), from the chunked
    E-step (H3 on the card)."""
    return e_step_stats(params, X)[1]


def viterbi(params: HMMParams, X: torch.Tensor) -> torch.Tensor:
    """Drop-in for :func:`hmm.viterbi`: the same backpointers (first index
    on ties), composed chunk by chunk. One launch of H2's chunked form for
    a CUDA tensor, the plain form for a CPU tensor."""
    params, X, sq = _as_batch(params, X)
    L = chunk_len(params.startprob.shape[-1])
    if X.device.type == "cpu":
        states = _viterbi_plain(params, X, L)
    else:
        states = hmm_cuda.viterbi_chunked(*_kernel_operands(params, X), L)
    return _unbatch(sq, states)[0]


def fit(params0: HMMParams, X: torch.Tensor, n_iter: int = 100,
        tol: float = DEFAULT_TOL):
    """Baum-Welch EM with the chunked E-step (hmm.fit contract: (params,
    final loglik, n_iterations_run)). The loop runs on the host: an E-step
    (H3 on the card), the M-step in float64 torch, and one device-to-host
    read of the convergence test an iteration."""
    params0, X, sq = _as_batch(params0, X)
    params, ll, it = hmm._em_loop(_e_step_stats_b, params0,
                                  X.to(torch.float64), n_iter, tol)
    if sq:
        return HMMParams(*(p[0] for p in params)), ll[0], it[0]
    return params, ll, it


def unsupervised_fit_decode(params0: HMMParams, X: torch.Tensor,
                            n_iter: int = 100, tol: float = DEFAULT_TOL):
    """hmm.unsupervised_fit_decode (PlotEngine.py:411-445) on the chunked
    engine: EM fit, baseline = argmin mean log-power, escape-route patch,
    Viterbi; batched too."""
    return hmm._decode_patched(fit, viterbi, params0, X, n_iter, tol)
