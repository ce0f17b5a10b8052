"""The Gaussian HMM's kernels: wrappers, launch counts and plain versions.

The JAX package has no Pallas kernel here: its HMM runs as jitted
``lax.scan`` / ``lax.while_loop`` programs vmapped over sweeps
(``spectral_tpu/models/hmm.py:75-208``, ``hmm_pscan.py:289-377``,
``models/batch.py:42-45``). The port runs each recursion as a CUDA C++
kernel of its own (``csrc/hmm.cu``, float64), one launch serving a whole
batch of sequences:

- H1 :func:`fit_seq` (``hmm_fit_launch``): the whole Baum-Welch loop, a
  block a sequence (``models/hmm.py::fit`` on the card, T < 2048 on the
  detection path);
- H2 :func:`viterbi_seq` (``hmm_viterbi_launch``, a block a sequence) and
  :func:`viterbi_chunked` (``hmm_viterbi_chunked_launch``, chunks of L
  frames: five kernels, one call); ``models/hmm.py::viterbi`` and
  ``models/hmm_pscan.py::viterbi`` on the card;
- H3 :func:`estep_chunked` (``hmm_estep_chunked_launch``, four kernels,
  one call): one E-step's statistics and log-likelihood for T >= 2048
  (``models/hmm_pscan.py::e_step_stats`` on the card).

Every array is float64, contiguous, on one CUDA device, batched: X (B, T,
D), startprob (B, K), transmat (B, K, K), means and covars (B, K, D). Each
wrapper checks that, launches, and raises on a launch error; it never
falls back. ``launches`` counts the calls that launched, one a call.

The plain versions, :func:`fit_seq_reference`, :func:`viterbi_seq_reference`,
:func:`viterbi_chunked_reference` and :func:`estep_chunked_reference`, are
the model modules' torch forms of the same arithmetic
(``models/hmm.py::_fit_plain``, ``_viterbi_plain``,
``models/hmm_pscan.py::_viterbi_plain``, ``_e_step_stats_plain``); the
model modules take them for a CPU tensor, and only because it lies on the
CPU.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from spectral_tpu_torch.ops import build

KERNEL = "hmm"
MAX_STATES = 8
MAX_FEATURES = 4
CHUNK_CAP = 1024          # frames x states a chunk stages (csrc CHUNK_CAP)
CHUNK_MAX = 256           # frames a chunk at most (csrc CHUNK_MAX)

# kernel launches, for run-time proof of the path
launches = {"fit": 0, "viterbi": 0, "viterbi_chunked": 0,
            "estep_chunked": 0}

_LIB: list = []


def chunk_len(K: int) -> int:
    """Frames a chunk for K states: 256, fewer past 4 states so a chunk's
    staged emissions stay within CHUNK_CAP."""
    return min(CHUNK_MAX, CHUNK_CAP // K)


def n_stats(K: int, D: int) -> int:
    """Length of a statistics row: gamma0 (K), sum gamma (K), gamma^T X
    (K D), gamma^T X^2 (K D), sum xi (K K)."""
    return 2 * K + 2 * K * D + K * K


def split_stats(st: torch.Tensor, K: int, D: int):
    """(B, S) statistics -> (gamma0 (B, K), sum gamma (B, K), gamma^T X (B,
    K, D), gamma^T X^2 (B, K, D), sum xi (B, K, K))."""
    B = st.shape[0]
    o = [0, K, 2 * K, 2 * K + K * D, 2 * K + 2 * K * D,
         2 * K + 2 * K * D + K * K]
    return (st[:, o[0]:o[1]], st[:, o[1]:o[2]],
            st[:, o[2]:o[3]].reshape(B, K, D),
            st[:, o[3]:o[4]].reshape(B, K, D),
            st[:, o[4]:o[5]].reshape(B, K, K))


def _library() -> ctypes.CDLL:
    """The HMM kernels' library, built and loaded at first use, then kept
    for the process."""
    if _LIB:
        return _LIB[0]
    lib = build.load_library(KERNEL)
    ptr, i32, i64, f64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_double)
    lib.hmm_fit_scratch.argtypes = [i32, i32]
    lib.hmm_fit_scratch.restype = i64
    lib.hmm_viterbi_scratch.argtypes = [i32, i32]
    lib.hmm_viterbi_scratch.restype = i64
    lib.hmm_n_stats.argtypes = [i32, i32]
    lib.hmm_n_stats.restype = i32
    lib.hmm_chunk_cap.restype = i32
    lib.hmm_chunk_max.restype = i32
    lib.hmm_fit_launch.argtypes = ([ptr, i64, i32, i32, i32] + [ptr] * 4
                                   + [i32, f64] + [ptr] * 8)
    lib.hmm_fit_launch.restype = i32
    lib.hmm_viterbi_launch.argtypes = ([ptr, i64, i32, i32, i32]
                                       + [ptr] * 7)
    lib.hmm_viterbi_launch.restype = i32
    lib.hmm_viterbi_chunked_launch.argtypes = (
        [ptr, i64, i32, i32, i32, i32] + [ptr] * 12)
    lib.hmm_viterbi_chunked_launch.restype = i32
    lib.hmm_estep_chunked_launch.argtypes = (
        [ptr, i64, i32, i32, i32, i32] + [ptr] * 11)
    lib.hmm_estep_chunked_launch.restype = i32
    lib.hmm_error_string.argtypes = [i32]
    lib.hmm_error_string.restype = ctypes.c_char_p
    if (lib.hmm_chunk_cap() != CHUNK_CAP or lib.hmm_chunk_max() != CHUNK_MAX
            or lib.hmm_n_stats(4, 2) != n_stats(4, 2)):
        raise RuntimeError("csrc/hmm.cu and ops/hmm_cuda.py disagree on "
                           "the chunk sizes or the statistics layout")
    _LIB.append(lib)
    return lib


def _check(X: torch.Tensor, params, L: int = 0) -> Tuple[int, int, int, int]:
    """(B, T, D, K) of a batch the kernels take (chunks of L frames for
    the chunked forms); raises on anything else."""
    if X.dim() != 3:
        raise ValueError(f"X must be (B, T, D), got {tuple(X.shape)}")
    B, T, D = X.shape
    start, trans, means, covars = params
    K = start.shape[-1]
    want = {"X": (X, (B, T, D)), "startprob": (start, (B, K)),
            "transmat": (trans, (B, K, K)), "means": (means, (B, K, D)),
            "covars": (covars, (B, K, D))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} of shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.dtype != torch.float64 or not t.is_contiguous():
            raise TypeError(f"the HMM kernels take contiguous float64 "
                            f"tensors; {name} is {t.dtype}"
                            f"{'' if t.is_contiguous() else ', strided'}")
        if t.device != X.device:
            raise ValueError(f"{name} on {t.device}, X on {X.device}")
    if not (1 <= K <= MAX_STATES and 1 <= D <= MAX_FEATURES and T >= 1
            and 1 <= B <= 65535):
        raise ValueError(f"the HMM kernels take 1-{MAX_STATES} states, "
                         f"1-{MAX_FEATURES} features, T >= 1 and 1-65535 "
                         f"sequences; got K={K}, D={D}, T={T}, B={B}")
    if L and not (1 <= L <= CHUNK_MAX and L * K <= CHUNK_CAP):
        raise ValueError(f"chunk length {L} for {K} states")
    if X.device.type != "cuda":
        raise ValueError(f"the HMM kernels take CUDA tensors, got {X.device}")
    return B, T, D, K


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.hmm_error_string(err).decode())


def _stream(X):
    return torch.cuda.current_stream(X.device).cuda_stream


def fit_seq(X: torch.Tensor, params, n_iter: int, tol: float):
    """H1: Baum-Welch on every sequence of the batch in one launch.
    params is (startprob, transmat, means, covars); returns the fitted
    (startprob, transmat, means, covars), the last E-step's
    log-likelihood (B,) float64 and the iterations run (B,) int32."""
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")
    lib = _library()
    B, T, D, K = _check(X, params)
    out = [torch.empty_like(p) for p in params]
    ll = torch.empty(B, dtype=torch.float64, device=X.device)
    it = torch.empty(B, dtype=torch.int32, device=X.device)
    per_seq = lib.hmm_fit_scratch(T, K)
    scratch = (torch.empty(B * per_seq, dtype=torch.float64,
                           device=X.device) if per_seq else None)
    with torch.cuda.device(X.device):
        err = lib.hmm_fit_launch(
            X.data_ptr(), B, T, D, K, *[p.data_ptr() for p in params],
            int(n_iter), float(tol), *[o.data_ptr() for o in out],
            ll.data_ptr(), it.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, _stream(X))
    _raise_on(err, lib, "HMM fit")
    launches["fit"] += 1
    return tuple(out), ll, it


def viterbi_seq(X: torch.Tensor, params) -> torch.Tensor:
    """H2, a block a sequence: the most likely state paths (B, T) int32."""
    lib = _library()
    B, T, D, K = _check(X, params)
    states = torch.empty((B, T), dtype=torch.int32, device=X.device)
    per_seq = lib.hmm_viterbi_scratch(T, K)
    scratch = (torch.empty(B * per_seq, dtype=torch.uint8, device=X.device)
               if per_seq else None)
    with torch.cuda.device(X.device):
        err = lib.hmm_viterbi_launch(
            X.data_ptr(), B, T, D, K, *[p.data_ptr() for p in params],
            states.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, _stream(X))
    _raise_on(err, lib, "HMM Viterbi")
    launches["viterbi"] += 1
    return states


def viterbi_chunked(X: torch.Tensor, params, L: int) -> torch.Tensor:
    """H2, chunks of L frames: the most likely state paths (B, T) int32."""
    lib = _library()
    B, T, D, K = _check(X, params, L)
    n = math.ceil(T / L)
    dev = X.device
    states = torch.empty((B, T), dtype=torch.int32, device=dev)
    F = torch.empty((B, n, K, K), dtype=torch.float64, device=dev)
    din = torch.empty((B, n, K), dtype=torch.float64, device=dev)
    psi = torch.empty((B, T, K), dtype=torch.uint8, device=dev)
    maps = torch.empty((B, n, K), dtype=torch.int32, device=dev)
    send = torch.empty(B, dtype=torch.int32, device=dev)
    ends = torch.empty((B, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.hmm_viterbi_chunked_launch(
            X.data_ptr(), B, T, D, K, int(L),
            *[p.data_ptr() for p in params], states.data_ptr(),
            F.data_ptr(), din.data_ptr(), psi.data_ptr(), maps.data_ptr(),
            send.data_ptr(), ends.data_ptr(), _stream(X))
    _raise_on(err, lib, "HMM chunked Viterbi")
    launches["viterbi_chunked"] += 1
    return states


def estep_chunked(X: torch.Tensor, params, L: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """H3, chunks of L frames: one E-step's statistics (B, S) (the layout
    of :func:`split_stats`) and log-likelihood (B,), float64."""
    lib = _library()
    B, T, D, K = _check(X, params, L)
    n = math.ceil(T / L)
    S = n_stats(K, D)
    dev = X.device
    stats = torch.empty((B, S), dtype=torch.float64, device=dev)
    ll = torch.empty(B, dtype=torch.float64, device=dev)
    F = torch.empty((B, n, K, K), dtype=torch.float64, device=dev)
    ain = torch.empty((B, n, K), dtype=torch.float64, device=dev)
    bout = torch.empty((B, n, K), dtype=torch.float64, device=dev)
    part = torch.empty((B, n, S), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        err = lib.hmm_estep_chunked_launch(
            X.data_ptr(), B, T, D, K, int(L),
            *[p.data_ptr() for p in params], stats.data_ptr(),
            ll.data_ptr(), F.data_ptr(), ain.data_ptr(), bout.data_ptr(),
            part.data_ptr(), _stream(X))
    _raise_on(err, lib, "HMM chunked E-step")
    launches["estep_chunked"] += 1
    return stats, ll


# ---------------------------------------------------------------------------
# The plain versions (the model modules' torch forms; device-agnostic)
# ---------------------------------------------------------------------------

def fit_seq_reference(X, params, n_iter: int, tol: float):
    """The plain version of :func:`fit_seq`: ``models/hmm.py::_fit_plain``."""
    from spectral_tpu_torch.models import hmm
    p, ll, it = hmm._fit_plain(hmm.HMMParams(*params), X, n_iter, tol)
    return tuple(p), ll, it


def viterbi_seq_reference(X, params) -> torch.Tensor:
    """The plain version of :func:`viterbi_seq`."""
    from spectral_tpu_torch.models import hmm
    return hmm._viterbi_plain(hmm.HMMParams(*params), X)


def viterbi_chunked_reference(X, params, L: int) -> torch.Tensor:
    """The plain version of :func:`viterbi_chunked`."""
    from spectral_tpu_torch.models import hmm, hmm_pscan
    return hmm_pscan._viterbi_plain(hmm.HMMParams(*params), X, L)


def estep_chunked_reference(X, params, L: int):
    """The plain version of :func:`estep_chunked`."""
    from spectral_tpu_torch.models import hmm, hmm_pscan
    return hmm_pscan._e_step_stats_plain(hmm.HMMParams(*params), X, L)
