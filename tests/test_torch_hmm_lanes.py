"""The HMM kernels' redesign for the H100 (csrc/hmm.cu), held on the CPU:

- the K^2-lane step (a lane a term, one exp a lane, gathered sums;
  ``tools/torch_precision.py::hmm_step_lanes``) against the
  one-state-a-lane step it replaced (``hmm_step_state_lanes``), bitwise,
  for the forward, the backward and the scan's normalized steps, over
  random steps with -1e10 structural zeros, -inf one-hot starts, ties,
  signed zeros and emission scales 1e5 apart (supervised_fit's 1e-6
  variances), at K 1-4 on KM 2 and 4;
- the kernels' M-step (``hmm_m_step_kernel``, m_step<KM>'s operation
  order) against ``models/hmm.py::_m_step_stats``, bitwise, with zero
  denominators and zero rows;
- the device loop's schedule (``models/hmm_pscan.py::_fit_gated_plain``:
  groups of G iterations, each sequence stepped only while its flag is
  set, the flags read once a group) against ``models/hmm.py::_em_loop``,
  bitwise, for G 1, 3 and 8;
- the ctypes prototypes of ``ops/hmm_cuda.py`` against hmm.cu's extern "C"
  launchers.

No card is needed: the kernels themselves are held to these models and to
the parent's digests on the card (``chip_smoke.py``'s ``hmm`` phase,
``tools/torch_route_times.py --pipelines 14 15``).
"""

import ctypes
import math
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import torch_precision as tp  # noqa: E402
from spectral_tpu_torch.models import hmm, hmm_pscan  # noqa: E402
from spectral_tpu_torch.ops import build, hmm_cuda  # noqa: E402

CSRC = Path(hmm_cuda.__file__).resolve().parent / "csrc"


def _bits(vals):
    return [np.float64(v).tobytes() for v in vals]


def _random_step(rng, K, kind):
    """x (K,), the K x K coefficients (LA, or a transfer F for the scan's
    steps) and lb (K,), with the special values the kernels meet."""
    LA = np.log(rng.dirichlet(np.ones(K), size=K))
    zeros = rng.rand(K, K) < 0.25
    LA[zeros] = -1e10                          # structural zeros
    scale = rng.choice([1.0, 1e5])             # 1e-6 variances
    lb = -scale * rng.rand(K)
    x = rng.randn(K) * rng.choice([1.0, 30.0])
    case = rng.randint(6)
    if case == 0 and kind in ("fwd", "scan_fwd"):
        x = np.full(K, -np.inf)                # a one-hot start
        x[rng.randint(K)] = 0.0
    elif case == 1:
        x[:] = x[0]                            # ties
        LA[:] = LA[0, 0]
    elif case == 2:
        x = np.where(rng.rand(K) < 0.5, 0.0, -0.0)   # signed zeros
        lb = np.where(rng.rand(K) < 0.5, 0.0, -0.0)
    elif case == 3:
        x[rng.rand(K) < 0.5] = -1e10
    if kind.startswith("scan"):
        F = LA + rng.randn(K, K) * 50.0         # a chunk's transfer
        F[zeros] = -1e10 + rng.randn(int(zeros.sum()))
        if case == 1:
            F[:] = F[0, 0]
        return x, F, lb
    return x, LA, lb


@pytest.mark.parametrize("kind", tp.HMM_STEPS)
@pytest.mark.parametrize("KM,K", [(2, 1), (2, 2), (4, 3), (4, 4)])
def test_k2_lane_step_is_the_state_lane_step_bitwise(kind, KM, K):
    rng = np.random.RandomState(1000 * KM + 10 * K + tp.HMM_STEPS.index(kind))
    for _ in range(60):
        x, coef, lb = _random_step(rng, K, kind)
        want, want_extra = tp.hmm_step_state_lanes(kind, x, coef, lb, K, KM)
        got, got_extra = tp.hmm_step_lanes(kind, x, coef, lb, K, KM)
        assert _bits(got) == _bits(want), (kind, x, coef, lb)
        if kind == "scan_fwd":
            assert _bits([got_extra[0]]) == _bits([want_extra[0]])
            assert _bits(got_extra[1]) == _bits(want_extra[1])
        elif kind == "scan_bwd":
            assert _bits([got_extra]) == _bits([want_extra])


def test_k2_lane_step_chains_stay_bitwise():
    """Forty steps of a forward and a backward chain at K = 4 from a one-hot
    start, the emissions 1e5 apart: each step's output is the next step's
    input, in both forms."""
    rng = np.random.RandomState(7)
    K = 4
    LA = np.log(rng.dirichlet(np.ones(K), size=K))
    LA[0, 3] = LA[3, 1] = -1e10
    a = np.array([-np.inf, 0.0, -np.inf, -np.inf])
    b = np.zeros(K)
    a2, b2 = a.copy(), b.copy()
    for _ in range(40):
        lb = -1e5 * rng.rand(K)
        a = np.array(tp.hmm_step_state_lanes("fwd", a, LA, lb, K, 4)[0])
        a2 = np.array(tp.hmm_step_lanes("fwd", a2, LA, lb, K, 4)[0])
        b = np.array(tp.hmm_step_state_lanes("bwd", b, LA, lb, K, 4)[0])
        b2 = np.array(tp.hmm_step_lanes("bwd", b2, LA, lb, K, 4)[0])
        assert _bits(a2) == _bits(a) and _bits(b2) == _bits(b)
    assert np.isfinite(a).all() and np.isfinite(b).all()


def _random_stats(rng, K, D):
    g0 = rng.dirichlet(np.ones(K))
    gs = rng.rand(K) * 100.0
    gs[rng.rand(K) < 0.3] = 0.0                 # denom == 0: means kept
    gx = rng.randn(K, D) * gs[:, None]
    gx2 = rng.rand(K, D) * gs[:, None] * 4.0
    xi = rng.rand(K, K) * 50.0
    xi[rng.randint(K)] = 0.0                    # a zero row
    return g0, gs, gx, gx2, xi


@pytest.mark.parametrize("K,D", [(4, 2), (2, 1), (4, 1), (6, 2)])
def test_m_step_transcription_is_the_torch_m_step_bitwise(K, D):
    rng = np.random.RandomState(K * 10 + D)
    for trial in range(20):
        start = rng.dirichlet(np.ones(K))
        trans = rng.dirichlet(np.ones(K), size=K)
        if trial % 2:
            start[-1] = 0.0                     # structural zeros
            trans[0, -1] = trans[-1, 0] = 0.0
        if trial % 5 == 0:
            start[:] = 0.0                      # a zero start row
        params = (start, trans, rng.randn(K, D), rng.rand(K, D) + 0.1)
        stats = _random_stats(rng, K, D)
        want = hmm._m_step_stats(
            hmm.HMMParams(*(torch.from_numpy(p)[None] for p in params)),
            tuple(torch.from_numpy(np.asarray(s))[None] for s in stats))
        got = tp.hmm_m_step_kernel(params, stats)
        for g, w in zip(got, want):
            assert g.tobytes() == w[0].numpy().tobytes()


def _batch(T=2100):
    """Three sequences that converge at different iterations: the
    parity features at three seeds, each with its own k-means start."""
    feats = [hmm_feats(T, s) for s in (1, 2, 3)]
    X = torch.from_numpy(np.stack(feats))
    ps = [hmm.init_params(f, 4, device="cpu") for f in feats]
    return X, hmm.HMMParams(*(torch.stack(a) for a in zip(*ps)))


def hmm_feats(T, seed):
    rng = np.random.RandomState(seed)
    logp = -6.0 + 0.15 * rng.randn(T)
    for _ in range(T // 300):
        a = int(rng.randint(0, T - 3))
        n = len(logp[a:a + int(rng.randint(3, 60))])
        logp[a:a + n] = -3.0 + 0.2 * rng.randn(n)
    return np.stack([logp, np.diff(logp, prepend=logp[0])], axis=1)


def _seq_e_step(p, X):
    return hmm._e_step_stats_plain(p, X)


def _zeros(p):
    start = p.startprob.clone()
    start[:, 2:] = 0.0
    start = start / start.sum(dim=1, keepdim=True)
    trans = p.transmat.clone()
    trans[:, 0, 3] = 0.0
    trans[:, 3, 1] = 0.0
    trans = trans / trans.sum(dim=2, keepdim=True)
    return hmm.HMMParams(start, trans, p.means, p.covars)


@pytest.mark.parametrize("group", [1, 3, 8])
@pytest.mark.parametrize("n_iter,tol,zeros", [
    (0, hmm.DEFAULT_TOL, False), (1, hmm.DEFAULT_TOL, False),
    (2, hmm.DEFAULT_TOL, True), (100, hmm.DEFAULT_TOL, False),
    (100, 1e30, True), (100, 1.0, True)])
def test_gated_loop_is_the_host_loop_bitwise(group, n_iter, tol, zeros):
    """The device loop's schedule over the sequential E-step (the loop is
    the same whichever E-step feeds it): the parameters, ll and it
    bitwise, the sequences converging at different iterations, and at
    most ceil(it / G) + 1 reads of the flags."""
    X, p0 = _batch(400)
    if zeros:
        p0 = _zeros(p0)
    want = hmm._em_loop(_seq_e_step, p0, X, n_iter, tol)
    got_p, got_ll, got_it, reads = hmm_pscan._fit_gated_plain(
        _seq_e_step, p0, X, n_iter, tol, group)
    for g, w in zip(got_p, want[0]):
        assert g.numpy().tobytes() == w.numpy().tobytes()
    assert got_ll.numpy().tobytes() == want[1].numpy().tobytes()
    assert torch.equal(got_it, want[2]) and got_it.dtype == torch.int32
    it_max = int(got_it.max())
    assert reads <= math.ceil(it_max / group) + 1
    if n_iter == 100 and tol == hmm.DEFAULT_TOL:
        assert len(set(got_it.tolist())) > 1     # converged apart
    if tol == 1e30:
        assert got_it.tolist() == [2, 2, 2]
    if zeros and n_iter > 0:
        assert bool((got_p.transmat[:, 0, 3] == 0).all())
        assert bool((got_p.startprob[:, 2:] == 0).all())


def test_gated_loop_over_the_chunked_e_step():
    """The same schedule over the plain chunked E-step (the one the card
    runs), G 8, at a length of two chunks and a ragged third."""
    X, p0 = _batch(600)
    L = 256

    def e_step(p, X):
        st, ll = hmm_pscan._e_step_stats_plain(p, X, L)
        return hmm_cuda.split_stats(st, 4, 2), ll
    want = hmm._em_loop(e_step, p0, X, 6, hmm.DEFAULT_TOL)
    got = hmm_pscan._fit_gated_plain(e_step, p0, X, 6, hmm.DEFAULT_TOL, 8)
    for g, w in zip(got[0], want[0]):
        assert g.numpy().tobytes() == w.numpy().tobytes()
    assert got[1].numpy().tobytes() == want[1].numpy().tobytes()
    assert torch.equal(got[2], want[2])
    p, ll, it = hmm_cuda.fit_chunked_reference(X, tuple(p0), L, 6,
                                               hmm.DEFAULT_TOL)
    for g, w in zip(p, want[0]):
        assert g.numpy().tobytes() == w.numpy().tobytes()
    assert torch.equal(it, want[2])


def _c_params(src, entry):
    found = re.search(rf"^(?:int|long long) {entry}\((.*?)\) {{", src,
                      re.M | re.S)
    assert found, entry
    text = found.group(1).strip()
    return [p.strip() for p in text.split(",")] if text else []


def test_ctypes_prototypes_match_the_launchers(monkeypatch):
    """The wrapper's argtypes for each extern "C" entry of hmm.cu, one for
    each C parameter: pointers, 32-bit ints, the 64-bit B and the
    double tolerance."""
    class Entry:
        def __init__(self, name):
            self.name = name
            self.argtypes = None
            self.restype = None

        def __call__(self, *args):
            return {"hmm_chunk_cap": hmm_cuda.CHUNK_CAP,
                    "hmm_chunk_max": hmm_cuda.CHUNK_MAX,
                    "hmm_n_stats": hmm_cuda.n_stats(*args)
                    if args else 0}[self.name]

    class Lib:
        def __getattr__(self, name):
            entry = Entry(name)
            setattr(self, name, entry)
            return entry

    monkeypatch.setattr(hmm_cuda, "_LIB", [])
    monkeypatch.setattr(build, "load_library", lambda name: Lib())
    lib = hmm_cuda._library()
    src = (CSRC / "hmm.cu").read_text()
    body = src[src.index('extern "C" {'):]
    entries = re.findall(r"^(?:int|long long|const char\*) (hmm_\w+)\(",
                         body, re.M)
    assert "hmm_fit_chunked_launch" in entries
    for entry in entries:
        types = getattr(lib, entry).argtypes
        if entry in ("hmm_chunk_max", "hmm_chunk_cap"):
            assert not types
            continue
        if entry == "hmm_error_string":
            assert types == [ctypes.c_int]
            continue
        params = _c_params(body, entry)
        assert len(types) == len(params), entry
        for p, t in zip(params, types):
            if "*" in p:
                assert t is ctypes.c_void_p, (entry, p)
            elif p.startswith("long long"):
                assert t is ctypes.c_longlong, (entry, p)
            elif p.startswith("double"):
                assert t is ctypes.c_double, (entry, p)
            else:
                assert p.startswith("int ") and t is ctypes.c_int, (entry, p)


def test_fit_chunked_takes_cuda_tensors_only(monkeypatch):
    monkeypatch.setattr(hmm_cuda, "_library", lambda: None)
    X = torch.zeros((1, 3000, 2), dtype=torch.float64)
    p = hmm.init_params(np.random.RandomState(0).randn(3000, 2), 4,
                        device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        hmm_cuda.fit_chunked(X, tuple(a[None].contiguous() for a in p), 256,
                             10, 1e-2)
    with pytest.raises(ValueError, match="n_iter"):
        hmm_cuda.fit_chunked(X, tuple(a[None].contiguous() for a in p), 256,
                             -1, 1e-2)
    assert hmm_cuda.EM_GROUP == 8 and "fit_chunked" in hmm_cuda.launches
