"""H2's chunked form (``csrc/hmm.cu::hmm_viterbi_chunked_launch``): its
scan and its compose, held on the CPU through numpy transcriptions of the
two kernels to the plain version (``models/hmm_pscan.py::_viterbi_plain``,
``ops/hmm_cuda.py::viterbi_chunked_reference``), bitwise.

The two kernels walk all of a sequence's chunks in one dependent chain:

- ``vit_scan_kernel``: every lane holds the step's K values and computes
  them all, the chunk's incoming delta normalized to max 0 (the first
  strict max in index order) then each state's strict max in index order
  of vin_i + F[c, i, j]; the transfers reach it from shared memory,
  SCAN_TILE chunks a tile in two buffers, tile t + 1 fetched while the
  chain walks tile t;
- ``vit_compose_kernel``: a block a sequence stages its (n, K) maps in
  shared memory COMPOSE_TILE chunks a tile, the tile before fetched while
  thread 0 walks this one backwards from the end state.

``scan_model`` and ``compose_model`` transcribe them, buffers and tile
edges included, and are held to the plain version's incoming deltas, end
state, chunk ends and states at K 1-4, with ties between states (two
states alike in every parameter), structural zeros (-1e10 for log 0 in
the start and transition probabilities) and sequences of several scan
and compose tiles. A tile size read from the source moves the
transcription with it.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spectral_tpu_torch.models import hmm, hmm_pscan  # noqa: E402
from spectral_tpu_torch.ops import hmm_cuda  # noqa: E402

SRC = (Path(hmm_cuda.__file__).resolve().parent / "csrc" / "hmm.cu"
       ).read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


SCAN_TILE = _constant("SCAN_TILE")
COMPOSE_TILE = _constant("COMPOSE_TILE")


def scan_model(F, K, tile=SCAN_TILE):
    """vit_scan_kernel on one sequence's transfers F (n, K, K) float64:
    (din (n, K), the end state). Chunk c is read from buffer (c div tile)
    & 1 at (c mod tile) K^2, each buffer refilled a tile ahead."""
    n = F.shape[0]
    flat = F.reshape(n, K * K)
    ntiles = -(-n // tile)
    buffers = [None, None]

    def fetch(t):
        if t < ntiles:
            buffers[t & 1] = flat[t * tile:(t + 1) * tile].copy()

    v = [flat[0, j] for j in range(K)]          # chunk 0's end vector
    din = np.zeros((n, K))
    fetch(0)
    for t in range(ntiles):
        fetch(t + 1)
        for c in range(1 if t == 0 else t * tile, min(n, (t + 1) * tile)):
            Fc = buffers[(c // tile) & 1][c % tile]
            M = v[0]
            for i in range(1, K):
                if v[i] > M:
                    M = v[i]
            vin = [v[i] - M for i in range(K)]
            din[c] = vin
            new = []
            for j in range(K):
                best = vin[0] + Fc[j]
                for i in range(1, K):
                    sc = vin[i] + Fc[i * K + j]
                    if sc > best:
                        best = sc
                new.append(best)
            v = new
    end, best = 0, v[0]
    for j in range(1, K):
        if v[j] > best:
            best, end = v[j], j
    return din, end


def compose_model(send, maps, tile=COMPOSE_TILE):
    """vit_compose_kernel on one sequence's maps (n, K) int: ends (n,),
    the state at each chunk's last frame. The walk reads tile t's buffer
    (t & 1) at (c - t tile) K + s, the buffer of tile t - 1 refilled
    while it walks."""
    n, K = maps.shape
    flat = maps.reshape(-1)
    ntiles = -(-n // tile)
    buffers = [None, None]

    def fetch(t):
        if t >= 0:
            buffers[t & 1] = flat[t * tile * K:(t + 1) * tile * K].copy()

    ends = np.full(n, -1)
    s = send
    fetch(ntiles - 1)
    for t in range(ntiles - 1, -1, -1):
        fetch(t - 1)
        c0 = t * tile
        m = buffers[t & 1]
        for c in range(min(n, c0 + tile) - 1, max(c0, 1) - 1, -1):
            ends[c] = s
            s = m[(c - c0) * K + s]
    ends[0] = s
    return ends


def plain_parts(params, X, L):
    """The plain version's parts for sequence 0: the transfers (n, K, K),
    the incoming deltas, the end state, the backpointers (n, L, K), each
    chunk's map (n, K) and the chunks' ends (n,), as _viterbi_plain
    forms them."""
    B, T, D = X.shape
    ch = hmm_pscan._Chunks(T, L, X.device)
    lbc = ch.split(hmm._log_emission_b(params, X))
    F = hmm_pscan._transfers(params, lbc, ch, logsum=False)
    din, _, v, _ = hmm_pscan._scan_forward(F, logsum=False)
    end = hmm._first_argmax(v)
    LA = hmm._safe_log(params.transmat)[:, None]
    d = din.clone()
    d[:, 0] = hmm._safe_log(params.startprob) + lbc[:, 0, 0]
    psi = []
    for s in range(L):
        new, arg = hmm._vit_step(d, LA, lbc[:, :, s])
        d = hmm_pscan._where(ch.valid[:, s] & ~ch.first[:, s], new, d)
        psi.append(arg)
    psi = torch.stack(psi, dim=2)
    K = psi.shape[-1]
    m = torch.arange(K).expand(B, ch.n, K).clone()
    for s in range(L - 1, -1, -1):
        stepped = psi[:, :, s].gather(-1, m)
        m = hmm_pscan._where(s <= ch.last, stepped, m)
    ends = torch.empty((B, ch.n), dtype=torch.int64)
    s_end = end
    for c in range(ch.n - 1, 0, -1):
        ends[:, c] = s_end
        s_end = m[:, c].gather(-1, s_end[:, None])[:, 0]
    ends[:, 0] = s_end
    return (F[0].numpy(), din[0].numpy(), int(end[0]), psi[0].numpy(),
            m[0].numpy(), ends[0].numpy(), ch)


def backtrace_model(psi, ends, T, L):
    """vit_backtrace_kernel: each chunk from its end state over its own
    backpointers."""
    states = np.zeros(T, np.int64)
    for c in range(len(ends)):
        t0 = c * L
        ln = min(L, T - t0)
        s = ends[c]
        states[t0 + ln - 1] = s
        for r in range(ln - 1, 0, -1):
            s = psi[c, r, s]
            states[t0 + r - 1] = s
    return states


def model_params(K, D, variant, seed):
    """A K-state model on D features: random, with ties (states 0 and 1
    alike in start, transitions in and out, means and covariances), or
    with structural zeros (the last state neither a start nor entered from
    another, and one transition out of it)."""
    rs = np.random.RandomState(seed)
    start = rs.rand(K) + 0.1
    trans = rs.rand(K, K) + 0.05
    means = rs.randn(K, D)
    covars = rs.rand(K, D) + 0.5
    if variant == "ties" and K >= 2:
        start[1] = start[0]
        trans[1] = trans[0]
        trans[:, 1] = trans[:, 0]
        means[1], covars[1] = means[0], covars[0]
    if variant == "zeros" and K >= 2:
        start[K - 1] = 0.0
        trans[:K - 1, K - 1] = 0.0             # the last state entered
        trans[K - 1, 0] = 0.0                  # from itself alone
    start = start / start.sum()
    trans = trans / trans.sum(axis=1, keepdims=True)
    return hmm.HMMParams(*(torch.tensor(a[None]) for a in
                           (start, trans, means, covars)))


CASES = [(K, variant, T, L)
         for K, variant, T, L in (
             (1, "random", 700, 8),
             (2, "random", 1500, 4),
             (2, "ties", 2 * COMPOSE_TILE + 77, 1),
             (3, "zeros", 900, 5),
             (3, "ties", 1300, 3),
             (4, "random", 2 * COMPOSE_TILE * 2 + 5, 2),
             (4, "ties", 3000, 7),
             (4, "zeros", 2500, 4),
             (4, "random", 2048, 256),
             (2, "zeros", 31, 32))]


@pytest.mark.parametrize("K,variant,T,L", CASES,
                         ids=[f"K{k}_{v}_T{t}_L{ln}" for k, v, t, ln in CASES])
def test_scan_and_compose_models_are_bitwise_the_plain_version(K, variant,
                                                               T, L):
    """The transcribed scan's incoming deltas and end state, the
    transcribed compose's chunk ends and the backtrace from them equal the
    plain version's bitwise, and its states are viterbi_chunked_reference's
    (ties and structural zeros included, across scan and compose tiles)."""
    params = model_params(K, 2, variant, seed=10 * K + T % 97)
    X = torch.tensor(np.random.RandomState(T + K).randn(1, T, 2))
    if variant == "ties":
        X[0, ::7] = params.means[0, 0]          # frames where 0 and 1 tie
    F, din, end, psi, maps, ends, ch = plain_parts(params, X, L)
    n = ch.n
    assert n == math.ceil(T / L)
    din_m, end_m = scan_model(F, K)
    assert np.array_equal(din_m[1:], din[1:]) and end_m == end
    ends_m = compose_model(end, maps)
    assert np.array_equal(ends_m, ends)
    states = backtrace_model(psi, ends_m, T, L)
    want = hmm_cuda.viterbi_chunked_reference(X, params, L)
    assert np.array_equal(states, want[0].numpy())
    if variant == "zeros":
        assert (F <= -1e9).any()                # log 0 reached the scan
    if variant == "ties":
        assert (din_m == 0).sum(axis=1).max() >= 2   # tied maxima


def test_tiles_and_buffers_of_the_models():
    """The models' tiles reach every chunk once: a sequence whose chunk
    count is one past a multiple of each tile gives the same deltas and
    ends at the source's tiles and at tiles of 1 and of n (one tile)."""
    K, L, T = 3, 2, 2 * (2 * COMPOSE_TILE + 1)
    params = model_params(K, 1, "random", seed=5)
    X = torch.tensor(np.random.RandomState(6).randn(1, T, 1))
    F, din, end, psi, maps, ends, ch = plain_parts(params, X, L)
    assert ch.n % COMPOSE_TILE == 1 and ch.n % SCAN_TILE == 1
    for tile in (1, SCAN_TILE, ch.n):
        d, e = scan_model(F, K, tile)
        assert np.array_equal(d[1:], din[1:]) and e == end
    for tile in (1, COMPOSE_TILE, ch.n):
        assert np.array_equal(compose_model(end, maps, tile), ends)


def test_the_models_are_the_sources():
    """The transcriptions' steps and tiles stand in csrc/hmm.cu."""
    flat = " ".join(SRC.split())
    for line in (
            "if (i < K && v[i] > M) M = v[i];",
            "for (int i = 0; i < KM; ++i) vin[i] = v[i] - M;",
            "double best = __dadd_rn(vin[0], Fc[jj]);",
            "const double sc = __dadd_rn(vin[i], Fc[(i < K ? i : 0) * K + jj]);",
            "if (i < K && sc > best) best = sc;",
            "return tiles[(c / SCAN_TILE) & 1] + (c % SCAN_TILE) * KK;",
            "for (int c = t == 0 ? 1 : t * SCAN_TILE; c < c1; ++c) {",
            "for (int c = min(n, c0 + COMPOSE_TILE) - 1; c >= (c0 > 1 ? c0 : 1);",
            "s = m[(c - c0) * K + s];",
            "if (threadIdx.x == 0) ends[b * n] = s;",
            "const int* src = mb + c0 * K;",
            "const int* m = tiles[t & 1];"):
        assert " ".join(line.split()) in flat, line
    assert SCAN_TILE * 8 * 8 * 8 * 2 <= 48 * 1024       # static shared
    assert COMPOSE_TILE * 8 * 4 * 2 <= 48 * 1024
