"""H2's block form (``csrc/hmm.cu::hmm_viterbi_kernel``): its chain, its
emission schedule and its parallel backtrace transcribed in numpy and held
on the CPU, bitwise, to the plain version
(``ops/hmm_cuda.py::viterbi_seq_reference``, ``models/hmm.py::
_viterbi_plain``) and to the JAX package's ``viterbi``
(``spectral_tpu/models/hmm.py:104``).

- ``chain_model``: d[t, j] = max_i (d[t - 1, i] + LA[i, j]) + lb[t, j],
  the adds and the strict-> compares in index order (the first index wins
  a tie), the end state the first j attaining the max; its backpointers
  psi (T, K) as the kernel stores them.
- ``backtrace_model``: THREADS runs of rows, each composed into its map (a
  byte a state), the maps composed from the end in log2(THREADS) rounds
  (maps[i] <- maps[i] o maps[i + d], every thread reading before any
  writes), each run re-walked from its end state; every frame written
  once.
- ``emission_schedule``: the first VIT_EM_FIRST frames by every thread,
  then tiles of VIT_EM_TILE frames by warps 1-3, published in order: every
  frame's emissions written once, before the chain reads them.

Cases: K 1-8; T from 1 to 2,047, T below the runs' count (128) and T not
a multiple of it; exact ties (two states alike in every parameter);
-1e10 zeros in the start and transition probabilities. The JAX package
runs in float32 (its default): its states are compared where the float64
and float32 paths cannot part, on features whose states lie far apart
(the bursty detection features, chip_smoke.py's ``hmm_features``), and at
the ties and zeros cases.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spectral_tpu.models import hmm as jhmm  # noqa: E402
from spectral_tpu_torch.models import hmm  # noqa: E402
from spectral_tpu_torch.ops import hmm_cuda  # noqa: E402

SRC = (Path(hmm_cuda.__file__).resolve().parent / "csrc" / "hmm.cu"
       ).read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


THREADS = _constant("THREADS")
VIT_EM_FIRST = _constant("VIT_EM_FIRST")
VIT_EM_TILE = _constant("VIT_EM_TILE")
KM_OF = {1: 2, 2: 2, 3: 4, 4: 4, 5: 8, 6: 8, 7: 8, 8: 8}


def features(seed, T):
    """Detection-like features (T, 2): log-power about -6 with bursts about
    -3, its delta second (chip_smoke.py's hmm_features)."""
    rng = np.random.RandomState(seed)
    logp = -6.0 + 0.15 * rng.randn(T)
    for _ in range(max(1, T // 200)):
        a = int(rng.randint(0, max(1, T - 3)))
        n = int(rng.randint(3, max(4, T // 8)))
        logp[a:a + n] = -3.0 + 0.2 * rng.randn(len(logp[a:a + n]))
    return np.stack([logp, np.diff(logp, prepend=logp[0])], axis=1)


def model(seed, T, K, kind):
    """(X (T, 2), params) from the k-means start of the features; "ties":
    states 1 and 2 alike in every parameter; "zeros": startprob [.5, .5,
    0, ..] and transmat[0, K - 1], transmat[K - 1, 1] pinned at 0."""
    f = features(seed, max(T, 64))
    p = hmm.init_params(f, K, device="cpu")
    start, trans, means, covars = (t.clone() for t in p)
    if kind == "ties":
        means[2], covars[2] = means[1], covars[1]
        trans[:, 1:3] = ((trans[:, 1] + trans[:, 2]) / 2)[:, None]
        trans[2] = trans[1]
        start[1:3] = (start[1] + start[2]) / 2
    elif kind == "zeros":
        start.zero_()
        start[:2] = 0.5
        trans[0, K - 1] = 0.0
        trans[K - 1, 1 % K] = 0.0
        trans = trans / trans.sum(dim=1, keepdim=True)
    return f[:T], hmm.HMMParams(start, trans, means, covars)


def chain_model(lb, LS, LA):
    """The chain: (psi (T, K) uint8, the end state); Python floats are
    float64 and round each add as the kernel's __dadd_rn does."""
    T, K = lb.shape
    d = [LS[j] + lb[0, j] for j in range(K)]
    psi = np.zeros((T, K), np.uint8)
    for t in range(1, T):
        nd = []
        for j in range(K):
            best, a = d[0] + LA[0, j], 0
            for i in range(1, K):
                sc = d[i] + LA[i, j]
                if sc > best:
                    best, a = sc, i
            nd.append(best + lb[t, j])
            psi[t, j] = a
        d = nd
    end, best = 0, d[0]
    for j in range(1, K):
        if d[j] > best:
            best, end = d[j], j
    return psi, end


def backtrace_model(psi, end, S=THREADS):
    """vit_backtrace_block: the states (T,) from psi and the end state."""
    T, K = psi.shape
    rows = T - 1
    runs = [(1 + i * rows // S, 1 + (i + 1) * rows // S) for i in range(S)]
    maps = []
    for a, b in runs:
        s = list(range(8))
        for t in range(b - 1, a - 1, -1):
            s = [int(psi[t, s[x]]) if x < K else s[x] for x in range(8)]
        maps.append(s)
    d = 1
    while d < S:
        read = [list(m) for m in maps]           # every thread reads first
        for i in range(S):
            if i + d < S:
                maps[i] = [read[i][read[i + d][x]] for x in range(8)]
        d *= 2
    out = np.full(T, -1)
    writes = np.zeros(T, int)
    for i, (a, b) in enumerate(runs):
        st = maps[i + 1][end] if i + 1 < S else end
        if i == S - 1:
            out[T - 1] = end
            writes[T - 1] += 1
        for t in range(b - 1, a - 1, -1):
            st = int(psi[t, st])
            out[t - 1] = st
            writes[t - 1] += 1
    assert (writes == 1).all()
    return out


def serial_backtrace(psi, end):
    T = len(psi)
    out = np.empty(T, int)
    out[T - 1] = s = end
    for t in range(T - 1, 0, -1):
        s = int(psi[t, s])
        out[t - 1] = s
    return out


def kernel_states(X, p):
    """The block form's states by the models, on the plain version's lb."""
    Xt = torch.from_numpy(np.asarray(X, np.float64))[None]
    pb = hmm.HMMParams(*(t[None] for t in p))
    lb = hmm._log_emission_b(pb, Xt)[0].numpy()
    psi, end = chain_model(lb, hmm._safe_log(p.startprob).numpy(),
                           hmm._safe_log(p.transmat).numpy())
    return backtrace_model(psi, end), psi, end


def plain_states(X, p):
    Xt = torch.from_numpy(np.asarray(X, np.float64))[None]
    return hmm_cuda.viterbi_seq_reference(
        Xt, tuple(t[None] for t in p))[0].numpy()


CASES = ([(T, 4, "fit") for T in (1, 2, 3, 5, 100, 127, 128, 129, 130, 257,
                                  1070, 2047)]
         + [(300, K, "fit") for K in (1, 2, 3, 5, 6, 7, 8)]
         + [(1000, K, "fit") for K in (2, 8)]
         + [(T, 4, kind) for T in (7, 600) for kind in ("ties", "zeros")]
         + [(500, 8, "ties"), (500, 3, "zeros")])


@pytest.mark.parametrize("T,K,kind", CASES)
def test_block_form_is_the_plain_version(T, K, kind):
    """The chain and the parallel backtrace give the plain version's states
    bitwise; the parallel walk is the serial one."""
    X, p = model(T + 10 * K, T, K, kind)
    got, psi, end = kernel_states(X, p)
    assert np.array_equal(got, plain_states(X, p))
    assert np.array_equal(got, serial_backtrace(psi, end))
    if kind == "ties":
        assert 2 not in got             # the first of two equal states wins


@pytest.mark.parametrize("T,K,kind", [(1, 4, "fit"), (2, 4, "fit"),
                                      (129, 4, "fit"), (600, 4, "fit"),
                                      (300, 2, "fit"), (300, 3, "fit"),
                                      (300, 6, "fit"), (300, 8, "fit"),
                                      (600, 4, "ties"), (600, 4, "zeros")])
def test_block_form_matches_jax_viterbi(T, K, kind):
    X, p = model(T + 10 * K, T, K, kind)
    got = kernel_states(X, p)[0]
    jp = jhmm.HMMParams(*(jnp.asarray(a, jnp.float32)
                          for a in hmm.params_to_jax(p)))
    want = np.asarray(jhmm.viterbi(jp, jnp.asarray(X, jnp.float32)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("K", range(1, 9))
def test_parallel_backtrace_is_the_serial_walk(K):
    """Random backpointer tables (any T from 1 to 2,047): the composed maps
    and the re-walks give the serial walk's states, for every end state."""
    rng = np.random.RandomState(K)
    for T in (1, 2, 64, 127, 128, 129, 255, 256, 1070, 2047):
        psi = rng.randint(0, K, size=(T, K)).astype(np.uint8)
        for end in range(K):
            assert np.array_equal(backtrace_model(psi, end),
                                  serial_backtrace(psi, end))


def emission_schedule(T, scratch=False):
    """The frames each phase writes, in publication order, and the flag's
    values: [0, first) by every thread, then warps 1-3's tiles."""
    first = T if scratch else min(T, VIT_EM_FIRST)
    tiles = [(0, first)]
    ready = [first]
    for t0 in range(first, T, VIT_EM_TILE):
        tiles.append((t0, min(T, t0 + VIT_EM_TILE)))
        ready.append(tiles[-1][1])
    return tiles, ready


@pytest.mark.parametrize("T", [1, 31, 32, 33, 96, 97, 1070, 2047])
def test_emission_schedule_covers_every_frame_once(T):
    """Every frame's emissions are written once, the flag rises through
    each tile's end to T, and the chain, waiting for frame t + 1 before it
    reads it, never reads a frame the flag has not passed."""
    for scratch in (False, True):
        tiles, ready = emission_schedule(T, scratch)
        frames = [t for a, b in tiles for t in range(a, b)]
        assert frames == list(range(T))
        assert ready == sorted(ready) and ready[-1] == T
        for t in range(T):
            assert any(r > t for r in ready)


def test_threads_split_the_emissions_of_a_tile():
    """vit_emissions' index walk: thread tid of n takes i = t0 K + tid,
    + n, ... below t1 K, frame i / K and state i % K: every (t, k) of the
    tile once."""
    for K in (1, 2, 4, 6, 8):
        for t0, t1, n in ((0, 32, THREADS), (32, 96, THREADS - 32),
                          (1056, 1070, THREADS - 32)):
            seen = [(i // K, i % K) for tid in range(n)
                    for i in range(t0 * K + tid, t1 * K, n)]
            assert sorted(seen) == [(t, k) for t in range(t0, t1)
                                    for k in range(K)]
