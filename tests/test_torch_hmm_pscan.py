"""The port's chunked-scan HMM engine (spectral_tpu_torch.models.hmm_pscan,
the plain form of the H3 kernel and of H2's chunked form) held against the
port's sequential engine (models/hmm.py), the JAX package's
parallel-prefix engine (spectral_tpu.models.hmm_pscan) and the float64
oracle of tests/test_hmmlearn_parity.py, at T 1-3 and 2,048-8,192 (chunks
of 256 frames: one chunk, full chunks and a ragged last one).

Tolerances:
- against the sequential engine (both float64, the same model):
  log-likelihoods within 1e-11 relative, gamma within 1e-9, xi within
  1e-9 of its largest entry, log alpha and log beta within 1e-9 of their
  magnitude; the Viterbi paths identical;
- against the JAX engine (float32; its gamma holds ~1.7e-7 against the
  oracle, spectral_tpu/models/hmm_pscan.py:40): gamma within 1e-4, the
  Viterbi paths identical where its tests pin them (T <= 8192), the
  log-likelihood within 1e-4 relative and log alpha within 1e-4 relative
  within 20 nats of each frame's max (JAX's float32 blocks keep no more,
  spectral_tpu/models/hmm_pscan.py:265-267);
- fits: parameters within 1e-9 of the sequential engine's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spectral_tpu.models import hmm as jhmm  # noqa: E402
from spectral_tpu.models import hmm_pscan as jps  # noqa: E402
from spectral_tpu_torch.models import hmm, hmm_pscan  # noqa: E402
from spectral_tpu_torch.ops import hmm_cuda  # noqa: E402
from test_hmmlearn_parity import HmmlearnOracle, _synthetic_features  # noqa: E402

LONG = (2048, 2303, 8192)          # one chunk past, ragged, 32 chunks

# the JAX engine as one program each (op by op it dispatches thousands of
# small operations below 4096 frames)
_jax_e_step = jax.jit(jps.e_step)
_jax_viterbi = jax.jit(jps.viterbi)
_jax_score = jax.jit(jps.score)
_jax_forward = jax.jit(lambda p, x: jps.forward_log(p, jhmm.log_emission(p,
                                                                         x)))


def _jax_model(p):
    return jhmm.HMMParams(*(jnp.asarray(a, jnp.float32)
                            for a in hmm.params_to_jax(p)))


def _feats(T, seed=0):
    """The parity tests' features, a burst every 400 frames (none below
    200 frames)."""
    rng = np.random.RandomState(seed)
    starts = np.sort(rng.choice(T - 130, T // 400, replace=False)) \
        if T >= 200 else []
    spans = tuple((int(a), int(a) + int(rng.randint(5, 120)))
                  for a in starts)
    return _synthetic_features(rng, T=T, burst_spans=spans)


def _model(T, seed=0, k=4):
    """A model fitted to a short stretch of the same distribution, as the
    detector's would be."""
    f = _feats(600, seed + 100)
    p, _, _ = hmm.fit(hmm.init_params(f, k, device="cpu"),
                      torch.from_numpy(f), n_iter=20)
    base = torch.argmin(p.means[:, 0])
    return p._replace(transmat=hmm.patch_escape_routes_traced(p.transmat,
                                                              base))


def _close_logs(got, want):
    """Log lattices: -inf (a state no path reaches, under this model's
    structural zeros) in the same places, the rest within 1e-9 of the
    lattice's magnitude."""
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf)
    fin = want[~inf]
    assert float((got[~inf] - fin).abs().max()) <= 1e-9 * max(
        float(fin.abs().max()), 1.0)


@pytest.fixture(scope="module")
def model():
    return _model(0)


def test_chunk_length_fits_the_kernels():
    assert hmm_cuda.chunk_len(4) == 256 and hmm_cuda.chunk_len(2) == 256
    for k in range(1, hmm_cuda.MAX_STATES + 1):
        L = hmm_cuda.chunk_len(k)
        assert 1 <= L <= hmm_cuda.CHUNK_MAX and L * k <= hmm_cuda.CHUNK_CAP


@pytest.mark.parametrize("T", (1, 2, 3) + LONG)
def test_forward_backward_match_sequential(model, T):
    X = torch.from_numpy(_feats(T, T))
    lb = hmm.log_emission(model, X)
    a_s, ll_s = hmm.forward_log(model, lb)
    a_p, ll_p = hmm_pscan.forward_log(model, lb)
    assert float(ll_p) == pytest.approx(float(ll_s), rel=1e-11)
    _close_logs(a_p, a_s)
    _close_logs(hmm_pscan.backward_log(model, lb),
                hmm.backward_log(model, lb))


@pytest.mark.parametrize("T", (1, 2, 3) + LONG)
def test_e_step_matches_sequential(model, T):
    X = torch.from_numpy(_feats(T, T + 1))
    g_s, xi_s, ll_s = hmm._e_step(model, X)
    g_p, xi_p, ll_p = hmm_pscan.e_step(model, X)
    assert float(ll_p) == pytest.approx(float(ll_s), rel=1e-11)
    assert float((g_p - g_s).abs().max()) <= 1e-9
    assert float((xi_p - xi_s).abs().max()) <= 1e-9 * max(
        float(xi_s.abs().max()), 1.0)
    # the statistics form (the H3 kernel's output layout)
    st, ll = hmm_pscan.e_step_stats(model, X)
    g0, gs, gx, gx2, xs = st
    assert float(ll) == float(ll_p)
    np.testing.assert_allclose(g0.numpy(), g_s[0].numpy(), atol=1e-9)
    np.testing.assert_allclose(gs.numpy(), g_s.sum(0).numpy(), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(gx.numpy(), (g_s.T @ X).numpy(), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(gx2.numpy(), (g_s.T @ (X * X)).numpy(),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(xs.numpy(), xi_s.numpy(), rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("T", (3, 8192))
def test_e_step_against_jax_and_the_oracle(model, T):
    feats = _feats(T, 3)
    X = torch.from_numpy(feats)
    g_p, xi_p, ll_p = hmm_pscan.e_step(model, X)
    g_j, _, ll_j = _jax_e_step(_jax_model(model),
                               jnp.asarray(feats, jnp.float32))
    assert float((g_p - torch.from_numpy(np.asarray(g_j,
                                                    np.float64))).abs().max()
                 ) <= 1e-4
    assert float(ll_p) == pytest.approx(float(ll_j), rel=1e-4)
    o = HmmlearnOracle(4)
    o.startprob_, o.transmat_, o.means_, o.covars_ = hmm.params_to_jax(model)
    la, ll_o = o._forward(o._log_b(feats))
    assert float(ll_p) == pytest.approx(ll_o, rel=1e-11)


@pytest.mark.parametrize("T", (1, 2048))
def test_forward_log_and_score_match_jax(model, T):
    feats = _feats(T, T + 3)
    X = torch.from_numpy(feats)
    jp = _jax_model(model)
    jx = jnp.asarray(feats, jnp.float32)
    a_j, ll_j = _jax_forward(jp, jx)
    a_p, ll_p = hmm_pscan.forward_log(model, hmm.log_emission(model, X))
    assert float(ll_p) == pytest.approx(float(ll_j), rel=1e-4)
    assert float(hmm_pscan.score(model, X)) == pytest.approx(
        float(_jax_score(jp, jx)), rel=1e-4)
    near = a_p >= a_p.amax(dim=-1, keepdim=True) - 20.0
    np.testing.assert_allclose(a_p[near].numpy(),
                               np.asarray(a_j, np.float64)[near.numpy()],
                               rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("T", (1, 2, 3, 255, 256, 257) + LONG)
def test_viterbi_matches_sequential_and_jax(model, T):
    feats = _feats(T, T + 2)
    X = torch.from_numpy(feats)
    seq = hmm.viterbi(model, X)
    par = hmm_pscan.viterbi(model, X)
    assert par.dtype == torch.int32 and tuple(par.shape) == (T,)
    assert torch.equal(par, seq)
    if T in (3, 2048, 8192):
        np.testing.assert_array_equal(np.asarray(_jax_viterbi(
            _jax_model(model), jnp.asarray(feats, jnp.float32))), par.numpy())


def test_viterbi_on_structural_zeros_and_supervised_variances():
    """A supervised model: startprob [1, 0, 0, 0], a deterministic 3 -> 0
    row, 1e-6 variances (emission log-likelihoods 1e5 apart): -1e10 for
    log 0 keeps the engines' paths identical, and equal to JAX's."""
    feats = _feats(3000, 9)
    from spectral_tpu_torch.core import events as ev
    t = np.arange(3000.0)
    labels = ev.build_label_track(t, [(300.0, 500.0), (1500.0, 1800.0)])
    p = hmm.supervised_fit(feats, labels, 4, device="cpu")
    X = torch.from_numpy(feats)
    seq = hmm.viterbi(p, X)
    assert torch.equal(hmm_pscan.viterbi(p, X), seq)
    j = jhmm.supervised_fit(feats, labels, 4)
    np.testing.assert_array_equal(
        np.asarray(jhmm.viterbi(j, jnp.asarray(feats, jnp.float32))),
        seq.numpy())


def test_batched_matches_one_by_one(model):
    feats = [_feats(2100, s) for s in range(3)]
    X = torch.from_numpy(np.stack(feats))
    states = hmm_pscan.viterbi(model, X)
    st, ll = hmm_pscan.e_step_stats(model, X)
    for b in range(3):
        assert torch.equal(states[b], hmm_pscan.viterbi(model, X[b]))
        st1, ll1 = hmm_pscan.e_step_stats(model, X[b])
        assert float(ll[b]) == pytest.approx(float(ll1), rel=1e-14)
        for a, c in zip(st, st1):
            np.testing.assert_allclose(a[b].numpy(), c.numpy(), rtol=1e-13,
                                       atol=1e-13)


def test_fit_and_decode_match_sequential():
    feats = _feats(2304, 5)
    X = torch.from_numpy(feats)
    p0 = hmm.init_params(feats, 4, device="cpu")
    p_s, ll_s, it_s = hmm.fit(p0, X, n_iter=4)
    p_p, ll_p, it_p = hmm_pscan.fit(p0, X, n_iter=4)
    assert int(it_p) == int(it_s) == 4
    assert float(ll_p) == pytest.approx(float(ll_s), rel=1e-11)
    for a, b in zip(p_p, p_s):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-9)
    out_p = hmm_pscan.unsupervised_fit_decode(p0, X, n_iter=4)
    out_s = hmm.unsupervised_fit_decode(p0, X, n_iter=4)
    assert torch.equal(out_p[1], out_s[1]) and int(out_p[2]) == int(out_s[2])
    assert float(hmm_pscan.score(p_s, X)) == pytest.approx(
        float(hmm.score(p_s, X)), rel=1e-11)
    # a batch of two that converge at different iterations (9 and 8 at a
    # tolerance of 2 nats): the loop steps each to its own end
    feats = [_feats(2304, s) for s in (5, 8)]
    Xb = torch.from_numpy(np.stack(feats))
    pb = hmm.HMMParams(*(torch.stack(a) for a in zip(*[
        hmm.init_params(f, 4, device="cpu") for f in feats])))
    p_s, ll_s, it_s = hmm.fit(pb, Xb, n_iter=30, tol=2.0)
    p_p, ll_p, it_p = hmm_pscan.fit(pb, Xb, n_iter=30, tol=2.0)
    assert torch.equal(it_p, it_s) and it_p.tolist() == [9, 8]
    np.testing.assert_allclose(ll_p.numpy(), ll_s.numpy(), rtol=1e-11)
    for a, b in zip(p_p, p_s):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-9)


@pytest.mark.parametrize("k", [2, 6])
def test_other_state_counts_chunk(k):
    """K = 2 (the ROI model) and K = 6 (chunks of 170 frames) through the
    chunked engine."""
    feats = _feats(2500, 6)
    X = torch.from_numpy(feats)
    p = _model(0, 6, k=k)
    assert torch.equal(hmm_pscan.viterbi(p, X), hmm.viterbi(p, X))
    _, ll_s = hmm.forward_log(p, hmm.log_emission(p, X))
    assert float(hmm_pscan.score(p, X)) == pytest.approx(float(ll_s),
                                                         rel=1e-11)
