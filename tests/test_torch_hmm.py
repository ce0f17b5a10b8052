"""The port's Gaussian HMM (spectral_tpu_torch.models.hmm, float64) held
against the JAX package's (spectral_tpu.models.hmm, float32) and against
the float64 numpy oracle of tests/test_hmmlearn_parity.py (hmmlearn's
GaussianHMM reimplemented), on the same numpy-seeded inputs, on the CPU
(the plain forms the H1 and H2 kernels follow).

Tolerances:
- against the float64 oracle: the same iteration count and Viterbi path,
  fitted parameters within ORACLE_TOL, log-likelihoods within 1e-10
  relative (both float64; they differ in summation order only);
- against brute-force enumeration: 1e-12 relative;
- against the JAX package (float32): the same Viterbi paths, state
  baselines and structural zeros; numbers within the float32 slack JAX's
  own tests allow against the oracle (1e-3 to 2e-2 relative);
- the escape-route patch, supervised_fit and the initialization: exact or
  float32-exact (the same host numpy code).
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spectral_tpu.core import events as jev  # noqa: E402
from spectral_tpu.models import hmm as jhmm  # noqa: E402
from spectral_tpu_torch.models import hmm  # noqa: E402
from test_hmmlearn_parity import HmmlearnOracle, _synthetic_features  # noqa: E402

ORACLE_TOL = 1e-9


def _params(start, trans, means, covars):
    return hmm.params_from_jax(start, trans, means, covars, device="cpu")


def _jparams(p):
    return jhmm.HMMParams(*(jnp.asarray(a, jnp.float32)
                            for a in hmm.params_to_jax(p)))


P2 = ([0.6, 0.4], [[0.7, 0.3], [0.2, 0.8]], [[0.0, 0.0], [1.5, 1.0]],
      [[0.5, 0.5], [0.8, 0.3]])


def test_params_round_trip_through_jax():
    """params_to_jax and params_from_jax are exact inverses in float64; a
    model through the JAX package's float32 HMMParams and back is the
    float32 rounding of the port's."""
    p = _params(*P2)
    back = hmm.params_to_jax(p)
    again = hmm.params_from_jax(*back, device="cpu")
    jp = jhmm.HMMParams(*map(jnp.asarray, back))
    via_jax = hmm.params_from_jax(*map(np.asarray, jp), device="cpu")
    for a, b, c, d in zip(p, back, again, via_jax):
        assert a.dtype == torch.float64 and b.dtype == np.float64
        assert torch.equal(a, c)
        np.testing.assert_array_equal(a.numpy(), b)
        assert d.dtype == torch.float64
        assert torch.equal(d, a.float().double())
    with pytest.raises(ValueError, match="device"):
        hmm.params_from_jax(*P2, device=None)


def test_log_emission_matches_hand_formula_and_jax():
    p = _params([0.5, 0.5], [[0.9, 0.1], [0.1, 0.9]],
                [[0.0, 0.0], [2.0, -1.0]], [[1.0, 0.5], [2.0, 1.0]])
    X = np.random.RandomState(0).randn(7, 2)
    got = hmm.log_emission(p, torch.from_numpy(X)).numpy()
    m, v = hmm.params_to_jax(p)[2:]
    ref = -0.5 * np.sum((X[:, None] - m[None]) ** 2 / v[None]
                        + np.log(2 * np.pi * v[None]), axis=-1)
    np.testing.assert_allclose(got, ref, rtol=1e-14)
    jax_out = np.asarray(jhmm.log_emission(_jparams(p), jnp.asarray(X,
                                                                   jnp.float32)))
    np.testing.assert_allclose(got, jax_out, rtol=1e-5, atol=1e-5)


def _brute(p, X):
    lb = hmm.log_emission(p, torch.from_numpy(X)).numpy()
    start, trans = (np.asarray(a) for a in hmm.params_to_jax(p)[:2])
    total, best, best_path = 0.0, -np.inf, None
    for path in itertools.product(range(len(start)), repeat=len(X)):
        s = np.log(start[path[0]]) + lb[0, path[0]]
        for t in range(1, len(X)):
            s += np.log(trans[path[t - 1], path[t]]) + lb[t, path[t]]
        total += np.exp(s)
        if s > best:
            best, best_path = s, path
    return np.log(total), np.array(best_path)


@pytest.mark.parametrize("T", [1, 2, 4, 5])
def test_forward_viterbi_and_score_match_brute_force(T):
    p = _params(*P2)
    X = np.random.RandomState(T).randn(T, 2)
    ll_ref, path_ref = _brute(p, X)
    lb = hmm.log_emission(p, torch.from_numpy(X))
    alpha, ll = hmm.forward_log(p, lb)
    assert float(ll) == pytest.approx(ll_ref, rel=1e-12)
    assert float(hmm.score(p, torch.from_numpy(X))) == pytest.approx(
        ll_ref, rel=1e-12)
    beta = hmm.backward_log(p, lb)
    # forward-backward identity: logsumexp(alpha + beta) == ll at every t
    ab = alpha + beta
    np.testing.assert_allclose(torch.logsumexp(ab, -1).numpy(),
                               np.full(T, ll_ref), rtol=1e-12)
    np.testing.assert_array_equal(hmm.viterbi(p, torch.from_numpy(X)).numpy(),
                                  path_ref)
    j = _jparams(p)
    np.testing.assert_array_equal(
        np.asarray(jhmm.viterbi(j, jnp.asarray(X, jnp.float32))), path_ref)


def _oracle_posteriors(o, X):
    log_b = o._log_b(X)
    la, ll = o._forward(log_b)
    lb = o._backward(log_b)
    gamma = np.exp(la + lb - ll)
    ltr = np.where(o.transmat_ > 0, np.log(np.maximum(o.transmat_, 1e-300)),
                   -1e12)
    xi = np.exp(la[:-1, :, None] + ltr[None]
                + (log_b[1:] + lb[1:])[:, None, :] - ll).sum(0)
    return gamma, xi, ll


def test_e_step_matches_oracle_and_jax():
    feats = _synthetic_features(np.random.RandomState(3))
    o = HmmlearnOracle(4)
    o._init(feats)
    p = hmm.init_params(feats, 4, device="cpu")
    gamma, xi, ll = hmm._e_step(p, torch.from_numpy(feats))
    g_o, xi_o, ll_o = _oracle_posteriors(o, feats)
    np.testing.assert_allclose(gamma.numpy(), g_o, rtol=0, atol=1e-10)
    np.testing.assert_allclose(xi.numpy(), xi_o, rtol=1e-10, atol=1e-10)
    assert float(ll) == pytest.approx(ll_o, rel=1e-12)
    g_j, xi_j, ll_j = jhmm._e_step(_jparams(p), jnp.asarray(feats,
                                                           jnp.float32))
    np.testing.assert_allclose(gamma.numpy(), np.asarray(g_j), atol=2e-2)
    assert float(ll) == pytest.approx(float(ll_j), rel=1e-3)


def test_m_step_matches_jax_and_pins_structural_zeros():
    feats = _synthetic_features(np.random.RandomState(5), T=200,
                                burst_spans=((40, 70), (120, 160)))
    p = hmm.init_params(feats, 4, device="cpu")
    trans = p.transmat.clone()
    trans[0, 3] = 0.0
    trans = trans / trans.sum(1, keepdim=True)
    start = torch.tensor([0.5, 0.5, 0.0, 0.0], dtype=torch.float64)
    p = hmm.HMMParams(start, trans, p.means, p.covars)
    X = torch.from_numpy(feats)
    gamma, xi, _ = hmm._e_step(p, X)
    new = hmm._m_step(p, X, gamma, xi)
    assert float(new.transmat[0, 3]) == 0.0
    assert torch.equal(new.startprob[2:], torch.zeros(2, dtype=torch.float64))
    np.testing.assert_allclose(new.transmat.sum(1).numpy(), 1.0, rtol=1e-14)
    # the same statistics through JAX's float32 M-step
    jnew = jhmm._m_step(_jparams(p), jnp.asarray(feats, jnp.float32),
                        jnp.asarray(gamma.numpy(), jnp.float32),
                        jnp.asarray(xi.numpy(), jnp.float32))
    for a, b in zip(new, jnew):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3,
                                   atol=1e-4)
    # a state with no responsibility keeps its mean, its variance is
    # covars_prior / 1e-5 (hmmlearn's max(denom, 1e-5))
    g0 = gamma.clone()
    g0[:, 1] = 0.0
    dead = hmm._m_step(p, X, g0, xi)
    assert torch.equal(dead.means[1], p.means[1])
    np.testing.assert_allclose(dead.covars[1].numpy(), 1e-2 / 1e-5)


@pytest.mark.parametrize("seed,k", [(0, 4), (1, 4), (2, 2)])
def test_fit_matches_oracle(seed, k):
    feats = _synthetic_features(np.random.RandomState(seed))
    o = HmmlearnOracle(k, n_iter=100).fit(feats)
    p0 = hmm.init_params(feats, k, device="cpu")
    params, ll, it = hmm.fit(p0, torch.from_numpy(feats), n_iter=100)
    assert int(it) == len(o.lls_)
    assert float(ll) == pytest.approx(o.lls_[-1], rel=1e-10)
    for got, want in ((params.means, o.means_), (params.covars, o.covars_),
                      (params.transmat, o.transmat_),
                      (params.startprob, o.startprob_)):
        np.testing.assert_allclose(got.numpy(), want, rtol=ORACLE_TOL,
                                   atol=ORACLE_TOL)
    states = hmm.viterbi(params, torch.from_numpy(feats)).numpy()
    np.testing.assert_array_equal(states, o.predict(feats))
    # JAX's float32 fit decodes the same path (its own test's claim)
    jp, _, _ = jhmm.fit(_jparams(p0), jnp.asarray(feats, jnp.float32),
                        n_iter=100)
    np.testing.assert_array_equal(
        np.asarray(jhmm.viterbi(jp, jnp.asarray(feats, jnp.float32))), states)


def test_em_trajectory_matches_oracle():
    feats = _synthetic_features(np.random.RandomState(4))
    o = HmmlearnOracle(4, n_iter=5, tol=-np.inf).fit(feats)
    p = hmm.init_params(feats, 4, device="cpu")
    X = torch.from_numpy(feats)
    for i in range(5):
        p, ll, it = hmm.fit(p, X, n_iter=1, tol=-np.inf)
        assert int(it) == 1
        assert float(ll) == pytest.approx(o.lls_[i], rel=1e-10), i


def test_fit_stops_by_hmmlearn_rule_and_batches_like_vmap():
    feats = [_synthetic_features(np.random.RandomState(s), T=150,
                                 burst_spans=((30, 60), (90, 120)))
             for s in (10, 11, 12)]
    X = torch.from_numpy(np.stack(feats))
    p0 = [hmm.init_params(f, 4, device="cpu") for f in feats]
    batch0 = hmm.HMMParams(*(torch.stack(a) for a in zip(*p0)))
    pb, llb, itb = hmm.fit(batch0, X, n_iter=100)
    for b in range(3):
        p1, ll1, it1 = hmm.fit(p0[b], X[b], n_iter=100)
        assert int(itb[b]) == int(it1)
        assert float(llb[b]) == pytest.approx(float(ll1), rel=1e-13)
        for a, c in zip(pb, p1):
            np.testing.assert_allclose(a[b].numpy(), c.numpy(), rtol=1e-12,
                                       atol=1e-14)
    # a tolerance no gain reaches stops at the first chance, it == 2 (the
    # first gain is against -inf); n_iter caps it
    _, _, it = hmm.fit(batch0, X, n_iter=100, tol=1e30)
    assert it.tolist() == [2, 2, 2]
    _, _, it = hmm.fit(batch0, X, n_iter=1)
    assert it.tolist() == [1, 1, 1]
    _, _, it = hmm.fit(batch0, X, n_iter=0)
    assert it.tolist() == [0, 0, 0]


def test_init_params_matches_oracle_and_jax():
    feats = _synthetic_features(np.random.RandomState(1))
    o = HmmlearnOracle(4)
    o._init(feats)
    p = hmm.init_params(feats, 4, device="cpu")
    np.testing.assert_allclose(p.means.numpy(), o.means_, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(p.covars.numpy(), o.covars_, rtol=1e-12)
    j = jhmm.init_params(feats, 4)
    for a, b in zip(p, j):
        np.testing.assert_array_equal(a.numpy().astype(np.float32),
                                      np.asarray(b))
    one = hmm.init_params(feats[:1], 1, device="cpu")
    np.testing.assert_allclose(one.covars.numpy(), [[1e-3, 1e-3]])


def test_supervised_fit_matches_jax():
    rng = np.random.RandomState(0)
    X = rng.randn(60, 2)
    labels = np.zeros(60, int)
    labels[10] = 1
    labels[11:20] = 2
    labels[20] = 3
    labels[40] = 1                      # a state with a single sample
    for n_states in (4, 3, 5):
        got = hmm.supervised_fit(X, labels % n_states, n_states,
                                 device="cpu")
        want = jhmm.supervised_fit(X, labels % n_states, n_states)
        for a, b in zip(got, want):
            assert a.dtype == torch.float64
            np.testing.assert_array_equal(a.numpy().astype(np.float32),
                                          np.asarray(b))


@pytest.mark.parametrize("seed", range(4))
def test_escape_patch_equals_jax_traced_and_host(seed):
    rng = np.random.RandomState(seed)
    tm = rng.rand(4, 4)
    tm[:, seed % 4] *= 1e-7
    tm[seed % 4] = rng.rand(4)
    tm /= tm.sum(1, keepdims=True)
    for base in range(4):
        host = hmm.patch_escape_routes(tm, base)
        np.testing.assert_array_equal(host, jhmm.patch_escape_routes(tm, base))
        traced = hmm.patch_escape_routes_traced(torch.from_numpy(tm),
                                                torch.tensor(base))
        np.testing.assert_array_equal(traced.numpy(), host)
    batch = torch.from_numpy(np.stack([tm, tm.T / tm.T.sum(1, keepdims=True)]))
    out = hmm.patch_escape_routes_traced(batch, torch.tensor([1, 2]))
    np.testing.assert_array_equal(out[0].numpy(),
                                  hmm.patch_escape_routes(tm, 1))
    np.testing.assert_array_equal(out[1].numpy(), hmm.patch_escape_routes(
        batch[1].numpy(), 2))


def test_unsupervised_fit_decode_matches_staged_flow_and_jax():
    feats = _synthetic_features(np.random.RandomState(7), T=500,
                                burst_spans=((60, 110), (200, 260)))
    X = torch.from_numpy(feats)
    p0 = hmm.init_params(feats, 4, device="cpu")
    params, states, base, ll, it = hmm.unsupervised_fit_decode(p0, X)
    fitted, ll2, it2 = hmm.fit(p0, X)
    b2 = int(np.argmin(fitted.means[:, 0].numpy()))
    patched = hmm.patch_escape_routes(fitted.transmat, b2)
    np.testing.assert_array_equal(params.transmat.numpy(), patched)
    assert int(base) == b2 and int(it) == int(it2)
    np.testing.assert_array_equal(states.numpy(), hmm.viterbi(
        fitted._replace(transmat=torch.from_numpy(patched)), X).numpy())
    _, jstates, jbase, _, _ = jhmm.unsupervised_fit_decode(
        _jparams(p0), jnp.asarray(feats, jnp.float32))
    assert int(jbase) == int(base)
    np.testing.assert_array_equal(np.asarray(jstates), states.numpy())


def test_hmm_runs_no_matrix_product(monkeypatch):
    """No dot anywhere on the HMM's path, so no TF32 can enter it (the
    counterpart of tests/test_hmm.py::test_em_dots_are_highest_precision):
    every matrix product torch offers raises, and the flows still run."""
    from spectral_tpu_torch.models import hmm_pscan

    def no_dot(*args, **kwargs):
        raise AssertionError("a matrix product on the HMM's path")

    for name in ("matmul", "mm", "bmm", "einsum", "tensordot", "dot",
                 "inner"):
        monkeypatch.setattr(torch, name, no_dot)
    monkeypatch.setattr(torch.Tensor, "__matmul__", no_dot)
    monkeypatch.setattr(torch.Tensor, "matmul", no_dot)
    feats = _synthetic_features(np.random.RandomState(8), T=120,
                                burst_spans=((30, 60),))
    X = torch.from_numpy(feats)
    p0 = hmm.init_params(feats, 4, device="cpu")
    hmm.unsupervised_fit_decode(p0, X, n_iter=3)
    hmm_pscan.unsupervised_fit_decode(p0, X, n_iter=3)
    hmm._e_step(p0, X)
    hmm_pscan.e_step(p0, X)


def test_roi_two_state_fit_matches_oracle():
    feats = _synthetic_features(np.random.RandomState(11), T=120,
                                burst_spans=((40, 80),))
    o = HmmlearnOracle(2, n_iter=50).fit(feats)
    p0 = hmm.init_params(feats, 2, device="cpu")
    params, _, it = hmm.fit(p0, torch.from_numpy(feats), n_iter=50)
    assert int(it) == len(o.lls_)
    np.testing.assert_array_equal(
        hmm.viterbi(params, torch.from_numpy(feats)).numpy(),
        o.predict(feats))
    assert int(torch.argmax(params.means[:, 0])) == int(
        np.argmax(o.means_[:, 0]))


def test_label_track_supervised_decode_matches_jax():
    """learn_and_detect's model (1e-6 variances, structural zeros) decodes
    the same path in both packages on the detector fixture's features."""
    feats = _synthetic_features(np.random.RandomState(2), T=300,
                                burst_spans=((50, 90), (150, 230)))
    t = np.arange(300.0)
    labels = jev.build_label_track(t, [(55.0, 85.0), (160.0, 220.0)])
    p = hmm.supervised_fit(feats, labels, 4, device="cpu")
    j = jhmm.supervised_fit(feats, labels, 4)
    got = hmm.viterbi(p, torch.from_numpy(feats)).numpy()
    want = np.asarray(jhmm.viterbi(j, jnp.asarray(feats, jnp.float32)))
    np.testing.assert_array_equal(got, want)


def test_lattices_and_score_match_jax_and_oracle():
    """forward_log, backward_log and score against the float64 oracle's
    lattices (1e-12 of their magnitude) and the JAX package's float32 ones
    near each frame's max (1e-4 relative; far below it float32 keeps
    nothing)."""
    feats = _synthetic_features(np.random.RandomState(6))
    p = hmm.init_params(feats, 4, device="cpu")
    X = torch.from_numpy(feats)
    lb = hmm.log_emission(p, X)
    alpha, ll = hmm.forward_log(p, lb)
    beta = hmm.backward_log(p, lb)
    o = HmmlearnOracle(4)
    o._init(feats)
    la, ll_o = o._forward(o._log_b(feats))
    lbeta = o._backward(o._log_b(feats))
    scale = np.abs(la).max()
    np.testing.assert_allclose(alpha.numpy(), la, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(beta.numpy(), lbeta, rtol=0,
                               atol=1e-12 * np.abs(lbeta).max())
    assert float(ll) == pytest.approx(ll_o, rel=1e-13)
    assert float(hmm.score(p, X)) == float(ll)
    j = _jparams(p)
    jx = jnp.asarray(feats, jnp.float32)
    jlb = jhmm.log_emission(j, jx)
    a_j, ll_j = jhmm.forward_log(j, jlb)
    b_j = np.asarray(jhmm.backward_log(j, jlb), np.float64)
    near = (alpha >= alpha.amax(-1, keepdim=True) - 20.0).numpy()
    np.testing.assert_allclose(alpha.numpy()[near],
                               np.asarray(a_j, np.float64)[near], rtol=1e-4,
                               atol=1e-3)
    assert float(ll) == pytest.approx(float(ll_j), rel=1e-4)
    assert float(hmm.score(p, X)) == pytest.approx(
        float(jhmm.score(j, jx)), rel=1e-4)
    near_b = (beta >= beta.amax(-1, keepdim=True) - 20.0).numpy()
    np.testing.assert_allclose(beta.numpy()[near_b], b_j[near_b], rtol=1e-4,
                               atol=1e-3)
