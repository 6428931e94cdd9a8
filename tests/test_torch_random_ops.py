"""The port's samplers (mxnet_tpu_torch/ops/random_ops.py, ``nd.random``
and ``mx.random``) on the CPU.

Philox and Mersenne Twister never reproduce JAX's threefry streams, so
each sampler is held to its distribution instead: 20,000 draws from a
fixed seed against scipy's distribution, by a Kolmogorov-Smirnov test
(continuous) or a chi-square test over the support (discrete), each
passing at p > 1e-4. The seeds are fixed, so every run draws the same
numbers: a test never flips. The JAX package's ops are held alike where
they can be, and the two packages agree on every op's output shape and
dtype for the same arguments. Also: a seed reproduces the draws, ``key=``
(a ``torch.Generator``) overrides the device generator, and
``mx.random.uniform``/``normal``/``randint`` draw on the current context
(the card) unless the caller names the CPU."""
import numpy as np
import pytest
import torch
from scipy import stats

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import nd as jnd
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.ops import random_ops as tro

N = 20000
P_MIN = 1e-4


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _ks(sample, cdf):
    assert stats.kstest(np.asarray(sample, np.float64).ravel(), cdf).pvalue \
        > P_MIN


def _chi2(sample, pmf, support):
    """Chi-square of the counts over ``support`` (the rest pooled into one
    bin) against ``pmf``."""
    sample = np.asarray(sample).ravel()
    support = np.asarray(support)
    counts = np.array([(sample == k).sum() for k in support] +
                      [(~np.isin(sample, support)).sum()], np.float64)
    probs = np.append(pmf(support), max(0.0, 1.0 - pmf(support).sum()))
    keep = probs * len(sample) >= 5
    expected = probs[keep] / probs[keep].sum() * counts[keep].sum()
    assert stats.chisquare(counts[keep], expected).pvalue > P_MIN


CONTINUOUS = {
    "_random_uniform": (dict(low=-1.0, high=3.0),
                        stats.uniform(-1.0, 4.0).cdf),
    "_random_normal": (dict(loc=1.0, scale=2.0), stats.norm(1.0, 2.0).cdf),
    "_random_gamma": (dict(alpha=2.5, beta=0.5),
                      stats.gamma(2.5, scale=0.5).cdf),
    "_random_exponential": (dict(lam=2.0), stats.expon(scale=0.5).cdf),
}
DISCRETE = {
    "_random_poisson": (dict(lam=3.0), stats.poisson(3.0).pmf, range(15)),
    "_random_randint": (dict(low=2, high=9), lambda k: np.where(
        (k >= 2) & (k < 9), 1 / 7, 0.0), range(0, 11)),
    "_random_negative_binomial": (dict(k=3, p=0.4),
                                  stats.nbinom(3, 0.4).pmf, range(25)),
    "_random_generalized_negative_binomial": (
        dict(mu=2.0, alpha=0.5), stats.nbinom(2.0, 1 / (1 + 2.0 * 0.5)).pmf,
        range(20)),
}


@pytest.mark.parametrize("name", sorted(CONTINUOUS))
def test_continuous_samplers_follow_their_distribution(name):
    params, cdf = CONTINUOUS[name]
    _ks(tmx.registry.get(name).fn(shape=(N,), key=_gen(), ctx="cpu", **params)
        .numpy(), cdf)


@pytest.mark.parametrize("name", sorted(DISCRETE))
def test_discrete_samplers_follow_their_distribution(name):
    params, pmf, support = DISCRETE[name]
    _chi2(tmx.registry.get(name).fn(shape=(N,), key=_gen(1), ctx="cpu",
                                    **params).numpy(), pmf, support)


@pytest.mark.parametrize("name", sorted(CONTINUOUS) + sorted(DISCRETE))
def test_the_jax_samplers_pass_the_same_tests(name):
    """The reference's draws pass the tests the port's are held to."""
    params, *law = (CONTINUOUS.get(name) or DISCRETE[name])
    jmx.random.seed(4)
    draws = getattr(jnd, name)(shape=(N,), **params).asnumpy()
    if name in CONTINUOUS:
        _ks(draws, law[0])
    else:
        _chi2(draws, *law)


def _per_row(name, params, shape):
    with tmx.cpu():
        return getattr(tnd, name)(*[tnd.array(p) for p in params],
                                  shape=shape).asnumpy()


def test_sample_uniform_normal_gamma_exponential_per_element():
    """One distribution per parameter element, ``shape`` draws of each."""
    tmx.random.seed(5)
    low, high = np.array([0.0, -2.0], np.float32), np.array([1.0, 5.0],
                                                            np.float32)
    u = _per_row("_sample_uniform", (low, high), (N,))
    assert u.shape == (2, N)
    for i in range(2):
        _ks(u[i], stats.uniform(low[i], high[i] - low[i]).cdf)
    mu, sigma = np.array([0.0, 3.0], np.float32), np.array([1.0, 0.5],
                                                           np.float32)
    z = _per_row("_sample_normal", (mu, sigma), (N,))
    for i in range(2):
        _ks(z[i], stats.norm(mu[i], sigma[i]).cdf)
    alpha, beta = np.array([0.5, 4.0], np.float32), np.array([2.0, 0.25],
                                                             np.float32)
    g = _per_row("_sample_gamma", (alpha, beta), (N,))
    for i in range(2):
        _ks(g[i], stats.gamma(alpha[i], scale=beta[i]).cdf)
    lam = np.array([0.5, 3.0], np.float32)
    e = _per_row("_sample_exponential", (lam,), (N,))
    for i in range(2):
        _ks(e[i], stats.expon(scale=1 / lam[i]).cdf)


def test_sample_poisson_and_negative_binomials_per_element():
    tmx.random.seed(6)
    lam = np.array([1.0, 6.0], np.float32)
    p = _per_row("_sample_poisson", (lam,), (N,))
    for i in range(2):
        _chi2(p[i], stats.poisson(lam[i]).pmf, range(20))
    k, prob = np.array([2.0, 5.0], np.float32), np.array([0.3, 0.6],
                                                         np.float32)
    nb = _per_row("_sample_negative_binomial", (k, prob), (N,))
    for i in range(2):
        _chi2(nb[i], stats.nbinom(k[i], prob[i]).pmf, range(30))
    mu, alpha = np.array([1.5, 4.0], np.float32), np.array([0.5, 0.25],
                                                           np.float32)
    gnb = _per_row("_sample_generalized_negative_binomial", (mu, alpha), (N,))
    for i in range(2):
        _chi2(gnb[i], stats.nbinom(1 / alpha[i],
                                   1 / (1 + mu[i] * alpha[i])).pmf, range(30))


def test_multinomial_and_its_log_probabilities():
    probs = np.array([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]], np.float32)
    tmx.random.seed(7)
    with tmx.cpu():
        idx, logp = tnd.random.multinomial(tnd.array(probs), shape=(N,),
                                           get_prob=True)
    idx, logp = idx.asnumpy(), logp.asnumpy()
    assert idx.shape == (2, N) and idx.dtype == np.int32
    for i in range(2):
        _chi2(idx[i], lambda k, i=i: probs[i][k], range(3))
        np.testing.assert_allclose(logp[i], np.log(probs[i][idx[i]]),
                                   rtol=1e-6)
    with tmx.cpu():
        one = tnd.random.multinomial(tnd.array(probs))
    assert one.shape == (2,)


def test_lm_samplers():
    logits = np.log(np.array([[0.05, 0.15, 0.3, 0.5]] * N, np.float32))
    t = torch.from_numpy(logits)
    draws = tro.temperature_sampling(t, temperature=1.0, key=_gen(8)).numpy()
    assert draws.dtype == np.int32
    _chi2(draws, lambda k: np.exp(logits[0])[k], range(4))
    hot = tro.temperature_sampling(t, temperature=0.5, key=_gen(9)).numpy()
    sharp = np.exp(logits[0] / 0.5) / np.exp(logits[0] / 0.5).sum()
    _chi2(hot, lambda k: sharp[k], range(4))
    greedy = tro.temperature_sampling(t[:3], temperature=0.0)
    assert greedy.tolist() == [3, 3, 3]
    top2 = tro.top_k_sampling(t, k=2, key=_gen(10)).numpy()
    assert set(np.unique(top2)) <= {2, 3}
    _chi2(top2, lambda k: np.where(k == 3, 0.5 / 0.8, 0.3 / 0.8), [2, 3])


def test_shuffle_permutes_rows_uniformly():
    x = np.arange(15, dtype=np.float32).reshape(5, 3)
    with tmx.cpu():
        out = tnd.random.shuffle(tnd.array(x)).asnumpy()
        assert sorted(map(tuple, out)) == sorted(map(tuple, x))
        assert tnd._shuffle(tnd.array(x)).shape == (5, 3)
    gen = _gen(11)
    first = [int(tro.shuffle(torch.arange(5), key=gen)[0])
             for _ in range(5000)]
    _chi2(first, lambda k: np.full(np.shape(k), 0.2), range(5))


def test_unique_zipfian_is_log_uniform():
    r = 1000
    draws = tro.sample_unique_zipfian(r, shape=(N,), key=_gen(12),
                                      ctx="cpu").numpy()
    assert draws.dtype == np.int32 and draws.min() >= 0 and draws.max() < r
    _chi2(draws, lambda k: np.log((k + 2.0) / (k + 1.0)) / np.log(r),
          range(40))


SHAPES = [
    ("_random_uniform", [], dict(low=0.0, high=2.0, shape=(3, 4))),
    ("_random_normal", [], dict(shape=(2,), dtype="float32")),
    ("_random_gamma", [], dict(alpha=2.0, shape=(3,))),
    ("_random_exponential", [], dict(lam=3.0, shape=(2, 2))),
    ("_random_poisson", [], dict(lam=2.0, shape=(4,), dtype="int32")),
    ("_random_randint", [], dict(low=0, high=5, shape=(3,))),
    ("_random_negative_binomial", [], dict(k=2, p=0.5, shape=(3,))),
    ("_random_generalized_negative_binomial", [], dict(shape=(2,))),
    ("_sample_uniform", [[0.0, 1.0], [1.0, 2.0]], dict(shape=(3,))),
    ("_sample_normal", [[0.0, 1.0], [1.0, 2.0]], dict()),
    ("_sample_gamma", [[1.0, 2.0], [1.0, 1.0]], dict(shape=2)),
    ("_sample_exponential", [[1.0, 2.0]], dict(shape=(2, 3))),
    ("_sample_poisson", [[1.0, 2.0]], dict(dtype="int32")),
    ("_sample_multinomial", [[0.3, 0.7]], dict(shape=(5,))),
    ("_sample_negative_binomial", [[2.0], [0.5]], dict(shape=(4,))),
    ("_sample_generalized_negative_binomial", [[2.0], [0.5]],
     dict(shape=(4,))),
    ("shuffle", [[[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]]], dict()),
    ("temperature_sampling", [[[0.1, 0.2, 0.3]]], dict(temperature=0.7)),
    ("top_k_sampling", [[[0.1, 0.2, 0.3]]], dict(k=2)),
    ("_sample_unique_zipfian", [], dict(range_max=50, shape=(6,))),
]


@pytest.mark.parametrize("name,arrays,params", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_shapes_and_dtypes_match_jax(name, arrays, params):
    jout = getattr(jnd, name)(*[jnd.array(np.array(a, np.float32))
                                for a in arrays], **params)
    with tmx.cpu():
        tout = getattr(tnd, name)(*[tnd.array(np.array(a, np.float32))
                                    for a in arrays], **params)
    assert tout.shape == jout.shape, name
    assert tout.dtype == jout.dtype, name


def test_a_seed_reproduces_the_draws_and_key_overrides():
    def draw():
        with tmx.cpu():
            return [tnd.random.uniform(shape=(4,)).asnumpy(),
                    tnd.random.gamma(2.0, shape=(4,)).asnumpy(),
                    tnd.random.poisson(3.0, shape=(4,)).asnumpy(),
                    tnd._sample_normal(tnd.array([0.0, 1.0]),
                                       tnd.array([1.0, 2.0]),
                                       shape=(3,)).asnumpy()]

    tmx.random.seed(21)
    a = draw()
    b = draw()
    tmx.random.seed(21)
    c = draw()
    assert all(np.array_equal(x, y) for x, y in zip(a, c))
    assert not np.array_equal(a[0], b[0])
    k1 = tro.random_normal(shape=(5,), key=_gen(3), ctx="cpu")
    k2 = tro.random_normal(shape=(5,), key=_gen(3), ctx="cpu")
    assert torch.equal(k1, k2)


def test_nd_random_has_the_jax_samplers():
    for name in ("uniform", "normal", "randint", "gamma", "exponential",
                 "poisson", "multinomial", "shuffle", "seed"):
        assert hasattr(jnd.random, name) and hasattr(tnd.random, name), name
    with tmx.cpu():
        assert tnd.random.exponential(2.0, shape=(3,)).context == tmx.cpu()


def test_mx_random_draws_on_the_current_context(monkeypatch):
    """``mx.random.uniform``/``normal``/``randint`` with no device take the
    current context, gpu(0), as ``nd.random`` does: without a card they
    raise, and the CPU is taken only when named (scope or argument)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for draw in (lambda: tmx.random.uniform(shape=(2,)),
                 lambda: tmx.random.normal(shape=(2,)),
                 lambda: tmx.random.randint(0, 5, shape=(2,)),
                 lambda: tnd._random_gamma(shape=(2,))):
        with pytest.raises(MXNetError, match="CUDA is not available"):
            draw()
        with tmx.cpu():
            out = draw()
        assert getattr(out, "_data", out).device.type == "cpu"
    assert tmx.random.normal(shape=(2,), device="cpu").device.type == "cpu"
