"""The port's rolled static-offset matvec (``ops/rolled_gather.py``) against
the JAX package's: host tables equal exactly (single and multi-slot), the
torch appliers against a brute-force ``[R, K]`` matvec at 1e-13 of the peak
(the JAX test's bound, tests/test_poisson_rolled.py), and the builder's
refusal and degenerate cases."""
import numpy as np
import pytest
import torch

from dccrg_tpu.ops import rolled_gather as jr
from dccrg_tpu_torch.ops import rolled_gather as tr


def _brute(nbr, mult, scaling, x):
    return scaling * x + (mult * x[nbr]).sum(-1)


def _operator(seed, R=None, K=None):
    """tests/test_poisson_rolled.py's random operator: most entries on a
    short offset head, a random tail."""
    rng = np.random.default_rng(seed)
    R = int(rng.integers(8, 400)) if R is None else R
    K = int(rng.integers(1, 9)) if K is None else K
    nbr = rng.integers(0, R, (R, K))
    mult = rng.standard_normal((R, K))
    mult[rng.random((R, K)) < 0.4] = 0.0
    for k in range(K):
        o = int(rng.integers(-4, 5))
        tgt = np.arange(R) + o
        ok = (rng.random(R) < 0.8) & (tgt >= 0) & (tgt < R)
        nbr[ok, k] = tgt[ok]
    return nbr, mult, rng.standard_normal(R), rng.standard_normal(R)


def _same_tables(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "offsets":
            assert list(a[k]) == list(b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype


@pytest.mark.parametrize("max_terms", [tr.MAX_TERMS, 2])
@pytest.mark.parametrize("seed", range(4))
def test_tables_match_jax_and_apply_matches_brute_force(seed, max_terms):
    nbr, mult, scaling, x = _operator(seed)
    t = tr.build_rolled_matvec(nbr, mult, scaling, max_terms=max_terms,
                               max_exc_frac=1.0)
    _same_tables(t, jr.build_rolled_matvec(nbr, mult, scaling,
                                           max_terms=max_terms, max_exc_frac=1.0))
    ref = _brute(nbr, mult, scaling, x)
    y = tr.make_rolled_apply(t, torch.float64, "cpu")(torch.from_numpy(x)).numpy()
    assert np.abs(y - ref).max() < 1e-13 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("seed", range(2))
def test_multi_tables_match_jax_and_apply_matches_brute_force(seed):
    """Three slots, each its own operator (dense terms only for offsets on
    2% of the rows: the planted head; the random tail is exceptions): the
    union offset set, padded exception lists, and the batched applier."""
    ops = [_operator(10 * seed + d, R=300, K=6) for d in range(3)]
    nbr, mult, scaling, x = (np.stack([o[i] for o in ops]) for i in range(4))
    kw = dict(min_count_frac=0.02, max_exc_frac=1.0)
    t = tr.build_rolled_matvec_multi(nbr, mult, scaling, **kw)
    assert t is not None and t["exc_r"].shape[1] > 0
    _same_tables(t, jr.build_rolled_matvec_multi(nbr, mult, scaling, **kw))
    y = tr.make_rolled_apply_multi(t, torch.float64, "cpu")(torch.from_numpy(x)).numpy()
    for d in range(3):
        ref = _brute(nbr[d], mult[d], scaling[d], x[d])
        assert np.abs(y[d] - ref).max() < 1e-13 * max(1.0, np.abs(ref).max())


def test_build_refusals_and_degenerate():
    """tests/test_poisson_rolled.py::test_build_refusals_and_degenerate in
    both packages: scattered indices under a tight exception budget refuse;
    a pure-diagonal system has no terms and no exceptions; an empty
    operator and a refusing slot refuse the multi-slot build."""
    rng = np.random.default_rng(7)
    R, K = 256, 6
    scaling = rng.standard_normal(R)
    nbr = rng.integers(0, R, (R, K))
    for mod in (tr, jr):
        assert mod.build_rolled_matvec(nbr, np.ones((R, K)), scaling,
                                       max_exc_frac=0.01) is None
        assert mod.build_rolled_matvec(np.zeros((0, K), int), np.zeros((0, K)),
                                       np.zeros(0)) is None
        assert mod.build_rolled_matvec_multi(
            np.stack([nbr, nbr]), np.stack([np.zeros((R, K)), np.ones((R, K))]),
            np.stack([scaling, scaling]), max_exc_frac=0.01) is None
    t = tr.build_rolled_matvec(nbr, np.zeros((R, K)), scaling)
    _same_tables(t, jr.build_rolled_matvec(nbr, np.zeros((R, K)), scaling))
    assert t["offsets"] == [] and t["exc_r"].size == 0
    x = rng.standard_normal(R)
    y = tr.make_rolled_apply(t, torch.float64, "cpu")(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(y, scaling * x)
