"""The port's ``DataSession`` (``repro_torch.stream.session``) against the
reference package's ``repro.stream.DataSession`` on the CPU: the same data
and appended rows (made with numpy from explicit seeds) go through both.

Held equal: the labels after every append, each update's
``tiles_rescreened``, ``tiles_revalidated`` and ``components_touched``, the
``stream.*`` counters, and the screen stats' edge and component counts.
Held to a fresh screen: after each append the session's labels equal a
``stream_screen`` of the stacked data, and its materialized blocks equal
the fresh screen's (both compute them from the same X in float64 with the
same arithmetic: bit for bit).  Lambdas are taken at values of |S_ij|
(``vals[vals > 0]``) or midway between two of them; no case draws from a
clock or from hypothesis."""

import numpy as np
import pytest
import torch

from repro.core.instrument import counts as ref_counts, reset as ref_reset
from repro.stream import DataSession as RefSession
from repro_torch.core.instrument import counts, reset
from repro_torch.stream import DataSession, SessionUpdate, stream_screen

CFG = {"tile": 16, "chunk": 16}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _abs_offdiag(X):
    Xc = X - X.mean(axis=0)
    S = Xc.T @ Xc / X.shape[0]
    vals = np.unique(np.abs(S[np.triu_indices(S.shape[0], 1)]))
    return vals[vals > 0]


def _scaled_data(seed, n=40, p=64, strong=24):
    """p columns, the first ``strong`` at unit scale and the rest small, so
    most tile pairs far from the strong block are skipped or certified."""
    rng = np.random.default_rng(seed)
    scales = np.where(np.arange(p) < strong, 1.0, 0.05)
    return rng, scales, rng.standard_normal((n, p)) * scales


def _both_sessions(X, lam):
    ref_reset("stream")
    reset("stream")
    return RefSession(X, lam, config=CFG), DataSession(X, lam, config=CFG, device="cpu")


def _assert_same_update(ua, ub):
    assert isinstance(ub, SessionUpdate)
    np.testing.assert_array_equal(ua.labels, ub.labels)
    assert ua.tiles_rescreened == ub.tiles_rescreened
    assert ua.tiles_revalidated == ub.tiles_revalidated
    assert ua.components_touched == ub.components_touched
    for f in ("n_components", "max_comp", "n_isolated", "n_edges", "tiles_total",
              "tiles_skipped", "edges_emitted"):
        assert getattr(ua.stats, f) == getattr(ub.stats, f), f


def _assert_matches_fresh_screen(ses, X2):
    """The session against a fresh screen of the stacked data; the stream
    counters of both packages are compared first and reset after, so the
    fresh screen's own counts never enter a comparison."""
    assert ref_counts("stream.") == counts("stream.")
    fresh = stream_screen(X2, [ses.lam], config=CFG, device="cpu")
    ref_reset("stream")
    reset("stream")
    np.testing.assert_array_equal(ses.labels, fresh.labels[0])
    for c in np.unique(ses.labels):
        comp = np.flatnonzero(ses.labels == c)
        if comp.size > 1:
            np.testing.assert_array_equal(ses.S.gather_block(comp), fresh.S.gather_block(comp))


@pytest.mark.parametrize("seed,q", [(0, 0.8), (1, 0.9), (2, 0.7)])
def test_append_rows_matches_reference_and_fresh_screen(seed, q):
    rng, scales, X = _scaled_data(seed)
    vals = _abs_offdiag(X)
    k = int(q * (vals.size - 1))
    lam = float(0.5 * (vals[k] + vals[k + 1]))
    a, b = _both_sessions(X, lam)
    np.testing.assert_array_equal(a.labels, b.labels)
    X2 = X
    for step in range(3):
        Y = (0.02 if step == 0 else 0.3) * rng.standard_normal((3, X.shape[1])) * scales
        _assert_same_update(a.append_rows(Y), b.append_rows(Y))
        X2 = np.vstack([X2, Y])
        assert counts("stream.")["stream.tiles_revalidated"] > 0
        if step:
            assert counts("stream.")["stream.tiles_rescreened"] > 0
        _assert_matches_fresh_screen(b, X2)


def test_small_append_revalidates_most_tiles():
    """A tiny append (one row at the column means) at a lambda in a wide
    gap of the |S_ij|: the perturbation bound still breaks the certificates
    of the tiles holding entries within ~G_ii (1/n - 1/n') of lambda, and
    only those; most tiles re-validate, the same ones in both packages."""
    rng, scales, X = _scaled_data(5, n=400)
    vals = _abs_offdiag(X)
    lo, hi = int(0.5 * vals.size), int(0.95 * vals.size)
    k = lo + int(np.argmax(np.diff(vals[lo:hi])))
    lam = float(0.5 * (vals[k] + vals[k + 1]))
    a, b = _both_sessions(X, lam)
    Y = X.mean(axis=0) + 1e-6 * rng.standard_normal((1, X.shape[1])) * scales
    ua, ub = a.append_rows(Y), b.append_rows(Y)
    _assert_same_update(ua, ub)
    assert ub.tiles_revalidated > ub.tiles_rescreened
    assert ub.tiles_revalidated + ub.tiles_rescreened == len(b.tiles)
    _assert_matches_fresh_screen(b, np.vstack([X, Y]))


def test_append_merges_components():
    """Two column groups independent in X, then rows that correlate them:
    the append's re-screen finds the cross edges and the two components
    merge, as in the reference."""
    rng = np.random.default_rng(11)
    n, p = 30, 40
    X = np.zeros((n, p))
    X[:, :20] = rng.standard_normal((n, 1)) + 0.3 * rng.standard_normal((n, 20))
    X[:, 20:] = rng.standard_normal((n, 1)) + 0.3 * rng.standard_normal((n, 20))
    vals = _abs_offdiag(X)
    lam = float(vals[int(0.75 * vals.size)])  # an existing |S_ij|: a tie
    a, b = _both_sessions(X, lam)
    before = np.unique(b.labels).size
    z = 4.0 * rng.standard_normal((12, 1))
    Y = z + 0.3 * rng.standard_normal((12, p))  # one factor drives all columns
    ua, ub = a.append_rows(Y), b.append_rows(Y)
    _assert_same_update(ua, ub)
    assert np.unique(ub.labels).size < before
    assert ub.components_touched >= 2
    _assert_matches_fresh_screen(b, np.vstack([X, Y]))


def test_append_splits_components():
    """Rows equal to the column means leave the means alone and shrink every
    S_ij by n / (n + k): edges just above lambda fall below it, a component
    splits (an edge disappears), and the session's labels follow the fresh
    screen's, as in the reference."""
    rng = np.random.default_rng(21)
    n, p = 24, 32
    X = rng.standard_normal((n, 1)) + 0.6 * rng.standard_normal((n, p))
    vals = _abs_offdiag(X)
    k = int(0.9 * vals.size)
    lam = float(0.5 * (vals[k] + vals[k + 1]))
    a, b = _both_sessions(X, lam)
    before = np.unique(b.labels).size
    Y = np.tile(X.mean(axis=0), (6, 1))
    ua, ub = a.append_rows(Y), b.append_rows(Y)
    _assert_same_update(ua, ub)
    assert np.unique(ub.labels).size > before
    assert ub.components_touched >= 1
    _assert_matches_fresh_screen(b, np.vstack([X, Y]))


def test_append_rejects_wrong_width():
    _, _, X = _scaled_data(3, p=20, strong=8)
    ses = DataSession(X, 0.3, config=CFG, device="cpu")
    with pytest.raises(ValueError, match="p=19"):
        ses.append_rows(np.zeros((2, 19)))


def test_session_on_the_card_is_the_default():
    """Like ``stream_screen``, a session computes on ``"cuda"`` unless told
    otherwise: without CUDA it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    _, _, X = _scaled_data(4, p=20, strong=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DataSession(X, 0.3, config=CFG)
