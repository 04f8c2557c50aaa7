"""The port's covgram_screen module against the reference package.

The plain PyTorch version (``repro_torch.kernels.covgram_screen.ref``) is
held against the reference's numpy oracle ``covgram_screen_ref``, which
computes in the input dtype as the port does (the reference's Pallas path
casts to float32 and is not ground truth at ties — ROADMAP queue 3).  On
integer X with a power-of-two n every covariance entry is a dyadic rational
that both compute exactly, so vals, counts and stats are equal bit for bit,
exact ties included; on Gaussian X the two sum in another order and agree to
1e-12 of the largest |S_ij|.  The CUDA kernel is held against the plain
version on the card in tests/test_torch_cuda_kernels.py."""

import numpy as np
import pytest
import torch

from repro.kernels.covgram_screen.ops import (
    compact_edges as jax_compact_edges,
    compact_edges_signed as jax_compact_edges_signed,
    pad_for_screen as jax_pad_for_screen,
)
from repro.kernels.covgram_screen.ref import covgram_screen_ref as np_screen_ref
from repro_torch.core import instrument
from repro_torch.kernels.covgram_screen import (
    compact_edges,
    compact_edges_signed,
    covgram_screen_ref,
    covgram_screen_tiles,
    covgram_screen_tiles_stacked,
    pad_for_screen,
)

RTOL = 1e-12


def _inputs(X, tile, chunk):
    n, p = X.shape
    mu = X.mean(axis=0)
    x_np, mu_np = jax_pad_for_screen(X, mu, block_n=chunk, block_p=tile)
    x_t, mu_t = pad_for_screen(torch.as_tensor(X), mu, block_n=chunk, block_p=tile)
    nt = x_np.shape[1] // tile
    ti, tj = np.triu_indices(nt)
    return x_np, mu_np, x_t, mu_t, ti.astype(np.int32), tj.astype(np.int32)


@pytest.mark.parametrize("n,p,tile,chunk", [(7, 10, 4, 4), (20, 45, 16, 8), (33, 64, 32, 16)])
def test_pad_for_screen_matches_reference(n, p, tile, chunk):
    rng = np.random.default_rng(n)
    X = rng.standard_normal((n, p))
    x_np, mu_np, x_t, mu_t, _, _ = _inputs(X, tile, chunk)
    assert np.array_equal(x_t.numpy(), x_np) and np.array_equal(mu_t.numpy(), mu_np)
    assert x_t.shape[0] % chunk == 0 and x_t.shape[1] % tile == 0


@pytest.mark.parametrize("seed,p,tile", [(0, 21, 16), (1, 50, 32), (2, 64, 32), (3, 40, 16)])
def test_plain_equals_reference_bitwise_on_integer_data(seed, p, tile):
    rng = np.random.default_rng(seed)
    n = 16
    X = rng.integers(-4, 5, size=(n, p)).astype(np.float64)
    x_np, mu_np, x_t, mu_t, ti, tj = _inputs(X, tile, 8)
    Xc = X - X.mean(axis=0)
    vals = np.abs(Xc.T @ Xc / n)[np.triu_indices(p, 1)]
    lam = float(np.sort(vals[vals > 0])[vals[vals > 0].size // 2])  # an existing |S_ij|
    want = np_screen_ref(x_np, mu_np, ti, tj, lam, n_true=n, p_true=p, block_p=tile)
    got = covgram_screen_ref(x_t, mu_t, ti, tj, lam, n_true=n, p_true=p, block_p=tile)
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), want[1][:, 0])
    assert np.array_equal(got[2].numpy(), want[2])
    # a tie entry is not an edge: it never appears in vals
    assert not (np.abs(got[0].numpy()) == lam).any()


@pytest.mark.parametrize("seed,n,p,tile", [(4, 24, 30, 16), (5, 40, 70, 32)])
def test_plain_matches_reference_on_gaussian_data(seed, n, p, tile):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p)) * (0.1 + rng.random(p))
    x_np, mu_np, x_t, mu_t, ti, tj = _inputs(X, tile, 8)
    Xc = X - X.mean(axis=0)
    vals = np.unique(np.abs(Xc.T @ Xc / n)[np.triu_indices(p, 1)])
    k = vals.size // 2
    lam = float(0.5 * (vals[k] + vals[k + 1]))  # midway: no entry near lam
    want = np_screen_ref(x_np, mu_np, ti, tj, lam, n_true=n, p_true=p, block_p=tile)
    got = covgram_screen_ref(x_t, mu_t, ti, tj, lam, n_true=n, p_true=p, block_p=tile)
    scale = float(want[2][:, 0].max())
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=RTOL * scale)
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=0, atol=RTOL * scale)
    assert np.array_equal(got[1].numpy(), want[1][:, 0])


def test_wrapper_runs_plain_version_on_cpu():
    rng = np.random.default_rng(8)
    X = rng.standard_normal((12, 20))
    _, _, x_t, mu_t, ti, tj = _inputs(X, 8, 4)
    instrument.reset("kernels.")
    got = covgram_screen_tiles(x_t, mu_t, ti, tj, 0.2, n_true=12, p_true=20, block_p=8)
    want = covgram_screen_ref(x_t, mu_t, ti, tj, 0.2, n_true=12, p_true=20, block_p=8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert instrument.count("kernels.covgram_screen.launches") == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_edges_match_reference(seed):
    rng = np.random.default_rng(seed)
    n, p, tile = 16, 37, 16
    X = rng.standard_normal((n, p))
    x_np, mu_np, x_t, mu_t, ti, tj = _inputs(X, tile, 8)
    vals, _, _ = np_screen_ref(x_np, mu_np, ti, tj, 0.3, n_true=n, p_true=p, block_p=tile)
    for port_fn, ref_fn in ((compact_edges, jax_compact_edges),
                            (compact_edges_signed, jax_compact_edges_signed)):
        got = port_fn(torch.as_tensor(vals), ti, tj, block_p=tile)
        want = ref_fn(vals, ti, tj, block_p=tile)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    gi, gj, _ = compact_edges(torch.as_tensor(vals), ti, tj, block_p=tile)
    assert (gi < gj).all() and (gj < p).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_edges_take_index_tensors(seed):
    """The screening paths pass each batch's tile indices as int32 tensors
    (their schedule uploaded once); compaction reads them as it reads the
    numpy form."""
    rng = np.random.default_rng(seed)
    n, p, tile = 16, 37, 16
    X = rng.standard_normal((n, p))
    x_np, mu_np, x_t, mu_t, ti, tj = _inputs(X, tile, 8)
    vals, _, _ = np_screen_ref(x_np, mu_np, ti, tj, 0.3, n_true=n, p_true=p, block_p=tile)
    got = compact_edges_signed(torch.as_tensor(vals), torch.from_numpy(ti),
                               torch.from_numpy(tj), block_p=tile)
    want = jax_compact_edges_signed(vals, ti, tj, block_p=tile)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _recording(calls):
    def tile_fn(x, mu, i_idx, j_idx, *args, **kw):
        calls.append((i_idx, j_idx))
        return covgram_screen_tiles(x, mu, i_idx, j_idx, *args, **kw)

    return tile_fn


def _uploaded_once(calls):
    """Every call's indices are int32 tensors, slices of one allocation a
    side: the schedule went to the device once, not once a call."""
    assert len(calls) > 1
    for side in (0, 1):
        idx = [c[side] for c in calls]
        assert all(isinstance(t, torch.Tensor) and t.dtype == torch.int32 for t in idx)
        assert len({t.untyped_storage().data_ptr() for t in idx}) == 1


def test_stream_screen_uploads_the_schedule_once(monkeypatch):
    from repro.stream import stream_screen as jax_stream_screen
    from repro_torch.stream import screen as stream_mod

    rng = np.random.default_rng(5)
    X = rng.standard_normal((40, 90))
    cfg = {"tile": 16, "chunk": 16, "pair_batch": 3}
    calls = []
    monkeypatch.setattr(stream_mod, "covgram_screen_tiles", _recording(calls))
    got = stream_mod.stream_screen(X, [0.3], config=cfg, device="cpu", materialize=False)
    _uploaded_once(calls)
    want = jax_stream_screen(X, [0.3], config=cfg, materialize=False)
    assert np.array_equal(got.labels[0], np.asarray(want.labels[0]))
    for g, w in zip(got.edges, want.edges):
        assert np.array_equal(g, np.asarray(w))


def test_stacked_screen_uploads_each_schedule_once():
    rng = np.random.default_rng(6)
    tile, lam = 16, 0.25
    xs_pad, mus_pad, sched_i, sched_j, n_trues = [], [], [], [], []
    for n in (24, 31):
        X = rng.standard_normal((n, 50))
        x_np, mu_np, x_t, mu_t, ti, tj = _inputs(X, tile, 8)
        xs_pad.append(x_t)
        mus_pad.append(mu_t)
        sched_i.append(ti)
        sched_j.append(tj)
        n_trues.append(n)
    calls = []
    got = covgram_screen_tiles_stacked(
        xs_pad, mus_pad, sched_i, sched_j, lam, n_trues=n_trues, p_true=50, block_p=tile,
        pair_batch=4, tile_fn=_recording(calls),
    )
    per_class = [calls[:3], calls[3:]]  # 10 pairs a class, 4 a flight
    assert len(calls) == 6
    for k, cls in enumerate(per_class):
        _uploaded_once(cls)
        x_np, mu_np = xs_pad[k].numpy(), mus_pad[k].numpy()
        vals, _, _ = np_screen_ref(x_np, mu_np, sched_i[k], sched_j[k], lam,
                                   n_true=n_trues[k], p_true=50, block_p=tile)
        want = jax_compact_edges_signed(vals, sched_i[k], sched_j[k], block_p=tile)
        for g, w in zip(got[k], want):
            assert g.dtype == w.dtype
            np.testing.assert_allclose(g, w, rtol=0, atol=RTOL * np.abs(vals).max())


def _mma_order_screen(x, mu, ti, tj, lam, *, n_true, p_true, block_p, k_step):
    """The card kernel's arithmetic in plain torch: centered operands, the
    products of each k-step of its mma shape summed on their own and added
    to the fragment's running sum (rows past N, staged as mu, add zero),
    the division by n after the sum, then the strict threshold, counts and
    tile maxima."""
    N, P = x.shape
    nt = P // block_p
    ti = torch.as_tensor(ti, dtype=torch.int64)
    tj = torch.as_tensor(tj, dtype=torch.int64)
    xt, mt = x.reshape(N, nt, block_p), mu.reshape(nt, block_p)
    a = (xt[:, ti, :] - mt[ti]).permute(1, 2, 0)   # (B, bp, N)
    b = (xt[:, tj, :] - mt[tj]).permute(1, 0, 2)   # (B, N, bp)
    acc = torch.zeros((len(ti), block_p, block_p), dtype=x.dtype)
    for k0 in range(0, N, k_step):
        acc = acc + a[:, :, k0 : k0 + k_step] @ b[:, k0 : k0 + k_step]
    S = acc / n_true
    iota = torch.arange(block_p)
    rows = ti[:, None, None] * block_p + iota[None, :, None]
    cols = tj[:, None, None] * block_p + iota[None, None, :]
    valid = (rows < p_true) & (cols < p_true) & (rows != cols)
    edge = valid & (S.abs() > lam)
    zero = torch.zeros((), dtype=S.dtype)
    stats = torch.stack([torch.where(valid, S.abs(), zero).amax(dim=(1, 2)),
                         torch.where(valid & ~edge, S.abs(), zero).amax(dim=(1, 2))], dim=1)
    return torch.where(edge, S, zero), edge.sum(dim=(1, 2)).to(torch.int32), stats


# the kernel's mma shape, m16n8k8, takes k-steps of 8 rows; chunk 67 pads
# n = 64 and n = 60 to N = 67 (with rows of mu), not a multiple of 8, and
# chunk 16 pads n = 60 to 64 (n = 64 needs no padding rows)
@pytest.mark.parametrize("chunk", [67, 16])
@pytest.mark.parametrize("integer", [True, False])
def test_mma_accumulation_order_matches_reference(chunk, integer):
    k_step = 8
    rng = np.random.default_rng(chunk + 10 * integer)
    n, p, tile = (64, 50, 16) if integer else (60, 70, 32)
    if integer:
        X = rng.integers(-4, 5, size=(n, p)).astype(np.float64)
    else:
        X = rng.standard_normal((n, p)) * (0.1 + rng.random(p))
    x_np, mu_np, x_t, mu_t, ti, tj = _inputs(X, tile, chunk)
    assert (x_np.shape[0] % k_step != 0) == (chunk == 67)
    Xc = X - X.mean(axis=0)
    vals = np.unique(np.abs(Xc.T @ Xc / n)[np.triu_indices(p, 1)])
    k = vals.size // 2
    # integer data: lam an existing |S_ij| (an exact tie, not an edge);
    # Gaussian data: lam midway between two values, far from any entry
    lam = float(vals[k]) if integer else float(0.5 * (vals[k] + vals[k + 1]))
    want = np_screen_ref(x_np, mu_np, ti, tj, lam, n_true=n, p_true=p, block_p=tile)
    got = _mma_order_screen(x_t, mu_t, ti, tj, lam, n_true=n, p_true=p, block_p=tile,
                            k_step=k_step)
    assert np.array_equal(got[1].numpy(), want[1][:, 0])
    if integer:
        assert np.array_equal(got[0].numpy(), want[0])
        assert np.array_equal(got[2].numpy(), want[2])
    else:
        scale = float(want[2][:, 0].max())
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=RTOL * scale)
        np.testing.assert_allclose(got[2].numpy(), want[2], rtol=0, atol=RTOL * scale)
