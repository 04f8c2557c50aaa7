"""The port's device screen (``threshold_cc`` and label propagation)
against the reference package.

The plain hook step (``repro_torch.kernels.threshold_cc.ref``) is held
against the reference's float64 oracle ``labelprop_step_ref`` exactly (an
int32 min over the same strict float64 predicate), and against the
reference's interpret-mode Pallas step on data exactly representable in
float32 (that path casts S and lam to float32).  Through the port's
registry the ``"jax"``, ``"pallas"`` and ``"shard_map"`` (one CPU shard;
several in tests/test_torch_distributed.py) backends must give the host
union-find's canonical labels exactly, exact ties |S_ij| == lam and near
ties included.  The CUDA kernel is held against the plain step on the card
in tests/test_torch_cuda_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import lambda_between_edges, random_covariance
from repro.core.components import connected_components_labelprop as jax_labelprop
from repro.engine.registry import available_cc_backends as jax_available_cc_backends
from repro.engine.registry import label_components as jax_label_components
from repro.kernels.threshold_cc.ops import labelprop_step as jax_pallas_step
from repro.kernels.threshold_cc.ref import labelprop_step_ref as jax_step_ref
from repro_torch.core import instrument
from repro_torch.core.components import connected_components_labelprop
from repro_torch.core.screening import thresholded_components
from repro_torch.engine.registry import available_cc_backends, label_components
from repro_torch.kernels.threshold_cc import (
    connected_components_kernel,
    labelprop_step,
    labelprop_step_ref,
)

BACKENDS = ("jax", "pallas", "shard_map")


def _sym(rng, p, scale=1.0):
    A = rng.uniform(-scale, scale, size=(p, p))
    return 0.5 * (A + A.T)


@pytest.mark.parametrize("p", [1, 5, 33, 90])
@pytest.mark.parametrize("ties", [False, True])
def test_plain_step_equals_reference_oracle(p, ties):
    rng = np.random.default_rng(p)
    S = _sym(rng, p)
    lam = 0.7
    if ties and p > 3:
        S[0, 2] = S[2, 0] = lam
        S[1, 3] = S[3, 1] = -lam
    labels = rng.permutation(p).astype(np.int32)
    want = np.asarray(jax_step_ref(jnp.asarray(S), jnp.asarray(labels), lam))
    got = labelprop_step_ref(torch.as_tensor(S), torch.as_tensor(labels), lam).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)
    # the wrapper takes the plain version on the CPU and launches nothing
    instrument.reset("kernels.")
    got2 = labelprop_step(torch.as_tensor(S), torch.as_tensor(labels), lam).numpy()
    assert np.array_equal(got2, want)
    assert instrument.count("kernels.threshold_cc.launches") == 0


@pytest.mark.parametrize("p", [6, 40, 300])
def test_plain_step_equals_reference_pallas_on_float32_exact_data(p):
    """Entries and lam are multiples of 1/8 in [-2, 2]: exactly
    representable in float32, so the reference's float32 cast changes
    nothing and its interpret-mode kernel must agree."""
    rng = np.random.default_rng(p)
    S = rng.integers(-16, 17, size=(p, p)) / 8.0
    S = np.triu(S) + np.triu(S, 1).T
    lam = 1.0  # the value 8/8 occurs: exact ties
    labels = rng.permutation(p).astype(np.int32)
    want = np.asarray(jax_pallas_step(jnp.asarray(S), jnp.asarray(labels), lam, block=128))
    got = labelprop_step_ref(torch.as_tensor(S), torch.as_tensor(labels), lam).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed,p,q", [(0, 12, 0.5), (1, 40, 0.8), (2, 60, 0.95)])
def test_labelprop_matches_reference_label_propagation(seed, p, q):
    rng = np.random.default_rng(seed)
    S = random_covariance(rng, p)
    lam = lambda_between_edges(S, q)
    want = np.asarray(jax_labelprop(jnp.asarray(S), lam))
    got = connected_components_labelprop(torch.as_tensor(S), lam).numpy()
    assert np.array_equal(got, want)


def test_backends_registered_under_reference_names():
    assert set(available_cc_backends()) == set(jax_available_cc_backends())


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed,p,q", [(3, 10, 0.3), (4, 30, 0.7), (5, 64, 0.9), (6, 80, 0.97)])
def test_device_backends_equal_host(backend, seed, p, q):
    rng = np.random.default_rng(seed)
    S = random_covariance(rng, p)
    lam = lambda_between_edges(S, q)
    want, want_stats = thresholded_components(S, lam)
    got, got_stats = thresholded_components(S, lam, backend=backend, device="cpu")
    assert np.array_equal(got, want)
    assert got_stats.n_edges == want_stats.n_edges
    # and the reference's host union-find agrees on the same S
    assert np.array_equal(got, jax_label_components(S, lam, backend="host"))


@pytest.mark.parametrize("backend", BACKENDS)
def test_exact_tie_is_not_an_edge(backend):
    """lam equal to an existing |S_ij| (chosen from the values themselves):
    the strict threshold drops exactly those entries."""
    rng = np.random.default_rng(7)
    S = random_covariance(rng, 24)
    vals = np.abs(S[np.triu_indices(24, 1)])
    lam = float(np.sort(vals[vals > 0])[int(0.8 * vals.size)])
    assert (vals == lam).any()
    want = label_components(S, lam, backend="host")
    got = label_components(S, lam, backend=backend, device="cpu")
    assert np.array_equal(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_near_tie_matches_host_union_find(backend):
    """|S_01| exceeds lam by 1e-12, far below float32 resolution.  The port
    thresholds in float64 and keeps the edge, as the host union-find does.
    Not compared with the reference's "pallas" backend: its wrapper casts
    S and lam to float32 (src/repro/kernels/threshold_cc/ops.py:27-29) and
    drops this edge."""
    S = np.eye(4)
    S[0, 1] = S[1, 0] = 0.5 + 1e-12
    want = label_components(S, 0.5, backend="host")
    assert want.tolist() == [0, 0, 2, 3]
    assert np.array_equal(label_components(S, 0.5, backend=backend, device="cpu"), want)
    assert np.array_equal(jax_label_components(S, 0.5, backend="host"), want)


def test_fixed_point_loop_counts_rounds_and_caps_like_the_reference():
    """A path 0-1-...-(p-1) needs several rounds; the fixed-point loop
    counts them in screen.labelprop_rounds."""
    p = 64
    S = np.eye(p)
    for i in range(p - 1):
        S[i, i + 1] = S[i + 1, i] = 0.9
    instrument.reset("screen.")
    labels = connected_components_kernel(torch.as_tensor(S), 0.5).numpy()
    assert (labels == 0).all()
    rounds = instrument.count("screen.labelprop_rounds")
    assert 2 <= rounds <= p + 3


def test_device_backend_default_is_cuda(monkeypatch):
    """Called without device=, the device backends ask for the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        label_components(np.eye(3), 0.1, backend="pallas")


@pytest.mark.parametrize("p", [3, 50, 130])
def test_count_edges_on_a_tensor_equals_the_host_count(p):
    """The device backends count the stats' edges on their own copy of S;
    the count is the host's strict upper-triangle count, ties excluded."""
    from repro_torch.core.screening import count_edges

    rng = np.random.default_rng(p)
    S = rng.uniform(-1.0, 1.0, size=(p, p))  # not symmetric: upper only
    lam = 0.5
    S[0, 1] = lam
    want = count_edges(S, lam, row_chunk=16)
    assert count_edges(torch.as_tensor(S), lam, row_chunk=16) == want
    assert want == int((np.abs(S[np.triu_indices(p, 1)]) > lam).sum())
