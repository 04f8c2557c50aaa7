"""The port's multi-device pillar (``repro_torch.core.distributed``, the
``"shard_map"`` screen, ``Engine(devices=...)``) against the reference
package, with every shard a CPU device of one process.

* At d = 1, in this process: ``distributed_components`` and
  ``distributed_bucket_solve`` on the inputs of tests/test_distributed_core.py
  against the reference's on its one-device mesh, and the labels of a
  chain with the rounds capped (``max_rounds``), at d = 4 too.
* At d in {2, 3, 4, 8} CPU shards: the collectives against dense
  arithmetic, the labels against the host union-find and d = 1 (exact ties
  at lam included), the bucket solve bit for bit against d = 1 with n not
  a multiple of d, and ``Engine(devices=["cpu"] * 4)`` bit for bit against
  one device, its labels, route mix and ``router.*`` counters equal to the
  reference's.
* At d = 4 against the reference at d = 4: ONE module-scoped subprocess
  runs the reference on four emulated host devices
  (``--xla_force_host_platform_device_count=4``, ``JAX_PLATFORMS=cpu``;
  this process keeps its one device), writes its results to an ``.npz``,
  and the port at d = 4 is held to them: CC labels equal, the bucket
  solve within 1e-9, ``glasso_sharded`` at b = 100 (bp = 128) with its
  outer iterations, retries, padded size and shard count equal and Theta
  within 1e-8 (the sums of the ring matmuls and reductions add in the
  reference's shard order; other orders inside each product), and the
  engine's oversize route with its route mix and ``solver.oversize.*``
  counters equal and Theta within 1e-7.

The row-slab hook step's plain version is held to the square step's for
every slab that starts past row 0.  No test here changes process state:
torch's thread count is restored after each test, and the subprocess gets
its environment as an argument."""

import json
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from conftest import lambda_between_edges, random_covariance
from repro.core.components import components_from_covariance_host
from repro.core.distributed import distributed_bucket_solve as ref_bucket_solve
from repro.core.distributed import distributed_components as ref_components
from repro.core.glasso import glasso as jax_glasso
from repro.core.instrument import counts as jax_counts, reset as jax_reset
from repro.core.jax_compat import make_mesh
from repro.core.solvers import glasso_bcd as ref_bcd
from repro.covariance import paper_synthetic, structured_synthetic
from repro.engine import EngineOptions as JaxOptions
from repro_torch import EngineOptions
from repro_torch.core import instrument
from repro_torch.core.distributed import (
    DeviceMesh,
    all_gather,
    all_to_all,
    as_mesh,
    distributed_bucket_solve,
    distributed_components,
    local_device_mesh,
    matvec_rowsharded,
    pmax,
    psum,
    put_sharded_blocks,
    ring_matmul,
    ring_shift,
    split_rows,
    transpose_rowsharded,
)
from repro_torch.core.screening import thresholded_components
from repro_torch.core.solvers import glasso_sharded
from repro_torch.kernels.threshold_cc import (
    labelprop_rows,
    labelprop_rows_ref,
    labelprop_step_ref,
)

SRC = str(Path(__file__).resolve().parents[1] / "src")
DS = (2, 3, 4, 8)
THETA_ATOL = 1e-8        # tests/test_torch_sharded.py's
BUCKET_ATOL = 1e-9
ENGINE_ATOL = 1e-7
REFERENCE_TIMEOUT = 240  # seconds; the subprocess takes ~12 s here


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The shards' CPU loops are many tiny products; each test runs on one
    thread and restores the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu(d: int) -> list:
    return ["cpu"] * d


def _mesh1():
    return make_mesh((1,), ("data",))


# ------------------------------------------------------------------ mesh


def test_mesh_is_an_ordered_list_of_devices():
    mesh = DeviceMesh(_cpu(3))
    assert mesh.size == len(mesh) == 3
    assert list(mesh) == [torch.device("cpu")] * 3 and mesh[2] == torch.device("cpu")
    assert as_mesh(mesh) is mesh and as_mesh(_cpu(3)) == mesh and hash(as_mesh(_cpu(3)))
    assert local_device_mesh("cpu") == DeviceMesh(["cpu"])
    with pytest.raises(ValueError, match="at least one device"):
        DeviceMesh([])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        DeviceMesh(["meta"])


# ----------------------------------------------------------- collectives


@pytest.mark.parametrize("d", (1,) + DS)
def test_row_sharded_primitives_equal_dense(d):
    rng = np.random.default_rng(d)
    bp = 48
    A = torch.as_tensor(rng.standard_normal((bp, bp)))
    B = torch.as_tensor(rng.standard_normal((bp, bp)))
    v = torch.as_tensor(rng.standard_normal(bp))
    a, b = split_rows(A, _cpu(d)), split_rows(B, _cpu(d))
    assert [x.shape for x in a] == [(bp // d, bp)] * d
    C = ring_matmul(a, b)
    rl = bp // d
    for i in range(d):
        # the reference's order: step k adds shard (i + k) mod d's product
        want = None
        for k in range(d):
            s = (i + k) % d
            prod = A[i * rl:(i + 1) * rl, s * rl:(s + 1) * rl] @ B[s * rl:(s + 1) * rl]
            want = prod if want is None else want + prod
        assert torch.equal(C[i], want)
    np.testing.assert_allclose(torch.cat(C).numpy(), (A @ B).numpy(), rtol=0, atol=1e-12)
    assert torch.equal(torch.cat(transpose_rowsharded(a)), A.T)
    np.testing.assert_allclose(matvec_rowsharded(a, v).numpy(), (A @ v).numpy(), atol=1e-12)
    parts = [torch.tensor(float(k + 1)) for k in range(d)]
    assert float(psum(parts)) == d * (d + 1) / 2 and float(pmax(parts)) == d


@pytest.mark.parametrize("d", DS)
def test_collectives_move_copies_in_shard_order(d):
    pieces = [torch.full((2,), float(k)) for k in range(d)]
    gathered = all_gather(pieces)
    assert gathered.tolist() == [float(k) for k in range(d) for _ in range(2)]
    shifted = ring_shift(pieces)
    assert [float(x[0]) for x in shifted] == [float((k + 1) % d) for k in range(d)]
    # a shard sent to another shard is a copy, also on one device
    assert all(x.data_ptr() != pieces[(k + 1) % d].data_ptr() for k, x in enumerate(shifted))
    blocks = [[torch.tensor([10.0 * i + j]) for j in range(d)] for i in range(d)]
    received = all_to_all(blocks)
    assert [[float(x) for x in col] for col in received] == [
        [10.0 * i + j for i in range(d)] for j in range(d)]
    stack = torch.zeros((2 * d, 3, 3))
    assert [s.shape[0] for s in put_sharded_blocks(stack, _cpu(d))] == [2] * d
    with pytest.raises(ValueError, match="do not split"):
        put_sharded_blocks(torch.zeros((2 * d + 1, 3, 3)), _cpu(d))


# --------------------------------------------------------- row-slab step


@pytest.mark.parametrize("p", [7, 33])
def test_plain_row_slab_step_equals_square_step(p):
    """Every slab [row0, row0 + rows) with row0 > 0, exact ties at lam
    included: the slab's labels are the square step's rows."""
    rng = np.random.default_rng(p)
    A = rng.uniform(-1.0, 1.0, size=(p, p))
    S = 0.5 * (A + A.T)
    lam = 0.6
    S[1, 4] = S[4, 1] = lam
    S[p - 1, 0] = S[0, p - 1] = -lam
    St = torch.as_tensor(S)
    labels = torch.as_tensor(rng.permutation(p), dtype=torch.int32)
    square = labelprop_step_ref(St, labels, lam)
    instrument.reset("kernels.")
    for row0 in range(1, p):
        for rows in range(1, p - row0 + 1):
            slab = St[row0 : row0 + rows]
            want = square[row0 : row0 + rows]
            assert torch.equal(labelprop_rows_ref(slab, labels, lam, row0), want)
            assert torch.equal(labelprop_rows(slab, labels, lam, row0), want)
    assert instrument.count("kernels.threshold_cc.launches") == 0


# ------------------------------------------------ d = 1 vs the reference


@pytest.mark.parametrize("seed,p,q", [(0, 24, 0.6), (1, 7, 0.4)])
def test_components_at_one_shard_match_reference(seed, p, q):
    rng = np.random.default_rng(seed)
    S = random_covariance(rng, p)
    lam = lambda_between_edges(S, q)
    want = np.asarray(ref_components(jnp.asarray(S), lam, _mesh1()))
    got = distributed_components(torch.as_tensor(S), lam, _cpu(1))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), components_from_covariance_host(S, lam))


def test_bucket_solve_at_one_shard_matches_reference():
    rng = np.random.default_rng(2)
    blocks = np.stack([random_covariance(rng, 4) for _ in range(3)])
    lam = 0.25
    want = np.asarray(ref_bucket_solve(blocks, lam, ref_bcd, _mesh1(), tol=1e-9))
    got = distributed_bucket_solve(blocks, lam, "bcd", _cpu(1), tol=1e-9)
    assert got.shape == (3, 4, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BUCKET_ATOL)


def _chain(p: int, seed: int) -> np.ndarray:
    """A path graph over a random order of p vertices: min labels need
    several rounds to travel along it."""
    order = np.random.default_rng(seed).permutation(p)
    S = np.eye(p)
    S[order[:-1], order[1:]] = S[order[1:], order[:-1]] = 0.5
    return S


@pytest.mark.parametrize("max_rounds", [0, 1, 2])
@pytest.mark.parametrize("d", [1, 4])
def test_capped_rounds_match_reference(d, max_rounds):
    """``max_rounds`` caps the rounds after the first as the reference's
    does: the labels short of the fixed point are equal at d = 1 and d = 4
    CPU shards to the reference's on its one-device mesh."""
    S = _chain(40, 6)
    want = np.asarray(ref_components(jnp.asarray(S), 0.3, _mesh1(), max_rounds=max_rounds))
    got = distributed_components(torch.as_tensor(S), 0.3, _cpu(d), max_rounds=max_rounds)
    assert np.array_equal(got.numpy(), want)
    assert not np.array_equal(want, components_from_covariance_host(S, 0.3))


# ------------------------------------------------------- d > 1, the port


def _tied_case(p: int, seed: int):
    """S and a lam equal to one of its existing |S_ij|: exact ties."""
    rng = np.random.default_rng(seed)
    S = random_covariance(rng, p)
    vals = np.unique(np.abs(S[np.triu_indices(p, 1)]))
    return S, float(vals[int(0.8 * vals.size)])


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("p,seed", [(30, 3), (41, 4)])
def test_components_at_d_shards_equal_host_and_one_shard(d, p, seed):
    S, lam = _tied_case(p, seed)
    assert (np.abs(S) == lam).sum() >= 2
    host = components_from_covariance_host(S, lam)
    one = distributed_components(torch.as_tensor(S), lam, _cpu(1)).numpy()
    got = distributed_components(torch.as_tensor(S), lam, _cpu(d)).numpy()
    assert np.array_equal(got, host) and np.array_equal(got, one)
    labels, stats = thresholded_components(S, lam, backend="shard_map", mesh=_cpu(d))
    want, want_stats = thresholded_components(S, lam)
    assert np.array_equal(labels, want) and stats.n_edges == want_stats.n_edges


@pytest.mark.parametrize("d", DS)
def test_bucket_solve_at_d_shards_bit_equal_to_one_shard(d):
    rng = np.random.default_rng(5)
    n = 2 * d + 1  # never a multiple of d: identity blocks pad it
    blocks = np.stack([random_covariance(rng, 6) for _ in range(n)])
    one = distributed_bucket_solve(blocks, 0.2, "bcd", _cpu(1), tol=1e-9)
    got = distributed_bucket_solve(blocks, 0.2, "bcd", _cpu(d), tol=1e-9)
    assert got.shape == (n, 6, 6) and torch.equal(got, one)


def _engine_both(S, lam, devices, **opts):
    """The reference's glasso and the port's Engine on ``devices``, counters
    reset just before each."""
    jopts = JaxOptions(**opts)
    jax_reset("")
    ref = jax_glasso(S, lam, options=jopts)
    jc = jax_counts("router.")
    instrument.reset("")
    got = repro_torch.Engine(options=EngineOptions(device="cpu", **opts),
                             devices=devices).run(S, lam)
    return got, ref, jc


@pytest.mark.parametrize("cc_backend", ["host", "shard_map"])
def test_engine_on_four_cpu_shards(cc_backend):
    """Buckets LPT-placed on four CPU shards (and, with ``"shard_map"``, the
    screen row-sharded over them): Theta bit-equal to one device; labels,
    route mix and ``router.*`` counters equal to the reference's."""
    S = structured_synthetic(16, 10, seed=3)
    lam = 0.6
    got, ref, jc = _engine_both(S, lam, _cpu(4), cc_backend=cc_backend)
    assert len(repro_torch.Engine(options=EngineOptions(device="cpu"), devices=_cpu(4))
               .executor.devices) == 4
    assert np.array_equal(got.labels, ref.labels) and got.route_mix == ref.route_mix
    assert instrument.counts("router.") == jc
    assert len(got.route_mix) >= 4
    one = repro_torch.Engine(options=EngineOptions(device="cpu", cc_backend=cc_backend)).run(
        S, lam)
    assert np.array_equal(got.Theta, one.Theta)
    np.testing.assert_allclose(got.Theta, ref.Theta, rtol=0, atol=1e-9)


# ------------------------------------------- d = 4 vs the reference at d = 4

_REFERENCE_D4 = """
import json, sys
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from repro.core.distributed import distributed_bucket_solve, distributed_components
from repro.core.glasso import glasso
from repro.core.instrument import counts, reset
from repro.core.jax_compat import local_device_mesh
from repro.core.solvers import glasso_bcd
from repro.core.solvers.sharded import glasso_sharded
from repro.engine import EngineOptions

assert jax.device_count() == 4, jax.devices()
inp = np.load(sys.argv[1])
mesh = local_device_mesh("data")
out = {}
out["cc_labels"] = np.asarray(
    distributed_components(jnp.asarray(inp["cc_S"]), float(inp["cc_lam"]), mesh))
out["bucket"] = np.asarray(distributed_bucket_solve(
    inp["blocks"], float(inp["bucket_lam"]), glasso_bcd, mesh, tol=1e-9))
res = glasso_sharded(inp["sharded_S"], float(inp["sharded_lam"]))
out["sharded_theta"] = res.Theta
out["sharded_facts"] = np.array([res.iters, res.retries, res.padded, res.n_shards])
reset("")
r = glasso(inp["engine_S"], float(inp["engine_lam"]), options=EngineOptions(
    solver="admm", solver_opts={"tol": 1e-9}, oversize_threshold=60))
out["engine_theta"] = r.Theta
out["engine_labels"] = r.labels
out["engine_meta"] = np.array(json.dumps({
    "route_mix": r.route_mix, "oversize": r.oversize,
    "counters": {k: v for k, v in counts("solver.oversize.").items()}}))
np.savez(sys.argv[2], **out)
"""


def _paper_cut(seed: int) -> np.ndarray:
    S = np.asarray(paper_synthetic(K=2, p1=50, seed=seed))[:100, :100]
    return 0.5 * (S + S.T)


@pytest.fixture(scope="module")
def reference_d4(tmp_path_factory):
    """The reference on four emulated devices, once for the module; returns
    (inputs, outputs, seconds)."""
    root = tmp_path_factory.mktemp("reference_d4")
    rng = np.random.default_rng(0)
    cc_S, _ = _tied_case(30, 6)
    inputs = {
        "cc_S": cc_S,
        "cc_lam": _tied_case(30, 6)[1],
        "blocks": np.stack([np.cov(rng.standard_normal((24, 6)), rowvar=False, bias=True)
                            for _ in range(5)]),
        "bucket_lam": 0.2,
        "sharded_S": _paper_cut(1),
        "sharded_lam": 0.15,
        "engine_S": _paper_cut(4),
        "engine_lam": 0.15,
    }
    np.savez(root / "in.npz", **inputs)
    env = {
        "PYTHONPATH": SRC,
        "PATH": "/usr/bin:/bin",
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
    }
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE_D4, str(root / "in.npz"), str(root / "out.npz")],
        capture_output=True, text=True, env=env, timeout=REFERENCE_TIMEOUT,
    )
    seconds = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return inputs, dict(np.load(root / "out.npz")), seconds


def test_components_at_four_shards_match_reference_at_four(reference_d4):
    inp, out, _ = reference_d4
    got = distributed_components(torch.as_tensor(inp["cc_S"]), inp["cc_lam"], _cpu(4))
    assert np.array_equal(got.numpy(), out["cc_labels"])


def test_bucket_solve_at_four_shards_matches_reference_at_four(reference_d4):
    inp, out, _ = reference_d4
    got = distributed_bucket_solve(inp["blocks"], inp["bucket_lam"], "bcd", _cpu(4), tol=1e-9)
    np.testing.assert_allclose(got.numpy(), out["bucket"], rtol=0, atol=BUCKET_ATOL)


def test_sharded_solve_at_four_shards_matches_reference_at_four(reference_d4):
    inp, out, _ = reference_d4
    res = glasso_sharded(inp["sharded_S"], inp["sharded_lam"], mesh=_cpu(4))
    assert [res.iters, res.retries, res.padded, res.n_shards] == out["sharded_facts"].tolist()
    assert res.padded == 128 and res.n_shards == 4
    np.testing.assert_allclose(res.Theta, out["sharded_theta"], rtol=0, atol=THETA_ATOL)


def test_engine_oversize_route_at_four_shards_matches_reference_at_four(reference_d4):
    inp, out, _ = reference_d4
    meta = json.loads(str(out["engine_meta"]))
    instrument.reset("")
    engine = repro_torch.Engine(
        options=EngineOptions(solver="admm", solver_opts={"tol": 1e-9}, oversize_threshold=60,
                              device="cpu"),
        devices=_cpu(4),
    )
    got = engine.run(inp["engine_S"], inp["engine_lam"])
    assert got.route_mix == meta["route_mix"] and got.route_mix.get("oversize") == 1
    assert got.oversize == meta["oversize"]
    assert instrument.counts("solver.oversize.") == meta["counters"]
    assert np.array_equal(got.labels, out["engine_labels"])
    np.testing.assert_allclose(got.Theta, out["engine_theta"], rtol=0, atol=ENGINE_ATOL)
