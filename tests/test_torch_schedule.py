"""The port's scheduling (``repro_torch.core.schedule``) and the executor's
placement (``BucketExecutor._bucket_cost`` / ``_place``) against the
reference package, on the same sizes and the same plans.

``lpt_assign`` is a copy of the reference's: worker assignments, loads,
makespan and balance are equal, with and without priorities.  The
executor's route-aware cost is equal bucket for bucket, and ``_place``
gives every bucket the same worker index as the reference's ``_place``
over four devices (the reference's returns the device itself: it gets the
indices 0-3 as its devices here).  ``solve_plan(priorities=...)`` places
as the reference's ``_place`` with them.  On four CPU shards of one
process a reused stack that LPT moves to another shard between lambdas is
copied there, and each shard's fused megabatches are its own; neither
changes a bit of Theta.  These are the executor's only paths between
shards that run without a second card."""

import numpy as np
import pytest
import torch

from repro.core.schedule import lpt_assign as ref_lpt_assign
from repro.covariance import structured_synthetic as ref_structured_synthetic
from repro.engine.executor import BucketExecutor as RefExecutor
from repro.engine.planner import build_plan_incremental as ref_build_plan
from repro.engine.registry import label_components as ref_label_components
from repro_torch import EngineOptions
from repro_torch.core import instrument
from repro_torch.core.schedule import Assignment, default_cost, lpt_assign
from repro_torch.covariance import structured_synthetic
from repro_torch.engine.api import Engine
from repro_torch.engine.executor import BucketExecutor
from repro_torch.engine.planner import build_plan_incremental, bucket_key, plan_path
from repro_torch.engine.waves import fused_bin
from repro_torch.engine.registry import label_components


def _same_assignment(got: Assignment, want) -> None:
    np.testing.assert_array_equal(got.worker_of, want.worker_of)
    np.testing.assert_array_equal(got.loads, want.loads)
    assert got.makespan == want.makespan and got.balance == want.balance


@pytest.mark.parametrize("n_workers", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lpt_assign_equals_reference(seed, n_workers):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 60, size=25)
    sizes[:4] = 7  # equal sizes: the stable tie-break decides
    _same_assignment(lpt_assign(sizes, n_workers), ref_lpt_assign(sizes, n_workers))
    prio = rng.integers(0, 3, size=sizes.size)
    _same_assignment(lpt_assign(sizes, n_workers, priorities=prio),
                     ref_lpt_assign(sizes, n_workers, priorities=prio))


def test_lpt_assign_cost_and_validation():
    assert default_cost(5) == 125.0
    sizes = [4, 30, 2, 30, 9]
    got = lpt_assign(sizes, 2, cost=float)
    _same_assignment(got, ref_lpt_assign(sizes, 2, cost=float))
    assert got.makespan == max(got.loads) and got.loads.sum() == sum(sizes)
    with pytest.raises(ValueError, match="priorities"):
        lpt_assign(sizes, 2, priorities=[1, 2])
    empty = lpt_assign([], 3)
    assert empty.worker_of.size == 0 and empty.makespan == 0.0 and empty.balance == 1.0


LAM = 0.6


def _plans(seed: int, oversize: int | None = None):
    """The reference's and the port's plan of one structured workload (all
    five structure classes) at LAM, from the same labels, and its S."""
    S = ref_structured_synthetic(40, 12, seed=seed)
    lam = LAM
    labels = ref_label_components(S, lam, backend="host")
    assert np.array_equal(labels, label_components(S, lam, backend="host"))
    ref_plan, _ = ref_build_plan(S, lam, labels, oversize=oversize)
    plan, _ = build_plan_incremental(S, lam, labels, oversize=oversize)
    assert [(b.size, b.structure, len(b.comps)) for b in plan.buckets] == [
        (b.size, b.structure, len(b.comps)) for b in ref_plan.buckets]
    return plan, ref_plan, S


@pytest.mark.parametrize("route", [True, False])
@pytest.mark.parametrize("seed,oversize", [(0, None), (1, None), (2, 20)])
def test_place_equals_reference_on_four_devices(seed, oversize, route):
    plan, ref_plan, _ = _plans(seed, oversize)
    assert len(plan.buckets) > 4
    ex = BucketExecutor(device="cpu", devices=["cpu"] * 4, route=route)
    ref = RefExecutor(devices=[0, 1, 2, 3], route=route)
    assert [ex._bucket_cost(b) for b in plan.buckets] == [
        ref._bucket_cost(b) for b in ref_plan.buckets]
    got = ex._place(plan.buckets)
    assert got == ref._place(ref_plan.buckets)
    assert set(got) == {0, 1, 2, 3}
    prio = [(i * 7) % 3 for i in range(len(plan.buckets))]
    assert ex._place(plan.buckets, priorities=prio) == ref._place(
        ref_plan.buckets, priorities=prio)


def test_place_on_one_device_places_nothing():
    plan, _, _ = _plans(0)
    ex = BucketExecutor(device="cpu")
    assert len(ex.devices) == 1
    assert ex._place(plan.buckets) == [None] * len(plan.buckets)


def _spy_place(ex: BucketExecutor, remap=lambda ws: ws) -> list:
    """Wrap ``ex._place``: every call's placement (after ``remap``) is
    recorded in the returned list."""
    place, seen = ex._place, []

    def spy(buckets, priorities=None):
        seen.append(remap(place(buckets, priorities=priorities)))
        return seen[-1]

    ex._place = spy
    return seen


def test_solve_plan_places_by_priority_as_the_reference():
    plan, ref_plan, S = _plans(0)
    prio = [(i * 7) % 3 for i in range(len(plan.buckets))]
    ref = RefExecutor(devices=[0, 1, 2, 3])
    want = ref._place(ref_plan.buckets, priorities=prio)
    assert want != ref._place(ref_plan.buckets)  # the priorities move buckets
    ex = BucketExecutor(device="cpu", devices=["cpu"] * 4)
    seen = _spy_place(ex)
    got = ex.solve_plan(plan, LAM, S, priorities=prio)
    assert seen == [want]
    assert np.array_equal(got, BucketExecutor(device="cpu").solve_plan(plan, LAM, S))


@pytest.mark.parametrize("fused", [False, True])
def test_moved_reused_stack_is_copied_to_its_shard(fused):
    """A four-lambda path on four CPU shards: LPT moves some reused buckets
    to another shard between lambdas, and each such stack is a copy of the
    kept one there (same bits, new storage); a bucket that stays keeps the
    kept object.  Theta is bit-equal to one device's at every lambda."""
    S = structured_synthetic(40, 12, seed=0)
    path = plan_path(S, [0.7, 0.65, 0.6, 0.55])

    def run(devices):
        ex = BucketExecutor(device="cpu", devices=devices, fused=fused)
        seen = _spy_place(ex)
        thetas, kept, shards = [], [], []
        for step in path.steps:
            thetas.append(ex.solve_plan(step.plan, step.lam, S, reused_keys=step.reused_keys,
                                        keep_solutions=True))
            kept.append(dict(ex._prev_blocks))
            shards.append(dict(zip(map(bucket_key, step.plan.buckets), seen[-1])))
        return thetas, kept, shards

    one, _, _ = run(["cpu"])
    thetas, kept, shards = run(["cpu"] * 4)
    assert all(np.array_equal(a, b) for a, b in zip(thetas, one))
    moved = stayed = 0
    for k in range(1, len(path.steps)):
        for key in path.steps[k].reused_keys & kept[k - 1].keys() & kept[k].keys():
            old, new = kept[k - 1][key], kept[k][key]
            if shards[k][key] == shards[k - 1][key]:
                stayed += 1
                assert new is old
            else:
                moved += 1
                assert new.data_ptr() != old.data_ptr() and torch.equal(new, old)
    assert moved > 0 and stayed > 0


def test_fused_megabatches_are_per_shard():
    """Two general buckets of one bin (padded sizes 4 and 8): one megabatch
    on one device, one a shard on four CPU shards (LPT puts them on two),
    the same bits."""
    from test_torch_fused import planted_general_blocks

    sizes = [4, 5, 6, 7]
    S = planted_general_blocks(sizes, seed=4)
    assert len({fused_bin(b) for b in sizes}) == 1
    results, dispatches, placed = [], [], []
    for devices in (["cpu"], ["cpu"] * 4):
        eng = Engine(options=EngineOptions(device="cpu", fused=True), devices=devices)
        seen = _spy_place(eng.executor)
        instrument.reset("solver.fused.")
        results.append(eng.run(S, 0.3).Theta)
        dispatches.append(instrument.count("solver.fused.dispatches"))
        placed.append(seen[-1])
    assert placed[0] == [None, None] and len(set(placed[1])) == 2
    assert dispatches == [1, 2]
    assert np.array_equal(results[0], results[1])
