"""Process-wide counters for planner/executor observability.

The same flat dotted namespace as the reference package, kept over
``repro_torch.obs.metrics.REGISTRY``.  Names the tests and ``chip_smoke.py``
read:

    router.route.<class>            blocks routed per structure class
    router.fallback.<class>         closed-form blocks KKT-rejected and repaired
    executor.dispatches             solver launches issued by the executor
    engine.assemble_us              assembly-stage microseconds
    kernels.tree_glasso.launches    CUDA launches of the forest kernel
    kernels.bucket_glasso.launches  CUDA launches of the fused BCD kernel
    kernels.joint_prox.launches     CUDA launches of the joint prox kernel
    kernels.prox_l1.launches        CUDA launches of the pg step kernel
    kernels.shard_prox.launches     CUDA launches of the ADMM prox-tail kernel
    kernels.covgram.launches        CUDA launches of the centered Gram kernel
    kernels.flash_attention.launches  CUDA launches of the prefill attention kernel
    kernels.flash_attention.wgmma_launches  those of them on its bf16 wgmma body
    structure.classified.oversize   components the planner classed oversize
    solver.oversize.dispatched / .cg_iters / .fallbacks
                                    sharded solves, their inner steps, and
                                    the blocks repaired by the iterative tail
    solver.oversize.device_bytes_peak   the sharded solve's memory model
    joint.dispatches / joint.fallbacks / joint.closed_form_blocks /
    joint.shared_blocks             the joint engine's routing ledger

The ``kernels.*`` counters are bumped by the kernel wrappers only where
they launch on the card — the CPU path through the plain versions leaves
them at zero.
"""

from __future__ import annotations

import time

from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import REGISTRY as _REGISTRY

_clock = time.perf_counter


def _as_int(v: float) -> int:
    return v if isinstance(v, int) else int(round(v))


def bump(name: str, n: int = 1) -> None:
    _REGISTRY.bump_flat(name, n)


def timed_dispatch(call, *args, **kwargs):
    """Run one bucket-dispatch chokepoint; returns ``(result, seconds)``.

    Bumps ``engine.dispatch.count`` and ``engine.dispatch.us``.  On the card
    a launch is asynchronous, so the seconds are host enqueue time; the
    chordal route's host solve is timed in full."""
    with _trace.span(
        "engine.dispatch", call=getattr(call, "__name__", str(call))
    ):
        t0 = _clock()
        out = call(*args, **kwargs)
        dt = _clock() - t0
    _REGISTRY.bump_flat("engine.dispatch.count", 1)
    _REGISTRY.bump_flat("engine.dispatch.us", dt * 1e6)
    return out, dt


def set_peak(name: str, value: int) -> None:
    """Raise a high-watermark counter to ``value`` if it is larger."""
    _REGISTRY.set_peak_flat(name, int(value))


def count(name: str) -> int:
    return _as_int(_REGISTRY.flat_value(name))


def counts(prefix: str = "") -> dict[str, int]:
    return {k: _as_int(v) for k, v in _REGISTRY.flat_items(prefix).items()}


def tail_counts(prefix: str) -> dict[str, int]:
    """Counters under ``prefix``, keyed by the remainder of the name."""
    return {
        k[len(prefix):]: _as_int(v)
        for k, v in _REGISTRY.flat_items(prefix).items()
    }


def route_mix_counts() -> dict[str, int]:
    """Blocks routed per structure class since the last reset."""
    return tail_counts("router.route.")


def reset(prefix: str = "") -> None:
    """Reset all counters with the given prefix ('' resets everything)."""
    _REGISTRY.reset(prefix)
