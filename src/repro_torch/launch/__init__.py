"""Command-line entry points and serving surfaces of the port.

    serve            the LM substrate's serving CLI
    train            the LM substrate's training CLI (``run_training``)
    serve_glasso     ``GlassoServer``: coalesced graphical-lasso serving
                     (``python -m repro_torch.launch.serve_glasso``)
    control_plane    its typed specs, admission control and result cache

The names below are exported lazily, so ``python -m`` on a submodule does
not import it twice."""

from __future__ import annotations

import importlib

_EXPORTS = {
    **{
        name: "repro_torch.launch.control_plane"
        for name in (
            "AdmissionQueue", "DataSpec", "DeadlineExceeded", "DenseSpec", "JointSpec",
            "Overload", "PATH_CRITERIA", "PathSpec", "Quota", "RequestMeta", "ResultCache",
            "SLO_CLASSES", "SolveSpec", "TenantBuckets", "TokenBucket", "deadline_instant",
            "fingerprint_array", "spec_cache_key",
        )
    },
    **{
        name: "repro_torch.launch.serve_glasso"
        for name in ("GlassoRequest", "GlassoServer", "JointRequest", "PathRequest",
                     "serve_stats")
    },
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
