"""One typed options object for the whole engine surface.

``EngineOptions`` mirrors the reference package's options field for field,
so one configuration value drives both packages
(``EngineOptions.from_reference``), and adds ``device``: the port runs on
``"cuda"`` unless the caller asks for ``"cpu"``.

The legacy kwargs still work through the single normalization chokepoint
``normalize_options``: the public wrappers call it with ``warn=True`` so
kwarg-style configuration raises a ``DeprecationWarning``; passing both
``options=`` and legacy kwargs is an error.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field, fields, replace
from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["EngineOptions", "ENGINE_OPTION_KEYS", "normalize_options", "resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without CUDA raises
    instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass EngineOptions(device='cpu') to run the plain-PyTorch path"
        )
    return dev


@dataclass(frozen=True)
class EngineOptions:
    """Engine configuration as a value.

    ``solver=None`` means the default "bcd"; ``dtype=None`` resolves to
    ``torch.float64`` (a dtype may also be given by name, e.g.
    ``"float32"``).  ``solver_opts`` holds the free-form per-solver knobs
    (``tol``, ``max_sweeps``, ...).  ``device`` is where the solve runs:
    ``"cuda"`` by default, ``"cpu"`` on request (the plain-PyTorch
    versions of the kernels).  ``fused`` turns the wave packer on (True:
    the solver must have the ``fused_stack`` capability), off (False), or
    leaves it to the solver ("auto": on for ``fused_bcd``).
    """

    solver: str | None = None
    dtype: Any = None
    cc_backend: str = "host"
    route: bool = True
    route_check_tol: float = 1e-6
    oversize_threshold: int | None = None
    oversize_budget_mb: float | str | None = None
    output: str = "auto"
    stream: Any = None
    verify_tail: bool = False
    fused: bool | str = "auto"
    trace: bool | str = True
    solver_opts: Mapping[str, Any] = field(default_factory=dict)
    device: str = "cuda"

    def __post_init__(self):
        if self.output not in ("dense", "sparse", "auto"):
            raise ValueError(
                f"output must be 'dense', 'sparse' or 'auto', got {self.output!r}"
            )
        if self.fused not in (True, False, "auto"):
            raise ValueError(
                f"fused must be True, False or 'auto', got {self.fused!r}"
            )
        if self.trace not in (True, False, "jax"):
            raise ValueError(
                f"trace must be True, False or 'jax', got {self.trace!r}"
            )
        object.__setattr__(self, "solver_opts", dict(self.solver_opts))

    @classmethod
    def from_reference(cls, d: Mapping[str, Any], **changes) -> "EngineOptions":
        """Build from ``dataclasses.asdict`` of the reference package's
        ``EngineOptions`` (dtype given by name or None); ``changes`` sets
        port-only fields such as ``device``."""
        known = {f.name for f in fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown EngineOptions field(s) {unknown}")
        return cls(**{**dict(d), **changes})

    # -- derived views ----------------------------------------------------

    def resolved_solver(self, default: str) -> str:
        return self.solver if self.solver is not None else default

    def resolved_dtype(self) -> torch.dtype:
        if self.dtype is None:
            return torch.float64
        if isinstance(self.dtype, torch.dtype):
            return self.dtype
        dt = getattr(torch, np.dtype(self.dtype).name, None)
        if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
            raise ValueError(f"dtype must be a floating dtype, got {self.dtype!r}")
        return dt

    def np_dtype(self) -> np.dtype:
        """The numpy dtype mirroring ``resolved_dtype()`` (host-side
        gathers and assembly use numpy)."""
        return np.dtype(str(self.resolved_dtype()).removeprefix("torch."))

    def resolved_device(self) -> torch.device:
        """``device`` as a ``torch.device`` (``resolve_device``)."""
        return resolve_device(self.device)

    def replace(self, **changes) -> "EngineOptions":
        """``dataclasses.replace`` with solver_opts MERGED, not clobbered:
        unknown keys in ``changes`` update solver_opts entry-wise."""
        known = {f.name for f in fields(self)}
        direct = {k: v for k, v in changes.items() if k in known}
        extra = {k: v for k, v in changes.items() if k not in known}
        if extra:
            merged = dict(self.solver_opts)
            merged.update(extra)
            direct.setdefault("solver_opts", merged)
        return replace(self, **direct)


#: Engine-configuration keys the legacy kwarg layer recognizes; anything
#: else a caller passes is absorbed into ``solver_opts``.
ENGINE_OPTION_KEYS = frozenset(
    f.name for f in fields(EngineOptions) if f.name != "solver_opts"
)

_DEPRECATION_MSG = (
    "configuring {context} via bare engine kwargs ({keys}) is deprecated; "
    "pass options=EngineOptions(...) instead (repro_torch.engine.EngineOptions)"
)


def normalize_options(
    options: EngineOptions | None,
    kwargs: Mapping[str, Any],
    *,
    warn: bool = False,
    context: str = "the engine",
) -> EngineOptions:
    """THE normalization chokepoint for ``options=`` / legacy kwargs."""
    if options is not None:
        if kwargs:
            raise TypeError(
                f"pass options=EngineOptions(...) OR legacy engine kwargs "
                f"({sorted(kwargs)}), not both"
            )
        if not isinstance(options, EngineOptions):
            raise TypeError(
                f"options must be an EngineOptions, got {type(options).__name__}"
            )
        return options
    if not kwargs:
        return EngineOptions()
    if warn:
        warnings.warn(
            _DEPRECATION_MSG.format(context=context, keys=sorted(kwargs)),
            DeprecationWarning,
            stacklevel=3,
        )
    direct = {k: v for k, v in kwargs.items() if k in ENGINE_OPTION_KEYS}
    solver_opts = {k: v for k, v in kwargs.items() if k not in ENGINE_OPTION_KEYS}
    return EngineOptions(solver_opts=solver_opts, **direct)
