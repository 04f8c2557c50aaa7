"""Parameters of the reference package, converted into the port's modules.

The two packages draw their initial parameters from different generators,
so parity tests initialise the reference's model and load its parameters
here.  ``params_from_reference`` takes the reference's parameter tree (nested
mappings of numpy arrays, the layers stacked on a leading ``(L, ...)`` axis)
and returns a state dict for ``DecoderLM.load_state_dict``: layer ``i`` of
the stack becomes ``layers.<i>.*``, every other leaf keeps its dotted path.
Both packages keep projections as (in, out), so nothing is transposed.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, value


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def params_from_reference(tree: Mapping) -> dict[str, torch.Tensor]:
    """The reference's decoder parameter tree as the port's state dict."""
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(tree):
        if path[0] == "layers":
            stacked = np.asarray(leaf)
            for i in range(stacked.shape[0]):
                out[".".join(("layers", str(i)) + path[1:])] = _tensor(stacked[i])
        else:
            out[".".join(path)] = _tensor(leaf)
    return out
