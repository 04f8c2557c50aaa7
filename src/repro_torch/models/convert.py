"""Parameters of the reference package, converted into the port's modules.

The two packages draw their initial parameters from different generators,
so parity tests initialise the reference's model and load its parameters
here.  ``params_from_reference`` takes the reference's parameter tree (nested
mappings of numpy arrays, the layers stacked on a leading ``(L, ...)`` axis)
and returns a state dict for ``DecoderLM.load_state_dict``: layer ``i`` of
the stack becomes ``layers.<i>.*``, every other leaf keeps its dotted path.
Both packages keep projections as (in, out), so nothing is transposed, and
each leaf keeps its dtype: a bfloat16 config's tree converts bit for bit,
its MoE router staying float32.
Training keeps the reference's stacked tree itself, so
``tree_from_reference`` converts a parameter tree or an optimizer state
leaf for leaf, numpy to torch.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.models.transformer import module_state


def _tensor(a) -> torch.Tensor:
    """An array as a tensor, bit for bit; numpy has no bfloat16 of its own,
    so a bfloat16 leaf (``ml_dtypes``' type, a bf16 config's parameters)
    crosses as its 16-bit pattern."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_reference(tree: Mapping) -> dict[str, torch.Tensor]:
    """The reference's decoder parameter tree as the port's state dict."""
    return module_state(tree_from_reference(tree))


def tree_from_reference(tree, *, device="cpu"):
    """A reference tree (nested mappings of arrays: a parameter tree, an
    optimizer state) as the same nested dicts of tensors on ``device``,
    leaf for leaf: the layout training keeps, so nothing is renamed or
    unstacked."""
    if isinstance(tree, Mapping):
        return {str(k): tree_from_reference(v, device=device) for k, v in tree.items()}
    return _tensor(tree).to(device)
