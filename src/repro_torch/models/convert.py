"""Carry the reference's LM parameters across into the port.

The reference's tree (``repro.models.lm.init_params``) with numpy leaves,
as ``jax.tree.map(np.asarray, params)`` gives it, maps leaf for leaf onto
the port's tree: the two share names, shapes and the ``[d_in, d_out]``
layout.  A bfloat16 leaf arrives as an ``ml_dtypes.bfloat16`` array,
which ``torch.from_numpy`` refuses; it is recognized by its dtype's name
and carried through ``uint16``, so its bits arrive exactly (this module
does not import ``ml_dtypes``)."""
from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a, order="C")            # a writable copy for from_numpy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def lm_params_from_numpy(tree, device) -> dict:
    """Nested dicts of numpy arrays → nested dicts of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: lm_params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)
