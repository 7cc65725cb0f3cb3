"""Carry the reference's LM parameters, and its train state, across into
the port.

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


def train_state_from_numpy(state, device):
    """The reference's ``TrainState`` with numpy leaves, as
    ``jax.tree.map(np.asarray, state)`` gives it (its step, parameters,
    AdamW ``mu``/``nu`` in their dtypes and error-feedback residuals) → the
    port's ``trainer.TrainState`` on ``device``, so both packages can take
    a step from the same state.  Read by attribute, so this module imports
    nothing of the reference."""
    from repro_torch.train.optimizer import TreeAdamState
    from repro_torch.train.trainer import TrainState

    return TrainState(
        step=tensor_from_numpy(state.step, device),
        params=lm_params_from_numpy(state.params, device),
        opt=TreeAdamState(tensor_from_numpy(state.opt.step, device),
                          lm_params_from_numpy(state.opt.mu, device),
                          lm_params_from_numpy(state.opt.nu, device)),
        ef_residual=lm_params_from_numpy(state.ef_residual, device))
