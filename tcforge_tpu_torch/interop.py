"""Carry a chain's per-filter state between the JAX package and the port.

The JAX chain's carried state (for hqdn3d ``{"init", "y", "u", "v"}``)
is what this system has in place of weights: with it the port can start
mid-stream where a JAX run stopped, and the reverse.  The JAX side hands
over its state as numpy arrays (``np.asarray`` of each leaf), so this
module needs no JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def states_from_numpy(states: Any, device: torch.device) -> Any:
    """Per-filter states of numpy arrays -> the same structure of
    tensors on ``device`` (dtype kept: bool, int32, ...)."""
    if states is None:
        return None
    if isinstance(states, dict):
        return {k: states_from_numpy(v, device) for k, v in states.items()}
    if isinstance(states, (list, tuple)):
        return type(states)(states_from_numpy(v, device) for v in states)
    return torch.from_numpy(np.array(states)).to(device)


def states_to_numpy(states: Any) -> Any:
    """The port's per-filter states -> the same structure of host numpy
    arrays, as the JAX chain takes them."""
    if states is None:
        return None
    if isinstance(states, dict):
        return {k: states_to_numpy(v) for k, v in states.items()}
    if isinstance(states, (list, tuple)):
        return type(states)(states_to_numpy(v) for v in states)
    return states.detach().cpu().numpy()
