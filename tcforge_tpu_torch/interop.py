"""Carry a chain's per-filter state between the JAX package and the port.

The JAX chain's carried state is what this system has in place of
weights: hqdn3d's ``{"init", "y", "u", "v"}`` (FrameAnt), tomsmocomp's
``{"y", "u", "v"}`` uint8 two-frame windows and denoise3d's
``{"y", "u", "v"}`` int32 previous output frames; unsharp has none: with it the port can start
mid-stream where a JAX run stopped, and the reverse.  The JAX side hands
over its state as numpy arrays (``np.asarray`` of each leaf), so this
module needs no JAX.

The cadence filters carry frames and counters: ivtc's ``{"y", "u", "v"}``
of two frames goes through ``states_from_numpy`` like the others;
decimate's ring (``metric``, ``ok``, ``frame_in``, ``frame_out``,
``count`` and the four delayed frames) and 32drop's ``last``, ``lasti``,
``fnum``, ``lfnum``, ``dcnt`` go through ``carry_from_numpy``, because
the port keeps their counters on the host as Python ints; so do the
carries of smartdeinter, smartyuv, doublefps, smartbob and modfps.

The clean-up filters' carries go through ``carry_from_numpy`` too: the
0-d ``init`` (and pp's tmpnoise ``seeded``) becomes a Python bool,
decided on the host, and the rest stays on the device: yuvdenoise's
``reset`` counter and its ``y/u/v`` and ``y2/u2/v2`` averages, dnr's
reference frame and lock history ``hist``, pp's previous output planes,
yait's previous frame or row buffer (and pass 1's ``ed``, ``od``,
``ids``), detectclipping's bounds, fields' saved field and denoise3d's
RGB24 carry ``{"rgb": (H, W, 3)}``.

stabilize's carry goes through ``carry_from_numpy`` too: ``init``
becomes a Python bool and the previous frame, the last batch's field
shifts, contrasts, ``valid`` flags and ids stay tensors; so does
fieldanalysis's, whose previous frame and fields stay on the device
while ``started``, the telecine state and the eight ``counts`` become
Python ints, where its state machine runs.

The MPEG importer's decoder state is its two anchor frames: the JAX
importer's ``_ref_fwd`` and ``_ref_bwd``, (y, u, v) planes of the coded
grid, go to the port importer's device tensors through
``mpeg_refs_from_numpy`` and back through ``mpeg_refs_to_numpy``, so that
the port can decode on from a JAX importer's position in the stream.

The audio filters' carries go through ``audio_states_from_numpy`` and
``audio_states_to_numpy``, one per filter of an ``AudioChain``:
normalize's ``(mul, lastavg, mem, idx)`` is three float32 tensors and
a host int (the ring index), detectsilence's counters (``zeros``,
``fid``) are host ints (the JAX carry's last ``events`` rows are what
its ``collect`` has already read), and astat's, lowpass's and aclip's
carries are tensors.
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


# the leaves that the port keeps on the host, where its integer state
# machines run: decimate's and 32drop's ring flags and counters,
# modfps's ring flags, scores and counters, and fieldanalysis's state
# and counters
_HOST_LEAVES = ("ok", "frame_in", "frame_out", "count", "fnum", "lfnum",
                "dcnt", "score", "framesin", "started", "telecine",
                "counts")


def carry_from_numpy(state: Any, device: torch.device) -> Any:
    """A JAX filter carry of numpy arrays -> the port's, for the filters
    whose carry the port keeps partly on the host: decimate and 32drop,
    smartdeinter (``(prev, saved, first)``), smartyuv (that triple per
    plane), doublefps fullheight (``prev_y``, ``first``), smartbob (the
    previous field) and modfps (the delayed frames, ``mlast`` and the
    ring).  Frames go to ``device`` as tensors; ``first`` becomes a
    Python bool, the host leaves Python ints (``ok`` and ``score``
    lists of them), and modfps's ``outframes`` a numpy float32."""
    if state is None:
        return None
    if isinstance(state, dict):
        return {k: (np.asarray(v).tolist() if k in _HOST_LEAVES
                    else np.float32(v) if k == "outframes"
                    else carry_from_numpy(v, device))
                for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return type(state)(carry_from_numpy(v, device) for v in state)
    a = np.asarray(state)
    if a.dtype == np.bool_ and a.ndim == 0:
        return bool(a)
    return torch.from_numpy(np.array(a)).to(device)


def states_to_numpy(states: Any) -> Any:
    """The port's per-filter states -> the same structure of host numpy
    arrays, as the JAX chain takes them (host-side counters as int32)."""
    if states is None:
        return None
    if isinstance(states, dict):
        return {k: states_to_numpy(v) for k, v in states.items()}
    if isinstance(states, (list, tuple)):
        if states and all(isinstance(v, int) for v in states):
            return np.asarray(states, dtype=np.int32)
        return type(states)(states_to_numpy(v) for v in states)
    if isinstance(states, int):
        return np.asarray(states, dtype=np.int32)
    if isinstance(states, (np.generic, np.ndarray)):
        return np.asarray(states)
    return states.detach().cpu().numpy()


def audio_states_from_numpy(filters, states, device: torch.device) -> list:
    """A JAX ``AudioChain``'s states (numpy leaves) -> the port's, for the
    port's ``filters`` (the same filters in the same order)."""
    out = []
    for f, st in zip(filters, states):
        name = f.info.name
        if name == "normalize":
            mul, lastavg, mem, idx = st
            out.append((*states_from_numpy((mul, lastavg, mem), device),
                        int(np.asarray(idx))))
        elif name == "detectsilence":
            out.append({"zeros": int(np.asarray(st["zeros"])),
                        "fid": int(np.asarray(st["fid"])),
                        "silent": torch.zeros((0,), dtype=torch.bool,
                                              device=device)})
        else:
            out.append(states_from_numpy(st, device))
    return out


def audio_states_to_numpy(filters, states) -> list:
    """The port's audio states -> a JAX ``AudioChain``'s (numpy leaves;
    host counters as int32)."""
    out = []
    for f, st in zip(filters, states):
        name = f.info.name
        if name == "detectsilence":
            f.collect(st)          # the flags not yet counted
            out.append({"zeros": np.asarray(st["zeros"], dtype=np.int32),
                        "fid": np.asarray(st["fid"], dtype=np.int32),
                        "events": np.full((1, 2), -1, np.int32)})
        else:
            out.append(states_to_numpy(st))
    return out


def mpeg_refs_from_numpy(importer, ref_fwd, ref_bwd) -> None:
    """Set the port MPEG importer's anchors (on the device it decodes
    onto) from a JAX importer's ``_ref_fwd`` and ``_ref_bwd``: (y, u, v)
    numpy planes, or None."""
    def planes(ref):
        if ref is None:
            return None
        return tuple(torch.from_numpy(np.array(np.asarray(p)))
                     for p in ref)
    importer.set_references(planes(ref_fwd), planes(ref_bwd))


def mpeg_refs_to_numpy(importer):
    """The port MPEG importer's anchors as the JAX importer holds them:
    (ref_fwd, ref_bwd), each (y, u, v) numpy planes or None."""
    return tuple(None if ref is None else
                 tuple(p.detach().cpu().numpy() for p in ref)
                 for ref in importer.references())
