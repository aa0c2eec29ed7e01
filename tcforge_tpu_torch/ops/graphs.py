"""A scan whose step is replayed as a CUDA graph.

A carry run frame after frame (normalize's gain, a ``lax.scan`` in the
JAX filter) is some forty operations on 0-d tensors a frame; on a card
the host's time to queue them, not the card's, is its cost.
``GraphScan`` runs one step on a card eagerly (which also loads the
step's kernels), captures the step once on static tensors and from then
on replays it: per step, one copy in, one replay and one copy out,
whatever the batch's shape.  The step must be made of tensor operations
alone (no read-back, no value that depends on the tensors' contents on
the host), and its inputs and carry keep their shapes from step to
step.  Capture runs on a stream of its own and waits for nothing but
its inputs (no device synchronize).

A capture is broken by what another thread or a finalizer does on the
card meanwhile: a CUDA graph destroyed during it (the cyclic garbage
collector frees a finished session's filters, and their graphs, at
whatever allocation it runs on), another thread's pinned-memory traffic
or a device synchronize.  So ``prepare`` captures when the session's
state is made, before the engine starts its threads, and the garbage
collector stays off for the length of a capture.
"""

from __future__ import annotations

import gc
from typing import Callable, List, Sequence, Tuple

import torch


class GraphScan:
    """``step(x, *carry) -> carry`` over the rows of ``xs``: returns the
    first carry leaf after each step, stacked, and the last carry (see
    the module).  Tensors on the CPU run every step eagerly."""

    def __init__(self, step: Callable[..., Sequence[torch.Tensor]]):
        self.step = step
        self._graph = None
        self._x: torch.Tensor = None
        self._carry: List[torch.Tensor] = []

    def prepare(self, x: torch.Tensor, carry: Sequence[torch.Tensor]
                ) -> None:
        """Capture now, from a step's input ``x`` and a carry of the
        shapes the scan will be given (their values do not matter), so
        that no other thread of a session runs while it does.  Nothing
        on the CPU, or once captured."""
        if x.device.type != "cuda" or self._graph is not None:
            return
        self._capture(x, list(self.step(x, *carry)))

    def __call__(self, xs: torch.Tensor, carry: Sequence[torch.Tensor]
                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        carry = list(carry)
        if xs.device.type != "cuda":
            ys = []
            for x in xs:
                carry = list(self.step(x, *carry))
                ys.append(carry[0])
            return torch.stack(ys), carry
        self.prepare(xs[0], carry)
        ys = torch.empty((len(xs),) + carry[0].shape, dtype=carry[0].dtype,
                         device=xs.device)
        for dst, src in zip(self._carry, carry):
            dst.copy_(src)
        for k in range(len(xs)):
            self._x.copy_(xs[k])
            self._graph.replay()
            ys[k].copy_(self._carry[0])
        return ys, [c.clone() for c in self._carry]

    def _capture(self, x: torch.Tensor, carry: Sequence[torch.Tensor]
                 ) -> None:
        """One step on static tensors, its new carry copied back onto
        the static carry, captured."""
        device = x.device
        current = torch.cuda.current_stream(device)
        self._x = x.clone()
        self._carry = [c.clone() for c in carry]
        stream = torch.cuda.Stream(device)
        stream.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()          # no collection frees a graph mid-capture
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    new = self.step(self._x, *self._carry)
                    for dst, src in zip(self._carry, new):
                        dst.copy_(src)
                finally:
                    graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        current.wait_stream(stream)
        self._graph = graph
