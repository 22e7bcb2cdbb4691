"""Captured serving calls: the port's counterpart of ``jax.jit`` on a
serving function.

The JAX package compiles each serving call once per input shape and then
runs the compiled program (``make_serving_forward``,
``make_tiled_serving_forward``, ``AnomalyServer.register``). The port's
counterpart on the card is a CUDA graph per input signature: the Python
that launches the kernels runs twice per signature, and every later call
is one graph replay, whatever the number of kernels behind it.

``CapturedCall(fn, device)`` wraps ``fn`` (device tensors in, one tensor
out) and keeps one entry per signature, the inputs' shapes and dtypes:

- call 1 of a new signature copies the inputs into the entry's static
  buffers and runs ``fn`` launched on a side stream (the warm-up torch's
  capture asks for), and returns its result. That call builds the kernels,
  sets their shared-memory attributes and fills every cached device tensor
  (such as ``window_attention.shift_labels``) outside any capture;
- call 2 captures ``fn`` on the static inputs into a graph with a memory
  pool of its own (``torch.cuda.graph``, which empties the allocator's
  cache first), then replays it;
- later calls copy the inputs into the static buffers and replay.

The static output lives in the graph's pool and the next replay overwrites
it, so calls 2 and later return a clone. A capture that fails raises;
nothing falls back to the launched path. On the CPU, and with
``capture=False``, ``fn`` runs as it is on the inputs moved to ``device``.

The wrappers' launch counters count on the host: a signature's warm-up and
its capture each count one call's launches, and a replay counts none.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch


class _Entry:
    """One signature's static inputs, and once captured its graph and
    static output. The entry holds every buffer the graph touches: the
    inputs here, the rest in the graph's memory pool."""

    def __init__(self, inputs: List[torch.Tensor]):
        self.inputs = inputs
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.output: Optional[torch.Tensor] = None


class CapturedCall:
    """``fn`` served through one CUDA graph per input signature (see the
    module docstring). Inputs may be numpy arrays or tensors on any device;
    ``fn`` receives tensors on ``device`` and returns one tensor."""

    def __init__(self, fn: Callable[..., torch.Tensor], device,
                 capture: bool = True):
        self.fn = fn
        self.device = torch.device(device)
        self.capture = capture and self.device.type == "cuda"
        self._entries: Dict[Tuple, _Entry] = {}

    def __call__(self, *inputs) -> torch.Tensor:
        xs = [torch.as_tensor(x) for x in inputs]
        if not self.capture:
            return self.fn(*(x.to(self.device) for x in xs))
        key = tuple((tuple(x.shape), x.dtype) for x in xs)
        entry = self._entries.get(key)
        if entry is None:
            return self._warm_up(key, xs)
        for static, x in zip(entry.inputs, xs):
            static.copy_(x)
        if entry.graph is None:
            self._capture(entry)
        entry.graph.replay()
        return entry.output.clone()

    def _warm_up(self, key: Tuple, xs: List[torch.Tensor]) -> torch.Tensor:
        static = [torch.empty(x.shape, dtype=x.dtype, device=self.device)
                  for x in xs]
        for s, x in zip(static, xs):
            s.copy_(x)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.fn(*static)
        current.wait_stream(side)
        out.record_stream(current)    # allocated on the side stream
        self._entries[key] = _Entry(static)
        return out

    def _capture(self, entry: _Entry) -> None:
        # torch.cuda.graph synchronises and empties the allocator's cache
        # before it captures: a capture cannot free cached blocks when its
        # new pool runs out, so without that a capture after a large
        # launched call can fail for memory that the cache holds
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self.fn(*entry.inputs)
        entry.graph, entry.output = graph, out

    def signatures(self) -> List[Tuple]:
        """The input signatures seen so far, in first-call order."""
        return list(self._entries)

    def captured(self) -> int:
        """How many signatures have a captured graph."""
        return sum(e.graph is not None for e in self._entries.values())

    def reserved_bytes(self) -> int:
        """Device memory the captured graphs' pools hold: the caching
        allocator's segments of those pools (``torch.cuda.memory_snapshot``,
        read only when asked)."""
        pools = {tuple(e.graph.pool()) for e in self._entries.values()
                 if e.graph is not None}
        if not pools:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) in pools)
