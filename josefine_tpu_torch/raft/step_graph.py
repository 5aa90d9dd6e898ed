"""Captured CUDA graphs of the engine's sparse window step.

On one card the sparse step (``packed_step._sparse_window_fn``) is some
1,400 small PyTorch kernels a tick at 5 nodes, and the host's per-op
dispatch sets its time, not the card. :class:`StepGraphs` captures the
unchanged program as a ``torch.cuda.CUDAGraph`` and replays it: one launch
where the eager call makes one per op.

A graph is keyed by ``(K, k_out, window)``, the upload bucket's length, the
compaction capacity and the window, each drawn from a fixed ladder (P, N,
the dtypes and the leaf shapes are fixed per engine). ``params`` and ``me``
are the engine's own long-lived tensors: a graph reads them in place, and
their identities are part of the key. A key's first dispatch runs eager and
is its warm-up, the second captures, every later one replays. A dispatch
with a routed inbox plane runs eager.

A replay reads fixed input buffers and writes fixed output buffers. Before
it, every tensor the step reads is copied into the graph's inputs on the
current stream: the state leaves and ``member``, which group admin, parole
holds and send-pointer fix-ups replace between ticks, and the host's
``peer_fresh``, ``idx`` and ``vals``, through pinned memory. After
it, every output is copied out: ``tick_pipelined`` begins tick n+1 before
tick n's finish may read ``sv``/``ov``, and the route fabric scatters from
``ov``. An engine's graphs share one memory pool: they replay one at a
time on one stream, and each replay's outputs are copied out before the
next.

Counters (per node): ``raft_step_graph_eager_total``,
``raft_step_graph_captures_total`` and ``raft_step_graph_replays_total``
count the sparse dispatches of engines that can replay graphs, each once;
the engine's profiler times each capture as ``dispatch/capture``.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from josefine_tpu_torch.models.types import NodeState
from josefine_tpu_torch.raft.hostio import host_into, host_to
from josefine_tpu_torch.raft.packed_step import _sparse_window_fn
from josefine_tpu_torch.utils.metrics import REGISTRY

_m_eager = REGISTRY.counter(
    "raft_step_graph_eager_total",
    "Sparse window steps run eager by an engine that replays graphs "
    "(a key's first dispatch, or a routed inbox plane)")
_m_captures = REGISTRY.counter(
    "raft_step_graph_captures_total", "Sparse window steps captured as a CUDA graph")
_m_replays = REGISTRY.counter(
    "raft_step_graph_replays_total", "Sparse window steps replayed from a CUDA graph")


class _CardCapture:
    """Captures on a side stream of the card, into one private memory pool
    shared by the engine's graphs."""

    def __init__(self, device: torch.device):
        self._device = device
        self._stream = torch.cuda.Stream(device)
        self._pool = torch.cuda.graph_pool_handle()

    def __call__(self, fn):
        """``fn()`` captured: returns the graph and ``fn``'s outputs, which
        each replay rewrites. A capture that fails raises."""
        graph = torch.cuda.CUDAGraph()
        cur = torch.cuda.current_stream(self._device)
        self._stream.wait_stream(cur)
        # No collection inside the capture: a destructor's CUDA call would
        # fail it.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(self._stream):
                graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
                try:
                    out = fn()
                finally:
                    graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        cur.wait_stream(self._stream)
        return graph, out


def capture_for(device: torch.device):
    """How ``device`` captures graphs, or None where no graph can run."""
    return _CardCapture(device) if device.type == "cuda" else None


class _Graph:
    """One captured step: its input buffers and its outputs."""

    __slots__ = ("ins", "up", "graph", "outs", "keep")

    def __init__(self, state: NodeState, member, pf, idx, vals):
        self.ins = [torch.empty_like(t) for t in (*state.leaves(), member)]
        # peer_fresh, idx and vals: int32 by the sparse contract.
        self.up = [torch.empty(a.shape, dtype=torch.int32, device=member.device)
                   for a in (pf, idx, vals)]

    def load(self, state: NodeState, member, pf, idx, vals) -> None:
        """Copy the step's inputs into the buffers the graph reads."""
        for buf, t in zip(self.ins, (*state.leaves(), member)):
            buf.copy_(t, non_blocking=True)
        for buf, a in zip(self.up, (pf, idx, vals)):
            host_into(buf, a)

    def capture(self, capture, fn, params, me) -> None:
        st_in, member_in, up = NodeState.from_leaves(self.ins[:-1]), self.ins[-1], self.up
        self.graph, (st, flat, sv, ov) = capture(
            lambda: fn(params, member_in, me, st_in, *up))
        self.outs = [*st.leaves(), flat, sv, ov]
        self.keep = (params, me)  # their ids are in the key


class StepGraphs:
    """One engine's graphs of the sparse window step (module docstring)."""

    def __init__(self, capture, node):
        self._capture = capture
        # key -> _Graph once captured; None after the key's eager first use.
        self._graphs: dict[tuple, _Graph | None] = {}
        self._c_eager = _m_eager.bind(node=node)
        self._c_captures = _m_captures.bind(node=node)
        self._c_replays = _m_replays.bind(node=node)
        self.eager = self.captures = self.replays = 0

    def dispatch(self, k_out: int, window: int, params, member, me, state: NodeState,
                 pf: np.ndarray, idx: np.ndarray, vals: np.ndarray, plane, prof):
        """``_sparse_window_fn(k_out, window)`` over these inputs, the host
        arrays ``pf``, ``idx`` and ``vals`` uploaded: ``(state, flat, sv,
        ov)``, each a tensor of its own."""
        fn = _sparse_window_fn(k_out, window)
        key = (len(idx), k_out, window, id(params), id(me))
        if plane is not None or key not in self._graphs:
            if plane is None:
                self._graphs[key] = None
            self.eager += 1
            self._c_eager.inc()
            dev = member.device
            return fn(params, member, me, state, host_to(pf, dev), host_to(idx, dev),
                      host_to(vals, dev), plane)
        g = self._graphs[key]
        if g is None:
            with prof.phase("capture"):
                g = _Graph(state, member, pf, idx, vals)
                g.load(state, member, pf, idx, vals)
                g.capture(self._capture, fn, params, me)
            self._graphs[key] = g
            self.captures += 1
            self._c_captures.inc()
        else:
            g.load(state, member, pf, idx, vals)
            self.replays += 1
            self._c_replays.inc()
        g.graph.replay()
        outs = [t.clone() for t in g.outs]
        n = len(outs) - 3
        return (NodeState.from_leaves(outs[:n]), *outs[n:])
