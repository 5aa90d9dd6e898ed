"""Captured CUDA graphs of the engine's sparse window step and of the
active set's compacted tick.

On one card the sparse step (``packed_step._sparse_window_fn``) is some
1,400 small PyTorch kernels a tick at 5 nodes, and the host's per-op
dispatch sets its time, not the card. :class:`StepGraphs` captures the
unchanged program as a ``torch.cuda.CUDAGraph`` and replays it: one launch
where the eager call makes one per op. :class:`ActiveGraphs` does the same
for the active set's compacted tick, the chain of ``_gather_active``,
``_active_window_fn`` and ``_decay_scatter_fn``.

A sparse graph is keyed by ``(K, k_out, window)``, the upload bucket's
length, the compaction capacity and the window; an active graph by ``(k,
window)``, the bucket of gathered rows (``packed_step.active_bucket``) and
the window. Each is drawn from a fixed ladder (P, N, the dtypes and the leaf
shapes are fixed per engine). ``params`` and ``me`` are the engine's own
long-lived tensors: a graph reads them in place, and their identities are
part of the key. A key's first dispatch runs eager and is its warm-up, the
second captures, every later one replays. A dispatch with a routed inbox
plane runs eager.

A replay reads fixed input buffers and writes fixed output buffers. Before
it, every tensor the step reads is copied into the graph's inputs on the
current stream: the state leaves and ``member``, which group admin, parole
holds and send-pointer fix-ups replace between ticks, and the host's
``peer_fresh``, ``idx`` and ``vals``, through pinned memory. The active
graphs of an engine share one set of the full-size inputs (state, ``member``
and ``peer_fresh``), which no key changes; ``idx`` and ``vals`` are the
bucket's. After it, every output is copied out: ``tick_pipelined`` begins
tick n+1 before tick n's finish may read ``sv``/``ov`` or the active flat,
and the route fabric scatters from ``ov`` or the flat. An engine's graphs,
sparse and active, share one memory pool: they replay one at a time on one
stream, and each replay's outputs are copied out before the next.

Counters (per node): ``raft_step_graph_eager_total``,
``raft_step_graph_captures_total`` and ``raft_step_graph_replays_total``
count the sparse dispatches of engines that can replay graphs, each once;
``raft_active_graph_eager_total``, ``raft_active_graph_captures_total`` and
``raft_active_graph_replays_total`` count their compacted dispatches that
gather rows (not an all-quiescent tick's decay), each once. The engine's
profiler times each capture as ``dispatch/capture``.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from josefine_tpu_torch.models.types import NodeState
from josefine_tpu_torch.raft.hostio import host_into, host_to
from josefine_tpu_torch.raft.packed_step import (
    _active_window_fn,
    _decay_scatter_fn,
    _gather_active,
    _sparse_window_fn,
)
from josefine_tpu_torch.utils.metrics import REGISTRY

_m_eager = REGISTRY.counter(
    "raft_step_graph_eager_total",
    "Sparse window steps run eager by an engine that replays graphs "
    "(a key's first dispatch, or a routed inbox plane)")
_m_captures = REGISTRY.counter(
    "raft_step_graph_captures_total", "Sparse window steps captured as a CUDA graph")
_m_replays = REGISTRY.counter(
    "raft_step_graph_replays_total", "Sparse window steps replayed from a CUDA graph")
_m_active_eager = REGISTRY.counter(
    "raft_active_graph_eager_total",
    "Compacted active-set ticks run eager by an engine that replays graphs "
    "(a key's first dispatch, or a routed inbox plane)")
_m_active_captures = REGISTRY.counter(
    "raft_active_graph_captures_total", "Compacted active-set ticks captured as a CUDA graph")
_m_active_replays = REGISTRY.counter(
    "raft_active_graph_replays_total", "Compacted active-set ticks replayed from a CUDA graph")


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


class _ActiveGraph:
    """One captured compacted tick: its bucket's input buffers and its
    outputs."""

    __slots__ = ("up", "graph", "outs", "keep")

    def __init__(self, idx, vals, device: torch.device):
        # idx and vals: int32 by the active-set contract.
        self.up = [torch.empty(a.shape, dtype=torch.int32, device=device)
                   for a in (idx, vals)]

    def load(self, idx: np.ndarray, vals: np.ndarray) -> None:
        for buf, a in zip(self.up, (idx, vals)):
            host_into(buf, a)

    def capture(self, capture, window: int, params, me, ins: list[torch.Tensor]) -> None:
        st_in, member_in, pf_in = NodeState.from_leaves(ins[:-2]), ins[-2], ins[-1]
        idx_in, vals_in = self.up
        step, scatter = _active_window_fn(window), _decay_scatter_fn(window)

        def tick():
            # The engine's eager chain (RaftEngine._step_active), op for op.
            i = idx_in.long()
            state_c, member_c = _gather_active(st_in, member_in, i)
            new_rows, flat = step(params, member_c, me, state_c, vals_in, pf_in)
            return scatter(params, st_in, pf_in, i, new_rows), flat

        self.graph, (st, flat) = capture(tick)
        self.outs = [*st.leaves(), flat]
        self.keep = (params, me)  # their ids are in the key


class _Graphs:
    """The key rule and the counters of one engine's graphs of one program
    (module docstring)."""

    def __init__(self, capture, node, counters):
        self._capture = capture
        # key -> the captured graph; None after the key's eager first use.
        self._graphs: dict[tuple, _Graph | _ActiveGraph | None] = {}
        self._c_eager, self._c_captures, self._c_replays = (c.bind(node=node)
                                                            for c in counters)
        self.eager = self.captures = self.replays = 0

    def _runs_eager(self, key: tuple, plane) -> bool:
        """Whether the dispatch of ``key`` runs eager: with a routed
        ``plane``, or as the key's first use. Counts an eager dispatch."""
        if plane is None and key in self._graphs:
            return False
        if plane is None:
            self._graphs[key] = None
        self.eager += 1
        self._c_eager.inc()
        return True

    def _replay(self, g, captured: bool) -> list[torch.Tensor]:
        """Replay ``g``, its inputs loaded, counted as a capture or a
        replay: its outputs, each a tensor of its own."""
        if captured:
            self.captures += 1
            self._c_captures.inc()
        else:
            self.replays += 1
            self._c_replays.inc()
        g.graph.replay()
        return [t.clone() for t in g.outs]


class StepGraphs(_Graphs):
    """One engine's graphs of the sparse window step (module docstring)."""

    def __init__(self, capture, node):
        super().__init__(capture, node, (_m_eager, _m_captures, _m_replays))

    def dispatch(self, k_out: int, window: int, params, member, me, state: NodeState,
                 pf: np.ndarray, idx: np.ndarray, vals: np.ndarray, plane, prof):
        """``_sparse_window_fn(k_out, window)`` over these inputs, the host
        arrays ``pf``, ``idx`` and ``vals`` uploaded: ``(state, flat, sv,
        ov)``, each a tensor of its own."""
        fn = _sparse_window_fn(k_out, window)
        key = (len(idx), k_out, window, id(params), id(me))
        if self._runs_eager(key, plane):
            dev = member.device
            return fn(params, member, me, state, host_to(pf, dev), host_to(idx, dev),
                      host_to(vals, dev), plane)
        g = self._graphs[key]
        captured = g is None
        if captured:
            with prof.phase("capture"):
                g = _Graph(state, member, pf, idx, vals)
                g.load(state, member, pf, idx, vals)
                g.capture(self._capture, fn, params, me)
            self._graphs[key] = g
        else:
            g.load(state, member, pf, idx, vals)
        outs = self._replay(g, captured)
        n = len(outs) - 3
        return (NodeState.from_leaves(outs[:n]), *outs[n:])


class ActiveGraphs(_Graphs):
    """One engine's graphs of the active set's compacted tick (module
    docstring): gather the bucket's rows, step them, and scatter them back
    over the idle decay of every row."""

    def __init__(self, capture, node):
        super().__init__(capture, node,
                         (_m_active_eager, _m_active_captures, _m_active_replays))
        # The full-size inputs every key reads: state leaves, member,
        # peer_fresh.
        self._ins: list[torch.Tensor] | None = None

    def runs_eager(self, k: int, window: int, params, me, plane) -> bool:
        """Whether this compacted dispatch of bucket ``k`` runs eager (the
        caller runs it): with a routed ``plane``, or as the key's first use.
        Counts an eager dispatch."""
        return self._runs_eager((k, window, id(params), id(me)), plane)

    def dispatch(self, window: int, params, member, me, state: NodeState,
                 pf: np.ndarray, idx: np.ndarray, vals: np.ndarray, prof):
        """The compacted tick over the bucket ``idx`` (padded with P) and its
        packed inbox ``vals``, captured at the key's second dispatch and
        replayed after it: ``(state, flat)``, each a tensor of its own. Only
        where :meth:`runs_eager` said no."""
        if self._ins is None:
            self._ins = [torch.empty_like(t) for t in (*state.leaves(), member)]
            # peer_fresh: int32 by the step's contract.
            self._ins.append(torch.empty(pf.shape, dtype=torch.int32, device=member.device))
        for buf, t in zip(self._ins, (*state.leaves(), member)):
            buf.copy_(t, non_blocking=True)
        host_into(self._ins[-1], pf)
        key = (len(idx), window, id(params), id(me))
        g = self._graphs[key]
        captured = g is None
        if captured:
            with prof.phase("capture"):
                g = _ActiveGraph(idx, vals, member.device)
                g.load(idx, vals)
                g.capture(self._capture, window, params, me, self._ins)
            self._graphs[key] = g
        else:
            g.load(idx, vals)
        outs = self._replay(g, captured)
        return NodeState.from_leaves(outs[:-1]), outs[-1]
