"""The engine's step runner: each tick's device program written once, and
how the programs run chosen once per engine.

The four programs, composed from ``raft/packed_step.py``'s functions:
``dense(state, member, in10, pf, window, plane)`` -> ``(state, flat, ov)``;
``sparse(state, member, k_out, idx, vals, pf, window, plane)`` -> ``(state,
flat, sv, ov)``; ``compacted(state, member, G, k, plan, vals, pf, window,
plane)`` -> ``(state, flat, ov)``, the active set's tick (gather the rows
``G`` into a bucket of ``k``, step them through the compact window, scatter
them back over the idle decay of every row); ``decay(state, pf, window)``
-> ``state``, an all-quiescent tick. ``ov`` is the step's (9, rows, N)
device outbox, which the route fabric scatters from. ``bucket(G)`` ->
``(k, build_k, plan)`` sizes the compacted tick (``plan``: a mesh's
``ShardPlan``, else None); ``fetch(flat)`` starts the flat's copy to the
host and ``join(h)`` reads the tick handle's copy there. Host inputs are
int32 numpy arrays. Each program takes the engine's ``PhaseProfiler`` and
enters its phases: ``dispatch``, and for an eager compacted tick
``compact`` (the gather), ``dispatch`` and ``scatter``.

:func:`step_runner` picks the runner: :class:`_PyRunner` (backend
``"python"``, the scalar oracle), :class:`_MeshRunner` (a mesh: each program
per 'p' shard, flat and ``ov`` one block per shard), or :class:`_Runner`
(one torch device, eager; on a card the sparse and compacted programs run
through the engine's :class:`GraphCache`).

The graph cache replays a program as a ``torch.cuda.CUDAGraph``: one launch
where the eager sparse step makes ~1,400, whose host dispatch sets its time
on one card. The captured function is the body the eager run calls. Keys:
``("sparse", K, k_out, window)`` and ``("compacted", k, window)``, each
from a fixed ladder (P, N, dtypes, ``params`` and the slot are fixed per
engine). A key's first run is eager, its second captures (inside
``dispatch/capture``), every later one replays (inside ``dispatch``); a run
with a routed inbox plane is eager. Before a replay every input is copied
into the graph's buffers on the current stream (group admin, parole holds
and send-pointer fix-ups replace state leaves and ``member`` between
ticks): one set of full-size inputs (state, ``member``, ``peer_fresh``) for
every key of the engine, and ``idx``/``vals`` per key, through pinned
memory. After it every output is copied out: ``tick_pipelined`` begins tick
n+1 before tick n's finish reads ``sv``/``ov`` or the flat. The graphs share
one memory pool: they replay one at a time on one stream.

Counters (per node): ``raft_step_graph_{eager,captures,replays}_total``
count the sparse dispatches of engines that can replay graphs, each once;
``raft_active_graph_{eager,captures,replays}_total`` their compacted
dispatches that gather rows (not an all-quiescent tick's decay).
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from josefine_tpu_torch.models.types import NodeState, resolve_device
from josefine_tpu_torch.parallel import sharded as sh
from josefine_tpu_torch.raft.hostio import host_into, host_to
from josefine_tpu_torch.raft.packed_step import (
    _MIRROR13_ROWS,
    _active_window_fn,
    _decay_only_fn,
    _decay_scatter_fn,
    _gather_active,
    _gather_routed,
    _merge_routed,
    _py_active_window,
    _py_decay_scatter,
    _py_gather_active,
    _py_packed_window,
    _py_sparse_window,
    _sparse_window_fn,
    _window_step_fn,
    active_bucket,
)
from josefine_tpu_torch.utils.metrics import REGISTRY
from josefine_tpu_torch.utils.profiling import NULL_PROFILER

_COUNTERS = {
    "sparse": (
        REGISTRY.counter(
            "raft_step_graph_eager_total",
            "Sparse window steps run eager by an engine that replays graphs "
            "(a key's first dispatch, or a routed inbox plane)"),
        REGISTRY.counter("raft_step_graph_captures_total",
                         "Sparse window steps captured as a CUDA graph"),
        REGISTRY.counter("raft_step_graph_replays_total",
                         "Sparse window steps replayed from a CUDA graph"),
    ),
    "compacted": (
        REGISTRY.counter(
            "raft_active_graph_eager_total",
            "Compacted active-set ticks run eager by an engine that replays graphs "
            "(a key's first dispatch, or a routed inbox plane)"),
        REGISTRY.counter("raft_active_graph_captures_total",
                         "Compacted active-set ticks captured as a CUDA graph"),
        REGISTRY.counter("raft_active_graph_replays_total",
                         "Compacted active-set ticks replayed from a CUDA graph"),
    ),
}


def _outbox(flat, mirror_rows: int, rows: int, N: int):
    """The (9, rows, N) outbox that follows a (mirror_rows, rows) mirror in
    a step's flat output, as a view of the flat."""
    cut = mirror_rows * rows
    return flat[cut:cut + 9 * rows * N].reshape(9, rows, N)


def _eager(body, inputs, plane, prof):
    """``body`` run eager over ``inputs``, ``(state, member, pf, up)`` with
    the host arrays ``pf`` and ``up`` uploaded."""
    state, member, pf, up = inputs
    dev = member.device
    return body(prof, state, member, host_to(pf, dev), *(host_to(a, dev) for a in up), plane)


class _CardCapture:
    """Captures on a side stream of the card, into one private memory pool
    shared by the engine's graphs (both made at the first capture)."""

    def __init__(self, device: torch.device):
        self._device = device
        self._stream = self._pool = None

    def __call__(self, fn):
        """``fn()`` captured: returns the graph and ``fn``'s outputs, which
        each replay rewrites. A capture that fails raises."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self._device)
            self._pool = torch.cuda.graph_pool_handle()
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


class _Counts:
    """One program's runs on one engine that can replay graphs: ``eager``,
    ``captures`` and ``replays``, here and in the node's counters."""

    def __init__(self, node, counters):
        self._bound = {k: c.bind(node=node)
                       for k, c in zip(("eager", "captures", "replays"), counters)}
        self.eager = self.captures = self.replays = 0

    def add(self, kind: str) -> None:
        setattr(self, kind, getattr(self, kind) + 1)
        self._bound[kind].inc()


class _Graph:
    """One captured program: its upload's buffers, the shared inputs it
    reads, the graph and its outputs."""

    __slots__ = ("up", "ins", "graph", "outs", "n_state")

    def __init__(self, up, device: torch.device):
        # int32 by the step's contract.
        self.up = [torch.empty(a.shape, dtype=torch.int32, device=device) for a in up]

    def load(self, up) -> None:
        for buf, a in zip(self.up, up):
            host_into(buf, a)

    def capture(self, capture, body, ins: list[torch.Tensor]) -> None:
        self.ins = ins
        state, member, pf = NodeState.from_leaves(ins[:-2]), ins[-2], ins[-1]
        self.graph, (st, *rest) = capture(
            lambda: body(NULL_PROFILER, state, member, pf, *self.up, None))
        self.outs = [*st.leaves(), *rest]
        self.n_state = len(self.outs) - len(rest)


class GraphCache:
    """One engine's captured graphs of every program, by the one key rule
    (module docstring)."""

    def __init__(self, capture, node):
        self._capture = capture
        # key -> the captured graph; None after the key's eager first run.
        self._graphs: dict[tuple, _Graph | None] = {}
        # The full-size inputs every key reads: state leaves, member,
        # peer_fresh.
        self._ins: list[torch.Tensor] | None = None
        self.counts = {p: _Counts(node, cs) for p, cs in _COUNTERS.items()}

    def _load(self, state: NodeState, member, pf: np.ndarray) -> list[torch.Tensor]:
        if self._ins is None:
            self._ins = [torch.empty_like(t) for t in (*state.leaves(), member)]
            # peer_fresh: int32 by the step's contract.
            self._ins.append(torch.empty(pf.shape, dtype=torch.int32, device=member.device))
        for buf, t in zip(self._ins, (*state.leaves(), member)):
            buf.copy_(t, non_blocking=True)
        host_into(self._ins[-1], pf)
        return self._ins

    def run(self, key: tuple, body, inputs, plane, prof):
        """``body(prof, state, member, pf, *up, plane)`` over ``inputs``,
        ``(state, member, pf, up)`` with host arrays ``pf`` and ``up``:
        eager with a routed ``plane`` or at the key's first run, captured at
        its second and replayed after it, each output then a tensor of its
        own. ``key[0]`` names the program."""
        counts = self.counts[key[0]]
        if plane is not None or key not in self._graphs:
            if plane is None:
                self._graphs[key] = None
            counts.add("eager")
            return _eager(body, inputs, plane, prof)
        state, member, pf, up = inputs
        with prof.phase("dispatch"):
            ins = self._load(state, member, pf)
            g = self._graphs[key]
            if g is None:
                with prof.phase("capture"):
                    g = self._graphs[key] = _Graph(up, member.device)
                    g.load(up)
                    g.capture(self._capture, body, ins)
                counts.add("captures")
            else:
                g.load(up)
                counts.add("replays")
            g.graph.replay()
            outs = [t.clone() for t in g.outs]
        return (NodeState.from_leaves(outs[:g.n_state]), *outs[g.n_state:])


class _Runner:
    """The programs on one torch device: eager, the sparse and compacted
    programs through ``graphs`` where it is given (module docstring)."""

    def __init__(self, params, me: int, P: int, N: int, device: torch.device,
                 graphs: GraphCache | None = None):
        self.params, self.P, self.N, self.device = params, P, N, device
        # The slot id as an int64 (1,) tensor on the device, as the steps take it.
        self.me = host_to(np.asarray([me], np.int64), device)
        self.graphs = graphs

    def _run(self, key: tuple, body, inputs, plane, prof):
        if self.graphs is None:
            return _eager(body, inputs, plane, prof)
        return self.graphs.run(key, body, inputs, plane, prof)

    def dense(self, state, member, in10, pf, window, plane, prof):
        dev = self.device
        with prof.phase("dispatch"):
            st, flat = _window_step_fn(window)(self.params, member, self.me, state,
                                               host_to(in10, dev), host_to(pf, dev), plane)
        return st, flat, _outbox(flat, 10, self.P, self.N)

    def sparse(self, state, member, k_out, idx, vals, pf, window, plane, prof):
        # The routed plane is dense-addressed: routed rows never join the
        # sparse upload.
        step = _sparse_window_fn(k_out, window)

        def body(prof, state, member, pf, idx, vals, plane):
            with prof.phase("dispatch"):
                return step(self.params, member, self.me, state, pf, idx, vals, plane)

        return self._run(("sparse", len(idx), k_out, window), body,
                         (state, member, pf, (idx, vals)), plane, prof)

    def compacted(self, state, member, G, k, plan, vals, pf, window, plane, prof):
        # The ids cross the bus at 32 bits, as in the JAX engine, and are
        # widened once on the card for the gathers and scatters.
        idx = np.full(k, self.P, np.int32)
        idx[:len(G)] = G
        step, scatter = _active_window_fn(window), _decay_scatter_fn(window)

        def body(prof, state, member, pf, idx, vals, plane):
            i = idx.long()
            with prof.phase("compact"):
                state_c, member_c = _gather_active(state, member, i)
            with prof.phase("dispatch"):
                rows, flat = step(self.params, member_c, self.me, state_c, vals, pf, plane, i)
            with prof.phase("scatter"):
                return scatter(self.params, state, pf, i, rows), flat

        st, flat = self._run(("compacted", k, window), body,
                             (state, member, pf, (idx, vals)), plane, prof)
        return st, flat, _outbox(flat, _MIRROR13_ROWS, k, self.N)

    def decay(self, state, pf, window, prof):
        with prof.phase("dispatch"):
            return _decay_only_fn(window)(self.params, state, host_to(pf, self.device))

    def bucket(self, G):
        k = active_bucket(len(G), self.P)
        return k, k, None

    def fetch(self, flat):
        """Start the flat output's one copy to the host, into pinned memory:
        ``(host flat, [ready events])``; None (an all-quiescent tick) and a
        flat on the host as they are."""
        if flat is None or not flat.is_cuda:
            return flat, []
        flat = flat.to("cpu", non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return flat, [ready]

    def join(self, h: dict) -> np.ndarray | None:
        """The handle's fetched flat as the array ``tick_finish`` reads."""
        return None if h["flat"] is None else h["flat"].numpy()


class _PyRunner(_Runner):
    """The scalar oracle (backend ``"python"``): host arrays in, a routed
    plane merged on the host."""

    def dense(self, state, member, in10, pf, window, plane, prof):
        with prof.phase("dispatch"):
            if plane is not None:
                in10 = _merge_routed(np, in10, plane)
            st, flat = _py_packed_window(self.params, member, self.me, state, in10, pf,
                                         ticks=window)
        return st, flat, _outbox(flat, 10, self.P, self.N)

    def sparse(self, state, member, k_out, idx, vals, pf, window, plane, prof):
        with prof.phase("dispatch"):
            return _py_sparse_window(k_out, self.params, member, self.me, state, pf, idx,
                                     vals, ticks=window, routed=plane)

    def compacted(self, state, member, G, k, plan, vals, pf, window, plane, prof):
        idx = np.full(k, self.P, np.int32)
        idx[:len(G)] = G
        with prof.phase("compact"):
            state_c, member_c = _py_gather_active(state, member, idx)
        if plane is not None:
            vals = _merge_routed(np, vals, _gather_routed(plane, idx))
        with prof.phase("dispatch"):
            rows, flat = _py_active_window(self.params, member_c, self.me, state_c, vals, pf,
                                           window)
        with prof.phase("scatter"):
            st = _py_decay_scatter(self.params, state, pf, idx, rows, window)
        return st, flat, _outbox(flat, _MIRROR13_ROWS, k, self.N)

    def decay(self, state, pf, window, prof):
        with prof.phase("dispatch"):
            return _py_decay_scatter(self.params, state, pf, None, None, window)


class _MeshRunner(_Runner):
    """The programs on a mesh: every state leaf and the member mask in
    per-shard blocks (:class:`~josefine_tpu_torch.parallel.sharded.Shards`),
    each shard stepping its own rows on its device, the flat and ``ov`` one
    block per shard, all in ``dispatch``."""

    def __init__(self, params, me: int, P: int, N: int, device: torch.device, mesh):
        super().__init__(params, me, P, N, device)
        self.mesh = mesh
        self.S = sh.mesh_shards(mesh)
        self.L = P // self.S
        self.devs = [resolve_device(d) for d in sh.shard_devices(mesh)]
        # The step's params and slot id, one copy per shard's device.
        on = sh._params_on(params, self.devs)
        self.sh_params = [on[str(d)] for d in self.devs]
        self.sh_me = self._per_shard(np.asarray([me], np.int64))

    def _per_shard(self, a: np.ndarray) -> list[torch.Tensor]:
        """One host array uploaded once per distinct shard device, listed
        per shard."""
        on: dict[str, torch.Tensor] = {}
        for d in self.devs:
            if str(d) not in on:
                on[str(d)] = host_to(a, d)
        return [on[str(d)] for d in self.devs]

    def dense(self, state, member, in10, pf, window, plane, prof):
        """The unsharded window step on each shard's rows (as GSPMD runs the
        JAX step over sharded inputs)."""
        L, step = self.L, _window_step_fn(window)
        sts, flats = [], []
        with prof.phase("dispatch"):
            pfs = self._per_shard(pf)
            for s, dev in enumerate(self.devs):
                st, flat = step(self.sh_params[s], member.parts[s], self.sh_me[s],
                                sh.shard_of(state, s), host_to(in10[:, s * L:(s + 1) * L], dev),
                                pfs[s], None if plane is None else plane.parts[s])
                sts.append(st)
                flats.append(flat)
        return sh.join_shards(sts), flats, [_outbox(f, 10, L, self.N) for f in flats]

    def sparse(self, state, member, k_out, idx, vals, pf, window, plane, prof):
        """Each shard steps its rows through the unsharded sparse window
        with its share of the upload (local ids) and compacts its own
        changed rows at ``min(k_out, L)``. The totals add up to the global
        changed count, so a tick overflows exactly when the unsharded
        compaction would, and below the capacity the shard runs joined in
        shard order are the unsharded compaction's rows (:meth:`join`); on
        overflow tick_finish fetches every shard's dense outputs."""
        L = self.L
        # The sparse capacity (grown on its overflow ladder) clamped to the fixed
        # shard row count: a ladder value, not a raw count.
        # graftlint: allow(dev-unbucketed-shape) — min of two ladder/init values
        step = _sparse_window_fn(min(k_out, L), window)
        out = ([], [], [], [])
        with prof.phase("dispatch"):
            pfs = self._per_shard(pf)
            for s, dev in enumerate(self.devs):
                sel = (idx >= s * L) & (idx < (s + 1) * L)
                res = step(self.sh_params[s], member.parts[s], self.sh_me[s],
                           sh.shard_of(state, s), pfs[s], host_to(idx[sel] - s * L, dev),
                           host_to(vals[:, sel], dev), None if plane is None else plane.parts[s])
                for acc, r in zip(out, res):
                    acc.append(r)
        return sh.join_shards(out[0]), out[1], out[2], out[3]

    def compacted(self, state, member, G, k, plan, vals, pf, window, plane, prof):
        """Gather, step, decay and scatter per shard by ``plan``, each
        shard's flat ending with the psum lane."""
        vals_sh = plan.scatter_vals(vals)
        with prof.phase("dispatch"):
            step = sh.make_sharded_active_window(self.mesh, plan.k, window, self.N,
                                                 plane is not None)
            st, flats = step(
                self.sh_params, member, self.sh_me, state,
                [host_to(vals_sh[s], d) for s, d in enumerate(self.devs)],
                self._per_shard(pf),
                [host_to(plan.idx[s], d).long() for s, d in enumerate(self.devs)],
                plane)
        return st, flats, [_outbox(f, _MIRROR13_ROWS, plan.k, self.N) for f in flats]

    def decay(self, state, pf, window, prof):
        with prof.phase("dispatch"):
            return sh.make_sharded_decay_only(self.mesh, window)(
                self.sh_params, state, self._per_shard(pf))

    def bucket(self, G):
        """Shard-local schedule: ``G`` split per 'p' shard, the per-shard
        power-of-8 bucket setting each shard's layout. The host inbox is
        built compactly in ``G`` order and remapped shard-major by the
        plan."""
        plan = sh.ShardPlan(G, self.P, self.S)
        return plan.k, max(len(G), 1), plan

    def fetch(self, flat):
        """One copy per shard, each with the event of its own device's
        stream."""
        if flat is None:
            return None, []
        flat, ready = list(flat), []
        for i, f in enumerate(flat):
            if f.is_cuda:
                flat[i] = f.to("cpu", non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(f.device))
                ready.append(ev)
        return flat, ready

    def join(self, h: dict) -> np.ndarray | None:
        """The handle's per-shard host flats in the layout tick_finish
        reads: the active set's stack as is (its plan picks the rows), the
        dense and sparse outputs joined into the unsharded layout."""
        if h["flat"] is None:
            return None
        flats = [f.numpy() for f in h["flat"]]
        N, L = self.N, self.L
        if h["mode"] == "active":
            return np.stack(flats)
        if h["mode"] == "dense":
            sv = np.concatenate([f[:10 * L].reshape(10, L) for f in flats], axis=1)
            ov = np.concatenate([f[10 * L:].reshape(9, L, N) for f in flats], axis=1)
            return np.concatenate([sv.reshape(-1), ov.reshape(-1)])
        k_out, C = h["k_out"], 10 + 9 * N
        k = min(k_out, L)
        totals = [int(f[0]) for f in flats]
        total = sum(totals)
        out = np.zeros(1 + k_out + k_out * C, np.int32)
        out[0] = total
        if total <= k_out:
            out[1:1 + total] = np.concatenate(
                [f[1:1 + t] + s * L for s, (f, t) in enumerate(zip(flats, totals))])
            out[1 + k_out:1 + k_out + total * C] = np.concatenate(
                [f[1 + k:].reshape(k, C)[:t].reshape(-1) for f, t in zip(flats, totals)])
        return out


def step_runner(backend: str, device: torch.device, mesh, params, me: int, P: int, N: int,
                node):
    """The runner of an engine of slot ``me`` over ``P`` groups of ``N``
    slots: the scalar oracle for backend ``"python"``, the mesh runner on a
    mesh, else one torch device, whose sparse and compacted programs replay
    captured graphs where the device can capture them (a card)."""
    if backend == "python":
        return _PyRunner(params, me, P, N, device)
    if mesh is not None:
        return _MeshRunner(params, me, P, N, device, mesh)
    capture = capture_for(device)
    return _Runner(params, me, P, N, device,
                   None if capture is None else GraphCache(capture, node))
