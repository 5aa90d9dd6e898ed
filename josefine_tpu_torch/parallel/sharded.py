"""Sharded programs over a mesh of torch devices.

The port of the JAX package's ``parallel/sharded.py``. JAX runs these as
``shard_map`` programs; here one Python process drives every shard, as
``shard_map``'s single controller does, and each shard's program is the
port's own torch ops over that shard's tensors alone. A 'p' shard's blocks
live on its device (:func:`shard_devices`); several shards may share a
device (tests run k shards on the host, ``chip_smoke.py`` runs S shards on
one card), and nothing but the two named exchanges below moves data between
shards.

Two families live here:

1. **The cluster-step simulation** (:func:`make_sharded_cluster_step`,
   BASELINE config 5 / ``bench_podsim``): the whole N-node cluster over a
   ('p', 'n') mesh. 'p' splits the P independent groups (no traffic between
   shards); 'n' splits the N members of each group, so per-tick delivery
   (``inbox[p, dst, src] = outbox[p, src, dst]``) moves each node's outgoing
   rows to the shard that holds the destination node: the **all_to_all over
   'n'** (:func:`_all_to_all_n`), one per tick. Vote tallies and quorum
   commit stay on the shard of the candidate or leader.

2. **The sharded engine path** (everything from :func:`mesh_shards` on):
   ``RaftEngine(mesh=...)`` keeps its state, member mask, routed inbox
   planes, payload rings and lease plane as :class:`Shards`, one block per
   'p' shard of the engine's 1-axis ('p',) mesh. Per tick each shard
   gathers its own scheduled rows (:class:`ShardPlan`, bucketed on the
   power-of-eight ladder of :func:`shard_bucket`), steps them, decays the
   rest and scatters back (:func:`make_sharded_active_window`); the route
   fabric, the payload ring and the lease plane write their own shard only
   (a routed row's group and its plane row are one group id). The one
   cross-shard value is the **psum lane** (:func:`_psum`): the cluster's
   wake-row total, one int32 per shard, summed on the device and appended
   to every shard's flat output.

Where JAX drops an out-of-range scatter index (``mode="drop"``, a bucket's
padding id ``L``) or clamps a gather, the port sends padding to a dump row
that is sliced off, clamps it, or drops it on the host before the upload:
no out-of-range index reaches a device.

:class:`Shards` and :class:`Grid` hold the blocks; ``np.asarray`` of either
assembles the global array on the host, for tests and recovery only.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from josefine_tpu_torch.models import chained_raft as cr
from josefine_tpu_torch.models.types import Metrics, Msgs, NodeState, StepParams

_I32 = torch.int32


class Mesh:
    """Named axes over an array of torch devices: the port's stand-in for
    ``jax.sharding.Mesh``. ``devices`` is an object ndarray of
    ``torch.device``, ``axis_names`` a tuple and ``shape`` a dict of axis
    sizes. Hashable, so the program builders below are cached per mesh."""

    def __init__(self, devices, axis_names):
        names = tuple(axis_names)
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(names):
            raise ValueError(f"a mesh of rank {arr.ndim} cannot take axes {names}")
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [torch.device(d) for d in arr.flat]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = names
        self.shape = dict(zip(names, arr.shape))
        self._key = (names, arr.shape, tuple(str(d) for d in flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {describe_devices(self.devices.flat)})"


def describe_devices(devices) -> str:
    """``"cuda:0 x8"`` for one device repeated, ``"cuda:0..7"`` for a run of
    distinct cards, else the devices in order."""
    names = [str(d) for d in devices]
    if len(set(names)) == 1:
        return f"{names[0]} x{len(names)}"
    devs = [torch.device(d) for d in devices]
    if (all(d.type == "cuda" for d in devs)
            and [d.index for d in devs] == list(range(devs[0].index, devs[0].index + len(devs)))):
        return f"cuda:{devs[0].index}..{devs[-1].index}"
    return ",".join(names)


def make_mesh(n_p: int, n_n: int = 1, devices=None) -> Mesh:
    """A (n_p, n_n) mesh with axes ('p', 'n'). With no ``devices``, the
    first n_p * n_n cards, each used once; too few raise. An explicit list
    may repeat a device (k shards of the host, or of one card)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if len(devices) < n_p * n_n:
        raise ValueError(f"need {n_p * n_n} devices, have {len(devices)}")
    arr = np.empty(n_p * n_n, dtype=object)
    arr[:] = [torch.device(d) for d in devices[: n_p * n_n]]
    return Mesh(arr.reshape(n_p, n_n), ("p", "n"))


# --------------------------------------------------------------------------
# Blocks of a sharded array.


class Shards:
    """A global array split along ``axis`` into equal blocks, one per 'p'
    shard: block s holds indices [s*L, (s+1)*L) of that axis, on shard s's
    device. A program reads ``parts[s]`` alone. Writes that replace a block
    (:meth:`set_row`) build a new tensor for that block and share the others.
    ``np.asarray(shards)`` assembles the global array on the host: for tests
    and recovery, never the per-tick path."""

    __slots__ = ("parts", "axis")

    def __init__(self, parts, axis: int = 0):
        self.parts = list(parts)
        self.axis = axis

    @classmethod
    def split(cls, a, devices, axis: int = 0) -> "Shards":
        """Split a host array or a tensor into ``len(devices)`` equal blocks
        along ``axis``, block s copied onto ``devices[s]``."""
        from josefine_tpu_torch.raft.hostio import host_to

        S = len(devices)
        n = a.shape[axis]
        if n % S:
            raise ValueError(f"axis of {n} does not split into {S} shards")
        L = n // S
        parts = []
        for s, dev in enumerate(devices):
            if isinstance(a, torch.Tensor):
                parts.append(a.narrow(axis, s * L, L).to(dev, copy=True))
            else:
                cut = (slice(None),) * axis + (slice(s * L, (s + 1) * L),)
                parts.append(host_to(a[cut], dev))
        return cls(parts, axis)

    @property
    def rows(self) -> int:
        """Length of one block along the sharded axis."""
        return self.parts[0].shape[self.axis]

    def set_row(self, g: int, v) -> "Shards":
        """``a[g] = v`` (axis 0) on a copy of the owning shard's block."""
        s, r = divmod(int(g), self.rows)
        parts = list(self.parts)
        y = parts[s].clone()
        y[r] = v
        parts[s] = y
        return Shards(parts, self.axis)

    def __array__(self, dtype=None, copy=None):
        a = np.concatenate([p.detach().cpu().numpy() for p in self.parts], axis=self.axis)
        return a if dtype is None else a.astype(dtype)


class Grid:
    """A (P, N[, N]) array over a ('p', 'n') mesh, for the cluster-step
    simulation: block [i][j], on ``mesh.devices[i, j]``, holds rows
    [i*pl, (i+1)*pl) and node slots [j*nl, (j+1)*nl) of axis 1; with
    ``n_split`` False every j holds all N slots (the member mask, which JAX
    places as ('p', None)). ``np.asarray`` assembles it on the host."""

    __slots__ = ("blocks", "n_split")

    def __init__(self, blocks, n_split: bool = True):
        self.blocks = [list(row) for row in blocks]
        self.n_split = n_split

    def __array__(self, dtype=None, copy=None):
        rows = []
        for row in self.blocks:
            parts = [b.detach().cpu().numpy() for b in row]
            rows.append(np.concatenate(parts, axis=1) if self.n_split else parts[0])
        a = np.concatenate(rows, axis=0)
        return a if dtype is None else a.astype(dtype)


def shard_of(tree, s: int):
    """Shard ``s``'s view of a struct (NodeState, Msgs) of :class:`Shards`."""
    return type(tree).from_leaves([leaf.parts[s] for leaf in tree.leaves()])


def join_shards(trees):
    """The inverse of :func:`shard_of`: per-shard structs -> one struct of
    :class:`Shards` (axis 0)."""
    return type(trees[0]).from_leaves(
        [Shards(list(blocks)) for blocks in zip(*(t.leaves() for t in trees))])


def _params_on(params: StepParams, devices) -> dict:
    """The step params copied once onto each distinct device."""
    out = {}
    for d in devices:
        if str(d) not in out:
            out[str(d)] = StepParams.from_leaves([t.to(d) for t in params.leaves()])
    return out


# --------------------------------------------------------------------------
# The cluster-step simulation over a ('p', 'n') mesh.


def state_spec(tree):
    """Per-leaf specs, as the JAX package's: (P, N) leaves shard over
    ('p', 'n'), (P, N, N) leaves shard the first (dst) node axis only."""
    def spec(a):
        if a.ndim == 2:
            return ("p", "n")
        if a.ndim == 3:
            return ("p", "n", None)
        raise ValueError(f"unexpected leaf rank {a.ndim}")

    if isinstance(tree, torch.Tensor):
        return spec(tree)
    return type(tree).from_leaves([spec(a) for a in tree.leaves()])


def _place_leaf(a: torch.Tensor, mesh: Mesh, spec) -> Grid:
    devs = mesh.devices
    n_p, n_n = devs.shape
    if spec[0] != "p" or a.shape[0] % n_p:
        raise ValueError(f"cannot place a leaf of shape {tuple(a.shape)} as {spec}")
    pl = a.shape[0] // n_p
    n_split = len(spec) > 1 and spec[1] == "n"
    nl = a.shape[1] // n_n if n_split else 0
    blocks = []
    for i in range(n_p):
        rows = a[i * pl:(i + 1) * pl]
        blocks.append([(rows[:, j * nl:(j + 1) * nl] if n_split else rows).to(
            devs[i, j], copy=True) for j in range(n_n)])
    return Grid(blocks, n_split)


def place(tree, mesh: Mesh, spec=None):
    """Split a tensor or a struct of tensors over ``mesh`` by ``spec`` (a
    tuple of axis names per tensor dimension, or a struct of them; default
    :func:`state_spec`): each leaf becomes a :class:`Grid`."""
    spec = state_spec(tree) if spec is None else spec
    if isinstance(tree, torch.Tensor):
        return _place_leaf(tree, mesh, spec)
    specs = spec.leaves() if hasattr(spec, "leaves") else spec
    return type(tree).from_leaves([_place_leaf(a, mesh, s)
                                   for a, s in zip(tree.leaves(), specs)])


def _all_to_all_n(outs, devices, nl: int):
    """The per-tick all_to_all over 'n': ``outs[i][j]`` is shard (i, j)'s
    (pl, nl_src, N_dst) outbox leaf. Chunk k of the dst axis moves to shard
    (i, k), the chunks are joined along src, and (src, dst) swap: shard
    (i, k) gets its (pl, nl_dst, N_src) inbox."""
    n_p, ns = len(outs), len(outs[0])
    blocks = []
    for i in range(n_p):
        row = []
        for k in range(ns):
            dev = devices[i, k]
            parts = [outs[i][j][:, :, k * nl:(k + 1) * nl].to(dev) for j in range(ns)]
            row.append(torch.cat(parts, dim=1).transpose(1, 2).contiguous())
        blocks.append(row)
    return Grid(blocks)


def make_sharded_cluster_step(mesh: Mesh, N: int):
    """A step with ``cluster_step`` semantics over ``mesh``:
    ``(params, member, state, inbox, proposals) -> (state', inbox',
    metrics)``, every argument and result but ``params`` placed as
    :class:`Grid` (:func:`place`; ``member`` as ('p', None)). Shard (i, j)
    runs the port's ``node_step`` over its ``nl = N / n_shards`` local nodes
    (``me = j * nl + arange(nl)``); delivery is :func:`_all_to_all_n`."""
    ns = mesh.shape["n"]
    if N % ns:
        raise ValueError(f"node count {N} not divisible by node shards {ns}")
    nl = N // ns
    devs = mesh.devices
    n_p = devs.shape[0]
    me_cache: dict = {}

    def me_of(i, j):
        key = (i, j)
        if key not in me_cache:
            me_cache[key] = torch.arange(j * nl, (j + 1) * nl, dtype=torch.int64,
                                         device=devs[i, j])
        return me_cache[key]

    def step(params, member, state, inbox, proposals):
        on = _params_on(params, devs.flat)
        sts = [[None] * ns for _ in range(n_p)]
        outs = [[None] * ns for _ in range(n_p)]
        mets = [[None] * ns for _ in range(n_p)]
        for i in range(n_p):
            for j in range(ns):
                blk = lambda t: type(t).from_leaves([g.blocks[i][j] for g in t.leaves()])
                sts[i][j], outs[i][j], mets[i][j] = cr.node_step(
                    on[str(devs[i, j])], member.blocks[i][j], blk(state), blk(inbox),
                    proposals.blocks[i][j], None, me=me_of(i, j))

        def grid(structs, cls):
            leaves = [[s.leaves() for s in row] for row in structs]
            return cls.from_leaves([Grid([[leaves[i][j][f] for j in range(ns)]
                                          for i in range(n_p)])
                                    for f in range(len(leaves[0][0]))])

        n_msg = len(outs[0][0].leaves())
        inbox2 = Msgs.from_leaves([
            _all_to_all_n([[outs[i][j].leaves()[f] for j in range(ns)] for i in range(n_p)],
                          devs, nl) for f in range(n_msg)])
        return grid(sts, NodeState), inbox2, grid(mets, Metrics)

    return step


# --------------------------------------------------------------------------
# The sharded engine path: shard-local active-set stepping and route, ring
# and lease-plane writes for RaftEngine(mesh=...). The builders are cached on
# (mesh, static ints) as the JAX package's are; torch compiles nothing, so
# the cache bounds only the closures.


def mesh_shards(mesh: Mesh) -> int:
    """Partition-shard count of an engine mesh: the size of the 'p' axis
    (JAX's shard_map splits over 'p' alone and replicates any other axis;
    counting every device of a multi-axis mesh would mis-bin the per-shard
    local ids). Falls back to the device count for a mesh without 'p'."""
    if "p" in mesh.shape:
        return int(mesh.shape["p"])
    return int(np.prod(list(mesh.shape.values())))


def shard_devices(mesh: Mesh) -> list[torch.device]:
    """The device of each 'p' shard: along 'p' at index 0 of every other
    axis (JAX keeps a copy on each device of those axes; the port keeps
    one), or every device in order for a mesh without 'p'."""
    if "p" in mesh.shape:
        ax = mesh.axis_names.index("p")
        arr = np.moveaxis(mesh.devices, ax, 0).reshape(mesh.shape["p"], -1)
        return list(arr[:, 0])
    return list(mesh.devices.flat)


def shard_bucket(n: int, L: int) -> int:
    """Per-shard compact bucket: powers of EIGHT from a floor of 64, clamped
    to the shard-local row count ``L = P / shards``, as in the JAX package
    (whose every level is a compile of the S-way program). The bucket sets
    the layout of each shard's flat output."""
    b = 64
    while b < n:
        b *= 8
    return min(b, L) if L >= 64 else L


def place_engine_state(tree, mesh: Mesh):
    """Split an engine-layout struct (every leaf's axis 0 is the partition
    axis) into per-shard blocks on the mesh's shard devices."""
    devs = shard_devices(mesh)
    return type(tree).from_leaves([Shards.split(a, devs) for a in tree.leaves()])


class ShardPlan:
    """Partition one tick's scheduled active set across the 'p' shards.

    ``G`` is the scheduler's sorted global row-id vector; with
    ``L = P / S`` rows per shard, shard ``s`` owns ``G`` entries in
    ``[s*L, (s+1)*L)``, a contiguous run because ``G`` is sorted. The plan
    holds the per-shard LOCAL index bucket (``idx``, ``(S, k)`` padded with
    ``L``), the uniform bucket ``k`` (:func:`shard_bucket` of the largest
    shard's count: every shard's flat output has the same layout), and the
    coordinates that remap a compact host-built inbox shard-major."""

    def __init__(self, G: np.ndarray, P_total: int, S: int):
        L = P_total // S
        self.S, self.L = S, L
        self.A = len(G)
        self.k, self.idx, self.shard, self.pos = split_shard_rows(G, S, L)
        self.counts = np.bincount(self.shard, minlength=S).astype(np.int64)

    def scatter_vals(self, vals: np.ndarray) -> np.ndarray:
        """(10, A, N) compact host inbox (rows in G order) -> the
        (S, 10, k, N) shard-major bucket the sharded step consumes."""
        rows, _, N = vals.shape[0], vals.shape[1], vals.shape[2]
        out = np.zeros((self.S, rows, self.k, N), np.int32)
        if self.A:
            out[self.shard, :, self.pos, :] = vals[:, :self.A, :].transpose(1, 0, 2)
        return out

    def gather_flat(self, flat_np: np.ndarray, N: int):
        """Per-shard flat fetches (S, 13k + 9kN + 1) -> the compact (13, A)
        mirror and (9, A, N) outbox in G order, plus the psum lane's
        cluster wake total (the same on every shard)."""
        k = self.k
        cut = 13 * k
        sv_parts, ov_parts = [], []
        for s in range(self.S):
            A_s = int(self.counts[s])
            if not A_s:
                continue
            row = flat_np[s]
            sv_parts.append(row[:cut].reshape(13, k)[:, :A_s])
            ov_parts.append(row[cut:cut + 9 * k * N].reshape(9, k, N)[:, :A_s, :])
        if sv_parts:
            sv13 = np.concatenate(sv_parts, axis=1).astype(np.int64)
            ov = np.concatenate(ov_parts, axis=1)
        else:
            sv13 = np.zeros((13, 0), np.int64)
            ov = np.zeros((9, 0, N), np.int32)
        total = int(flat_np[0, -1]) if len(flat_np) else 0
        return sv13, ov, total


def split_shard_rows(gids: np.ndarray, S: int, L: int, cap: int | None = None):
    """Per-shard padded LOCAL id layout for an arbitrary (unsorted is fine)
    global id vector: returns ``(B, (S, B) local ids padded L, shard,
    pos)``. ``B`` is :func:`shard_bucket` of the fullest shard (``cap``
    overrides the clamp bound: the payload ring's slot count multiplies
    it)."""
    gids = np.asarray(gids, np.int64)
    shard = gids // L
    counts = np.bincount(shard, minlength=S)
    B = shard_bucket(int(counts.max()) if len(gids) else 0, L if cap is None else cap)
    order = np.argsort(shard, kind="stable")
    starts = np.zeros(S, np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    pos = np.empty(len(gids), np.int64)
    pos[order] = np.arange(len(gids)) - starts[shard[order]]
    lids = np.full((S, B), L, np.int32)
    if len(gids):
        lids[shard, pos] = (gids % L).astype(np.int32)
    return B, lids, shard, pos


def _psum(values, devices) -> list[torch.Tensor]:
    """The psum lane over 'p': one int32 per shard, added up on the first
    shard's device, the total handed back to every shard's device. The sum
    stays on the devices: nothing here waits for one."""
    total = values[0]
    for v in values[1:]:
        total = total + v.to(devices[0], non_blocking=True)
    return [total.to(d, non_blocking=True) for d in devices]


@functools.lru_cache(maxsize=None)
def make_sharded_active_window(mesh: Mesh, k: int, ticks: int, N: int, routed: bool):
    """The shard-local compacted window step: per 'p' shard, gather the
    scheduled local rows into the ``k`` bucket, run the same tick-1 +
    quiet-ticks window as the unsharded compact path, advance every local
    row through ``decay_idle`` and scatter the stepped rows back (the
    bucket's padding ids land in a dump row). Each shard's flat output ends
    with the psum lane (:func:`_psum`) of the scheduled row count.

    ``fn(params, member, me, state, vals, pf, idx[, plane])``: ``params``,
    ``me``, ``pf`` lists with one copy per shard (on its device);
    ``member`` and ``state`` as :class:`Shards`; ``vals`` per-shard (10, k,
    N) tensors; ``idx`` per-shard (k,) int64 local ids padded with ``L``;
    ``plane`` the routed (9, P, N) plane as :class:`Shards` along axis 1.
    Returns ``(state', [per-shard flat (13k + 9kN + 1,)])``."""
    from josefine_tpu_torch.raft.packed_step import (
        _active_outputs,
        _gather_routed,
        _merge_routed,
        _msgs_from_packed,
        _scan_quiet_ticks,
        _scatter_rows,
        _step_node,
    )

    devs = shard_devices(mesh)

    def fn(params, member, me, state, vals, pf, idx, plane=None):
        if routed != (plane is not None):
            raise ValueError("the routed step needs exactly one routed plane")
        fulls, flats, counts = [], [], []
        for s in range(len(devs)):
            st_l, mem_l, i = shard_of(state, s), member.parts[s], idx[s]
            L = mem_l.shape[0]
            cidx = i.clamp(max=L - 1)
            st_c = NodeState.from_leaves([a[cidx] for a in st_l.leaves()])
            mem_c = mem_l[cidx]
            in10 = vals[s]
            if routed:
                in10 = _merge_routed(torch, in10, _gather_routed(plane.parts[s], i))
            inbox = _msgs_from_packed(in10)
            props = in10[9, :, 0]
            st, out, met = _step_node(params[s], mem_c, me[s], st_c, inbox, props, pf[s])
            st, out, met = _scan_quiet_ticks(params[s], mem_c, me[s], st, out, met,
                                             inbox, props, pf[s], ticks)
            full = cr.decay_idle(params[s], st_l, pf[s], ticks)
            fulls.append(NodeState.from_leaves(
                [_scatter_rows(f, i, r) for f, r in zip(full.leaves(), st.leaves())]))
            flats.append(_active_outputs(st, out, met))
            counts.append((i < L).sum(dtype=_I32))
        totals = _psum(counts, devs)
        return join_shards(fulls), [torch.cat([f, t.reshape(1)])
                                    for f, t in zip(flats, totals)]

    return fn


@functools.lru_cache(maxsize=None)
def make_sharded_decay_only(mesh: Mesh, ticks: int):
    """All-quiescent sharded tick: decay is the whole step, per shard.
    ``fn(params, state, pf)`` with per-shard ``params``/``pf`` lists."""
    S = mesh_shards(mesh)

    def fn(params, state, pf):
        return join_shards([cr.decay_idle(params[s], shard_of(state, s), pf[s], ticks)
                            for s in range(S)])

    return fn


def _local_rows(lids_s: np.ndarray, L: int) -> np.ndarray:
    """A shard's padded local id row less its padding (ids == L), as the
    host drops it before the upload."""
    return np.nonzero(np.asarray(lids_s) < L)[0]


@functools.lru_cache(maxsize=None)
def make_sharded_route_scatter(mesh: Mesh, B: int, P_total: int, N: int, new_plane: bool):
    """Shard-local routed-row scatter into a co-sharded staged inbox plane
    (:class:`Shards` of (9, L, N) along axis 1). Mesh fabrics push host-built
    value columns: ``vals (S, 9, B)``, ``lids (S, B)`` local group ids
    padded ``L`` (dropped on the host), ``me`` the sender's inbox column. A
    routed row's source group and its plane row are one group id, so the
    scatter stays in its shard. ``new_plane``: ``fn(vals, lids, me)`` makes
    a zero plane first; else ``fn(plane, vals, lids, me)`` writes ``plane``
    in place (a staged plane no dispatch has read yet)."""
    from josefine_tpu_torch.raft.hostio import host_to
    from josefine_tpu_torch.raft.packed_step import _route_scatter_vals

    devs = shard_devices(mesh)
    L = P_total // len(devs)

    def scatter(plane, vals, lids, me):
        for s, dev in enumerate(devs):
            sel = _local_rows(lids[s], L)
            if len(sel):
                _route_scatter_vals(plane.parts[s], host_to(np.asarray(vals[s])[:, sel], dev),
                                    host_to(np.asarray(lids[s])[sel].astype(np.int64), dev),
                                    int(me))
        return plane

    if new_plane:
        def fresh(vals, lids, me):
            plane = Shards([torch.zeros((9, L, N), dtype=_I32, device=d) for d in devs],
                           axis=1)
            return scatter(plane, vals, lids, me)

        return fresh
    return scatter


@functools.lru_cache(maxsize=None)
def make_sharded_ring_scatter(mesh: Mesh, B: int):
    """Shard-local payload-ring stage scatter, in place: ``buf`` the
    (P, S_slots, W) ring as :class:`Shards`, ``lgids (S, B)`` local group
    ids padded ``L`` (dropped on the host), ``slots (S, B)``, ``words (S,
    B, W)``."""
    from josefine_tpu_torch.raft.hostio import host_to
    from josefine_tpu_torch.raft.packed_step import _ring_scatter

    devs = shard_devices(mesh)

    def fn(buf, lgids, slots, words):
        L = buf.rows
        for s, dev in enumerate(devs):
            sel = _local_rows(lgids[s], L)
            if len(sel):
                _ring_scatter(buf.parts[s],
                              host_to(np.asarray(lgids[s])[sel].astype(np.int64), dev),
                              host_to(np.asarray(slots[s])[sel].astype(np.int64), dev),
                              host_to(np.asarray(words[s])[sel], dev))
        return buf

    return fn


@functools.lru_cache(maxsize=None)
def make_sharded_ring_gather(mesh: Mesh, B: int):
    """Shard-local payload-ring gather: per-shard (B, W) slot reads, the
    padding ids clamped to the shard's last row (the host picks the real
    rows by (shard, pos))."""
    from josefine_tpu_torch.raft.hostio import host_to
    from josefine_tpu_torch.raft.packed_step import _ring_gather

    devs = shard_devices(mesh)

    def fn(buf, lgids, slots):
        L = buf.rows
        return [_ring_gather(buf.parts[s],
                             host_to(np.minimum(np.asarray(lgids[s]), L - 1).astype(np.int64),
                                     dev),
                             host_to(np.asarray(slots[s]).astype(np.int64), dev))
                for s, dev in enumerate(devs)]

    return fn


def purge_plane_row_masked(plane: Shards, g: int, keep_mask) -> Shards:
    """Zero group ``g``'s routed slots where ``keep_mask`` (N,) is False, in
    the one shard that owns row ``g`` (in place, as the unsharded purge):
    nothing crosses shards."""
    from josefine_tpu_torch.raft.hostio import host_to
    from josefine_tpu_torch.raft.packed_step import _purge_plane_row_fn

    s, r = divmod(int(g), plane.rows)
    cols = np.nonzero(~np.asarray(keep_mask, bool))[0]
    if len(cols):
        part = plane.parts[s]
        _purge_plane_row_fn(part, r, host_to(cols.astype(np.int64), part.device))
    return plane


def place_lease_plane(mesh: Mesh, plane_np) -> Shards:
    """The (P, 3) lease mirror plane [holder, expiry, term] co-sharded with
    the engine state on 'p': a row and its lease live on one shard."""
    return Shards.split(np.asarray(plane_np), shard_devices(mesh))


def lease_plane_select(plane: Shards, changed_mask, vals) -> Shards:
    """Refresh the rows of the (P, 3) lease plane where ``changed_mask``
    (P,) is True with the matching rows of ``vals`` (P, 3), shard by shard
    as a masked select; a shard with no changed row keeps its block."""
    from josefine_tpu_torch.raft.hostio import host_to

    L = plane.rows
    mask = np.asarray(changed_mask, bool)
    vals = np.asarray(vals)
    parts = list(plane.parts)
    for s, part in enumerate(parts):
        m = mask[s * L:(s + 1) * L]
        if m.any():
            dev = part.device
            parts[s] = torch.where(host_to(m, dev)[:, None],
                                   host_to(vals[s * L:(s + 1) * L], dev), part)
    return Shards(parts, plane.axis)
