"""Fused multi-tick window of the batched Chained-Raft step.

:func:`run_ticks_fused` runs ``ticks`` lockstep cluster ticks in one launch
of the hand-written Hopper kernel (``csrc/fused_step.cu``), which keeps every
group's state and in-flight inbox on chip for the whole window and touches
device memory twice. It replaces the JAX package's Pallas kernel
(``josefine_tpu/ops/pallas_step.py``) with the same contract.

Dispatch is by the tensors' device and nothing else: CPU tensors take the
plain version :func:`run_ticks_fused_ref` (a loop over
``chained_raft.cluster_step``); CUDA tensors launch the kernel, and a
kernel that cannot be built or launched raises. ``launches`` counts kernel
launches, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from josefine_tpu_torch.models import chained_raft as cr
from josefine_tpu_torch.models.types import METRIC_FIELDS, Msgs, NodeState, StepParams
from josefine_tpu_torch.ops import _build

MAX_N = 16            # the config cap on group size; the kernel is instantiated for 1..16
DEFAULT_TILE = 24     # groups per block: 4 warps of 6 groups at N = 5
MAX_WARPS = 8         # the kernel's __launch_bounds__: 256 threads per block
_SMEM_MAX = 232_448   # shared memory one Hopper block may use
_N_STATE = 18
_N_INBOX = 9
_BOOL_LEAVES = (11, 13)  # alive, votes: bool, one byte, read and written as such

launches = 0
_kernel_info: dict[tuple[int, int], dict[str, int]] = {}


def _totals(per_tick: cr.Metrics) -> dict[str, int]:
    return {f: int(getattr(per_tick, f).to(torch.int64).sum()) for f in METRIC_FIELDS}


def run_ticks_fused_ref(params: StepParams, member: torch.Tensor, state: NodeState,
                        inbox: Msgs, proposals: torch.Tensor, ticks: int,
                        peer_fresh=None):
    """The plain version: ``ticks`` calls of ``cluster_step``, on any device.
    Returns (state, inbox, totals) like :func:`run_ticks_fused`."""
    state, inbox, per_tick = cr.run_ticks(params, member, state, inbox, proposals,
                                          ticks, peer_fresh)
    return state, inbox, _totals(per_tick)


def groups_per_warp(n: int) -> int:
    """Whole groups in one warp of the kernel: ``32 // n``."""
    return 32 // n


def mailbox_bytes_per_warp(n: int) -> int:
    """Shared memory of one warp's double-buffered mailbox."""
    return 2 * _N_INBOX * groups_per_warp(n) * n * n * 4


def warps_per_block(n: int, tile: int) -> int:
    """The block's warp count: ``tile`` groups rounded up to whole warps,
    cut to what one block may hold (threads and shared memory)."""
    want = -(-max(1, int(tile)) // groups_per_warp(n))
    return max(1, min(want, MAX_WARPS, _SMEM_MAX // mailbox_bytes_per_warp(n)))


def kernel_info(n: int, tile: int = DEFAULT_TILE) -> dict[str, int]:
    """The compiled kernel's resources for group size ``n`` at the block
    shape ``tile`` gives: registers and local (spill) bytes per thread, max
    threads and dynamic shared bytes per block, and resident blocks and
    warps per SM from CUDA's occupancy calculator."""
    w = warps_per_block(n, tile)
    if (n, w) not in _kernel_info:
        out = (ctypes.c_int * 5)()
        lib = _build.load_cuda()
        _check(lib, lib.josefine_fused_kernel_info(n, w, out))
        regs, max_threads, local, smem, blocks = out
        _kernel_info[(n, w)] = {
            "registers": regs, "max_threads": max_threads, "local_bytes": local,
            "smem_bytes_per_block": smem, "warps_per_block": w,
            "resident_blocks_per_sm": blocks, "resident_warps_per_sm": blocks * w}
    return _kernel_info[(n, w)]


def _check(lib, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(
            f"fused window kernel failed: {lib.josefine_cuda_error_string(rc).decode()}")


def run_ticks_fused(params: StepParams, member: torch.Tensor, state: NodeState,
                    inbox: Msgs, proposals: torch.Tensor, ticks: int,
                    tile: int = DEFAULT_TILE, peer_fresh=None):
    """Run ``ticks`` lockstep ticks in one fused window.

    Same contract as the JAX package's ``run_ticks_fused``: ``proposals``
    are re-offered every tick, the optional ``peer_fresh`` [N] keepalive
    flags hold for the whole window, inputs and outputs use the (P, ...)
    layout, and the metrics come back as a dict of window totals (Python
    ints, summed in int64): ``accepted_blocks, accepted_msgs, minted,
    commit_delta, became_leader``. ``tile`` is the kernel's groups per
    block, rounded up to whole warps of ``32 // N`` groups: a tuning knob
    with no effect on the result. Returns
    (state, inbox, totals).
    """
    if member.device.type == "cpu":
        return run_ticks_fused_ref(params, member, state, inbox, proposals, ticks,
                                   peer_fresh)
    if member.device.type != "cuda":
        raise ValueError(f"run_ticks_fused: unsupported device {member.device}")
    return _run_kernel(params, member, state, inbox, proposals, int(ticks), tile,
                       peer_fresh)


def _shape(member: torch.Tensor) -> tuple[int, int]:
    P, N = member.shape
    if not 1 <= N <= MAX_N:
        raise ValueError(f"group size {N} is outside 1..{MAX_N}")
    return P, N


def _marshal(params, member, state, inbox, proposals, ticks, peer_fresh, warps):
    """The C interface's arguments: contiguous leaves in their own dtypes
    (int32; alive, votes and member bool), outputs and per-warp partials
    allocated, pointer and param arrays built."""
    P, N = _shape(member)
    dev = member.device
    leaves = state.leaves() + inbox.leaves() + [member, proposals]
    bools = set(_BOOL_LEAVES) | {len(leaves) - 2}
    leaves = [t.to(torch.bool if i in bools else torch.int32).contiguous()
              for i, t in enumerate(leaves)]
    for i, t in enumerate(leaves):
        want = (P, N, N) if 13 <= i < _N_STATE + _N_INBOX else (P, N)
        if t.device != dev or tuple(t.shape) != want:
            raise ValueError(f"leaf {i}: {tuple(t.shape)} on {t.device}, "
                             f"expected {want} on {dev}")
    leaves, (member_c, props_c) = leaves[:-2], leaves[-2:]
    # The params and flags stay on the device: the kernel reads them there,
    # so a launch waits on no copy to the host.
    prm = [t.to(dev, torch.int32).contiguous() for t in params.leaves()]
    pf = None if peer_fresh is None else (
        torch.as_tensor(peer_fresh).to(dev, torch.int32).reshape(N).contiguous())
    outs = [torch.empty_like(t) for t in leaves]
    G = groups_per_warp(N)
    partials = torch.empty(((P + G - 1) // G, len(METRIC_FIELDS)), dtype=torch.int32,
                           device=dev)
    c_args = (N, P, int(ticks), warps,
              (ctypes.c_void_p * len(prm))(*[t.data_ptr() for t in prm]),
              None if pf is None else pf.data_ptr(),
              (ctypes.c_void_p * len(leaves))(*[t.data_ptr() for t in leaves]),
              (ctypes.c_void_p * len(outs))(*[t.data_ptr() for t in outs]),
              member_c.data_ptr(), props_c.data_ptr(), partials.data_ptr())
    # The inputs travel with the arguments: they must outlive the launch.
    return c_args, (leaves, member_c, props_c, prm, pf), outs, partials


def _unmarshal(outs, partials):
    tm = partials.sum(0, dtype=torch.int64).tolist()
    totals = {f: int(tm[i]) for i, f in enumerate(METRIC_FIELDS)}
    return (NodeState.from_leaves(outs[:_N_STATE]), Msgs.from_leaves(outs[_N_STATE:]),
            totals)


def run_ticks_fused_timed(params: StepParams, member: torch.Tensor, state: NodeState,
                          inbox: Msgs, proposals: torch.Tensor, ticks: int,
                          tile: int = DEFAULT_TILE, peer_fresh=None):
    """:func:`run_ticks_fused` on CUDA tensors that also times the kernel
    alone: CUDA events recorded around the launch, leaving out the wrapper's
    conversions and allocations. Returns (state, inbox, totals, kernel ms)."""
    if member.device.type != "cuda":
        raise ValueError("run_ticks_fused_timed times the kernel: it takes CUDA tensors")
    events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    out = _run_kernel(params, member, state, inbox, proposals, int(ticks), tile, peer_fresh,
                      events)
    events[1].synchronize()
    return (*out, events[0].elapsed_time(events[1]))


def _run_kernel(params, member, state, inbox, proposals, ticks, tile, peer_fresh,
                events=None):
    global launches
    if ticks < 0:
        raise ValueError("ticks must be >= 0")
    P, N = _shape(member)
    c_args, _keep, outs, partials = _marshal(params, member, state, inbox, proposals,
                                             ticks, peer_fresh, warps_per_block(N, tile))
    if P > 0:
        lib = _build.load_cuda()
        dev = member.device
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            if events:
                events[0].record(stream)
            rc = lib.josefine_fused_window(*c_args, stream.cuda_stream)
            if events:
                events[1].record(stream)
            _check(lib, rc)
        launches += 1
    return _unmarshal(outs, partials)


def run_ticks_fused_emulated(params: StepParams, member: torch.Tensor, state: NodeState,
                             inbox: Msgs, proposals: torch.Tensor, ticks: int,
                             tile: int = DEFAULT_TILE, peer_fresh=None):
    """The kernel's own tick body (``csrc/fused_step.cuh``) built by g++ and
    run on CPU tensors, warp by warp, with each warp's shared-memory mailbox
    emulated (``csrc/fused_step_host.cpp``). Not a dispatch path: it exists
    so the CPU tests can hold the hand-written body against the JAX package."""
    if member.device.type != "cpu":
        raise ValueError("run_ticks_fused_emulated takes CPU tensors")
    P, N = _shape(member)
    c_args, _keep, outs, partials = _marshal(params, member, state, inbox, proposals,
                                             ticks, peer_fresh, warps_per_block(N, tile))
    if _build.load_host().josefine_fused_window_host(*c_args) != 0:
        raise RuntimeError("host emulation rejected its arguments")
    return _unmarshal(outs, partials)
