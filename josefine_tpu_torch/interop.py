"""State across the package boundary: JAX leaves as numpy <-> torch structs.

The port's equivalent of a weight converter. The exchange medium is a list
of numpy arrays in ``jax.tree.leaves`` order (what ``[np.asarray(x) for x
in jax.tree.leaves(tree)]`` gives), so this module never imports JAX. The
one representation change is ``seed``: uint32 in the JAX package, int32
with the same bits here. Like the package's entry points, the converters
place their tensors on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from josefine_tpu_torch.models.types import Msgs, NodeState, StepParams, resolve_device

# Index of the seed leaf in NodeState.leaves() / jax.tree.leaves(NodeState).
_SEED = 12
# JAX dtype of each NodeState leaf, in leaf order.
_STATE_DTYPES = ([np.int32] * 11 + [np.bool_, np.uint32, np.bool_] + [np.int32] * 4)


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(dtype))).to(
        resolve_device(device))


def _numpy(t, dtype) -> np.ndarray:
    """A leaf on the host; a mesh engine's sharded leaf assembles its global
    array there."""
    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    if a.dtype != dtype:
        raise TypeError(f"leaf has dtype {a.dtype}, expected {np.dtype(dtype)}")
    return a


def state_from_numpy(leaves, device="cuda") -> NodeState:
    leaves = list(leaves)
    if len(leaves) != len(_STATE_DTYPES):
        raise ValueError(f"NodeState has {len(_STATE_DTYPES)} leaves, got {len(leaves)}")
    out = []
    for i, a in enumerate(leaves):
        if i == _SEED:
            out.append(_tensor(np.asarray(a, np.uint32).view(np.int32), np.int32, device))
        elif _STATE_DTYPES[i] is np.bool_:
            out.append(_tensor(a, np.bool_, device))
        else:
            out.append(_tensor(a, np.int32, device))
    return NodeState.from_leaves(out)


def state_to_numpy(state: NodeState) -> list[np.ndarray]:
    out = []
    for i, t in enumerate(state.leaves()):
        if i == _SEED:
            out.append(_numpy(t, np.int32).view(np.uint32))
        else:
            out.append(_numpy(t, _STATE_DTYPES[i]))
    return out


def msgs_from_numpy(leaves, device="cuda") -> Msgs:
    return Msgs.from_leaves([_tensor(a, np.int32, device) for a in leaves])


def msgs_to_numpy(msgs: Msgs) -> list[np.ndarray]:
    return [_numpy(t, np.int32) for t in msgs.leaves()]


def params_from_numpy(leaves, device="cuda") -> StepParams:
    return StepParams.from_leaves([_tensor(a, np.int32, device).reshape(()) for a in leaves])


def params_to_numpy(params: StepParams) -> list[np.ndarray]:
    return [_numpy(t, np.int32) for t in params.leaves()]


def member_from_numpy(member, device="cuda") -> torch.Tensor:
    """The (P, N) bool member mask."""
    return _tensor(member, np.bool_, device)


def member_to_numpy(member: torch.Tensor) -> np.ndarray:
    return _numpy(member, np.bool_)


def peer_fresh_from_numpy(peer_fresh, device="cuda") -> torch.Tensor | None:
    """The [N] keepalive flags (any int/bool array) as int32, or None."""
    return None if peer_fresh is None else _tensor(peer_fresh, np.int32, device)
