"""Shared helpers of the ``test_torch_*`` suites: move JAX structs into the
PyTorch port through ``josefine_tpu_torch.interop``, compare leaves
exactly, and draw random states and message soups from numpy seeds.

Every comparison is exact integer equality: all leaves are int32, bool or
uint32 bit patterns.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from josefine_tpu.models import chained_raft as jcr
from josefine_tpu_torch import interop

STATE_NAMES = ("term", "voted_for", "role", "leader", "head.t", "head.s", "commit.t",
               "commit.s", "elapsed", "timeout", "hb_elapsed", "alive", "seed", "votes",
               "match.t", "match.s", "nxt.t", "nxt.s")
MSG_NAMES = ("kind", "term", "x.t", "x.s", "y.t", "y.s", "z.t", "z.s", "ok")
METRIC_NAMES = ("accepted_blocks", "accepted_msgs", "minted", "commit_delta",
                "became_leader")

# One jitted JAX step shared by every suite (no donation: the tests reuse
# their inputs).
jax_step = jax.jit(jcr.cluster_step_impl)
# The same step with XLA's fusion pass off. With it on, the CPU build's time
# per call (not its compile) grows about tenfold per node slot above N = 5,
# to tens of seconds at N = 8; with it off, a call at N = 16 takes about a
# millisecond. Integer results do not depend on fusion.
jax_step_unfused = jax.jit(jcr.cluster_step_impl,
                           compiler_options={"xla_disable_hlo_passes": "fusion"})


def np_leaves(tree) -> list[np.ndarray]:
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def to_jax(tree_like, leaves):
    """Rebuild a JAX struct shaped like ``tree_like`` from numpy leaves."""
    return jax.tree.unflatten(jax.tree.structure(tree_like),
                              [jnp.asarray(a) for a in leaves])


def torch_params(params):
    return interop.params_from_numpy(np_leaves(params), device="cpu")


def torch_state(state):
    return interop.state_from_numpy(np_leaves(state), device="cpu")


def torch_msgs(msgs):
    return interop.msgs_from_numpy(np_leaves(msgs), device="cpu")


def torch_member(member):
    return interop.member_from_numpy(np.asarray(member), device="cpu")


def assert_leaves_equal(got: list[np.ndarray], want: list[np.ndarray], names, what):
    assert len(got) == len(want), what
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype, f"{what} {name}: dtype {a.dtype} != {b.dtype}"
        if not np.array_equal(a, b):
            at = tuple(np.argwhere(a != b)[0])
            raise AssertionError(f"{what} {name} differs at {at}: port {a[at]} jax {b[at]}")


def assert_state_equal(tstate, jstate, what="state"):
    assert_leaves_equal(interop.state_to_numpy(tstate), np_leaves(jstate), STATE_NAMES, what)


def assert_msgs_equal(tmsgs, jmsgs, what="inbox"):
    assert_leaves_equal(interop.msgs_to_numpy(tmsgs), np_leaves(jmsgs), MSG_NAMES, what)


def assert_metrics_equal(tmet, jmet, what="metrics"):
    got = [t.numpy() for t in tmet.leaves()]
    assert_leaves_equal(got, np_leaves(jmet), METRIC_NAMES, what)


def random_state_leaves(rng: np.random.Generator, P: int, N: int) -> list[np.ndarray]:
    """An arbitrary (not necessarily reachable) NodeState in JAX leaf order,
    with small value ranges so ids and terms collide often."""
    i32 = lambda lo, hi, shape: rng.integers(lo, hi, shape).astype(np.int32)
    pn, pnn = (P, N), (P, N, N)
    return [
        i32(0, 6, pn), i32(-1, N, pn), i32(0, 4, pn), i32(-1, N, pn),
        i32(0, 4, pn), i32(0, 10, pn), i32(0, 4, pn), i32(0, 10, pn),
        i32(0, 12, pn), i32(3, 9, pn), i32(0, 40, pn),
        rng.random(pn) < 0.85,
        rng.integers(0, 2**32, pn, dtype=np.uint64).astype(np.uint32),
        rng.random(pnn) < 0.5,
        i32(0, 4, pnn), i32(0, 10, pnn), i32(0, 4, pnn), i32(0, 10, pnn),
    ]


def random_inbox_leaves(rng: np.random.Generator, P: int, N: int) -> list[np.ndarray]:
    """A random message soup, Msgs leaf order, every kind equally likely."""
    i32 = lambda lo, hi: rng.integers(lo, hi, (P, N, N)).astype(np.int32)
    return [i32(0, 7), i32(0, 7), i32(0, 4), i32(0, 10), i32(0, 4), i32(0, 12),
            i32(0, 4), i32(0, 10), i32(0, 2)]
