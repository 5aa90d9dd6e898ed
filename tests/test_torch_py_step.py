"""PyTorch port, the scalar oracle: three-way equality.

``josefine_tpu_torch.models.py_step`` is the JAX package's scalar Python
engine with its imports pointed at the port. On arbitrary node views, message
soups, proposal counts and keepalive flags (numpy seeds), the port's
``py_node_over_groups`` must equal the JAX package's exactly, and both must
equal the port's batched ``node_step`` over the same node slot: state and
metrics exactly, outboxes in every cell that carries a message. A
``PyCluster`` run from ``init_state`` must equal ``cluster_step`` tick for
tick.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from josefine_tpu.models import py_step as jpy
from josefine_tpu.raft import packed_step as jps
from josefine_tpu_torch import interop
from josefine_tpu_torch.models import chained_raft as tcr
from josefine_tpu_torch.models import py_step as tpy
from josefine_tpu_torch.models.types import step_params
from josefine_tpu_torch.raft import packed_step as tps

from torch_parity import (
    METRIC_NAMES,
    MSG_NAMES,
    STATE_NAMES,
    assert_leaves_equal,
    jax_view_template,
    np_leaves,
    random_case,
    random_params,
    to_jax,
    torch_params,
)


def _np(leaves):
    return [t.numpy() for t in leaves]


@pytest.mark.parametrize("N", [3, 5])
def test_oracle_matches_jax_oracle_and_node_step(N):
    rng = np.random.default_rng(40 + N)
    P = 10
    for me in range(N):
        for trial in range(3):
            params = random_params(rng)
            view, in10, member, pf = random_case(rng, P, N, me)
            what = f"N={N} me={me} trial {trial}"
            # JAX package oracle.
            jinbox = jps._msgs_from_packed(in10)
            jst, jout, jmet = jpy.py_node_over_groups(
                params, jnp.asarray(member), me, to_jax(jax_view_template(P, N, me), view),
                jinbox, in10[9, :, 0], pf)
            # Port oracle, from torch tensors.
            tp = torch_params(params)
            tview = interop.state_from_numpy(view, device="cpu")
            tinbox = tps._msgs_from_packed(torch.from_numpy(in10))
            pst, pout, pmet = tpy.py_node_over_groups(
                tp, torch.from_numpy(member), torch.tensor([me]), tview, tinbox,
                torch.from_numpy(in10[9, :, 0].copy()),
                None if pf is None else torch.from_numpy(pf))
            assert_leaves_equal(interop.state_to_numpy(pst), np_leaves(jst), STATE_NAMES, what)
            assert_leaves_equal(_np(pout.leaves()), np_leaves(jout), MSG_NAMES, what)
            assert_leaves_equal(_np(pmet.leaves()), np_leaves(jmet), METRIC_NAMES, what)
            # Port batched step over the same slot.
            bst, bout, bmet = tps._step_node(tp, torch.from_numpy(member), torch.tensor([me]),
                                             tview, tinbox, torch.from_numpy(in10[9, :, 0]),
                                             None if pf is None else torch.from_numpy(pf))
            assert_leaves_equal(interop.state_to_numpy(bst), interop.state_to_numpy(pst),
                                STATE_NAMES, what)
            assert_leaves_equal(_np(bmet.leaves()), _np(pmet.leaves()), METRIC_NAMES, what)
            sent = pout.kind != 0
            assert torch.equal(bout.kind, pout.kind), what
            for a, b in zip(bout.leaves(), pout.leaves()):
                assert torch.equal(a[sent], b[sent]), what


@pytest.mark.parametrize("prevote", [0, 1])
def test_py_cluster_matches_cluster_step(prevote):
    """A scalar ``PyCluster`` and the batched ``cluster_step`` from the same
    seed: every state leaf equal on every tick, under random proposals."""
    P, N, ticks = 4, 3, 40
    rng = np.random.default_rng(prevote)
    params = step_params(timeout_min=3, timeout_max=8, hb_ticks=1, prevote=prevote,
                         device="cpu")
    st, member = tcr.init_state(P, N, base_seed=7, params=params, device="cpu")
    inbox = tcr.empty_inbox(P, N, device="cpu")
    py = tpy.PyCluster(P, N, base_seed=7, tmin=3, tmax=8, hb_ticks=1, prevote=prevote)
    for tick in range(ticks):
        props = rng.integers(0, 2, (P, N)).astype(np.int32)
        st, inbox, _ = tcr.cluster_step(params, member, st, inbox, torch.from_numpy(props))
        py.step(props.tolist())
        got = interop.state_to_numpy(st)
        for name, leaf in zip(STATE_NAMES, got):
            field = name.split(".")
            want = np.array([[_field(py.nodes[p][n], field) for n in range(N)]
                             for p in range(P)])
            np.testing.assert_array_equal(leaf, want.astype(leaf.dtype),
                                          err_msg=f"tick {tick} {name}")
    assert (got[STATE_NAMES.index("role")] == 2).any()


def _field(node, path):
    v = getattr(node, path[0])
    if len(path) == 1:
        return v
    k = 0 if path[1] == "t" else 1
    return [x[k] for x in v] if isinstance(v, list) else v[k]
