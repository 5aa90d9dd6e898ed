"""PyTorch port, packed window step: exact equality with the JAX package.

The engine steps one node slot ``me`` of every group. These tests hold the
port's ``node_step`` over a slot subset, its packed single step and its
dense window programs (1 and 8 ticks) byte for byte against the JAX
package's ``_packed_over_groups`` / ``_window_step_fn`` on random packed
inputs: arbitrary states, message soups, proposal counts and keepalive
flags, drawn from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from josefine_tpu.raft import packed_step as jps
from josefine_tpu_torch import interop
from josefine_tpu_torch.models import chained_raft as tcr
from josefine_tpu_torch.models.types import Msgs, NodeState
from josefine_tpu_torch.raft import packed_step as tps

from torch_parity import (
    STATE_NAMES,
    assert_leaves_equal,
    jax_view_template,
    np_leaves,
    random_case,
    random_inbox_leaves,
    random_params,
    random_state_leaves,
    to_jax,
    torch_params,
)

# One jitted JAX packed step without donation (the tests reuse inputs), built
# with XLA's fusion pass off as in ``torch_parity.jax_step_unfused``: the
# integer results do not depend on fusion, the CPU compile time does.
_jax_packed = jax.jit(jps._jax_packed_step,
                      compiler_options={"xla_disable_hlo_passes": "fusion"})


def port_inputs(params, view, in10, member, pf, me):
    return (torch_params(params), torch.from_numpy(member),
            torch.tensor([me]), interop.state_from_numpy(view, device="cpu"),
            torch.from_numpy(in10), None if pf is None else torch.from_numpy(pf))


@pytest.mark.parametrize("N", [3, 5])
def test_packed_step_matches_jax_for_every_slot(N):
    """The generalised ``node_step`` over one slot (M = 1) == the JAX vmapped
    per-node step, for each ``me``: state leaves and the flat output."""
    rng = np.random.default_rng(N)
    P = 12
    for me in range(N):
        tmpl = jax_view_template(P, N, me)
        for trial in range(4):
            params = random_params(rng)
            view, in10, member, pf = random_case(rng, P, N, me)
            jst, jflat = _jax_packed(params, jnp.asarray(member), jnp.asarray(me, jnp.int32),
                                     to_jax(tmpl, view), jnp.asarray(in10),
                                     None if pf is None else jnp.asarray(pf))
            tst, tflat = tps._torch_packed_step(*port_inputs(params, view, in10, member,
                                                             pf, me))
            what = f"N={N} me={me} trial {trial}"
            assert_leaves_equal(interop.state_to_numpy(tst), np_leaves(jst), STATE_NAMES, what)
            assert tflat.dtype == torch.int32
            assert tflat.numpy().tobytes() == np.asarray(jflat).tobytes(), what


def test_node_step_slot_subset_equals_whole_cluster_rows():
    """``node_step`` over slots (0, 2) equals rows 0 and 2 of the whole-
    cluster step (``me=None``) on the same arbitrary state and inbox."""
    rng = np.random.default_rng(9)
    P, N = 10, 4
    params = torch_params(random_params(rng))
    member = torch.from_numpy(rng.random((P, N)) < 0.85)
    st = interop.state_from_numpy(random_state_leaves(rng, P, N), device="cpu")
    ib = interop.msgs_from_numpy(random_inbox_leaves(rng, P, N), device="cpu")
    props = torch.from_numpy(rng.integers(0, 3, (P, N)).astype(np.int32))
    pf = torch.tensor([1, 0, 1, 1], dtype=torch.int32)
    whole = tcr.node_step(params, member, st, ib, props, pf)
    me = torch.tensor([0, 2])
    sub = tcr.node_step(params, member, NodeState.from_leaves([a[:, me] for a in st.leaves()]),
                        Msgs.from_leaves([a[:, me] for a in ib.leaves()]), props[:, me], pf,
                        me=me)
    for w, s in zip(whole, sub):
        for a, b in zip(w.leaves(), s.leaves()):
            assert torch.equal(a[:, me], b)


def _lww_merge(acc, out):
    """Plain last-writer-wins merge, without the reply / span-AE freezes."""
    sel = out.kind != 0
    return Msgs.from_leaves([torch.where(sel, n, o)
                             for n, o in zip(out.leaves(), acc.leaves())])


@pytest.mark.parametrize("ticks", [1, 8])
def test_window_step_matches_jax(ticks, monkeypatch):
    """Dense windows of 1 and 8 ticks: flat outputs byte-equal to the JAX
    window program. At 8 ticks the random inboxes must exercise the merge's
    freezes: a plain last-writer merge gives a different outbox."""
    rng = np.random.default_rng(100 + ticks)
    P, N = 16, 3
    # The JAX window program as the engine builds it, recompiled without
    # donation and with the fusion pass off (see _jax_packed).
    jfn = jax.jit(jps._window_step_fn(ticks).__wrapped__,
                  compiler_options={"xla_disable_hlo_passes": "fusion"})
    froze = 0
    for trial in range(6):
        me = int(rng.integers(0, N))
        params = random_params(rng)
        view, in10, member, pf = random_case(rng, P, N, me)
        jst, jflat = jfn(params, jnp.asarray(member), jnp.asarray(me, jnp.int32),
                         to_jax(jax_view_template(P, N, me), view), jnp.asarray(in10),
                         None if pf is None else jnp.asarray(pf))
        args = port_inputs(params, view, in10, member, pf, me)
        tst, tflat = tps._window_step_fn(ticks)(*args)
        what = f"ticks={ticks} trial {trial}"
        assert_leaves_equal(interop.state_to_numpy(tst), np_leaves(jst), STATE_NAMES, what)
        assert tflat.numpy().tobytes() == np.asarray(jflat).tobytes(), what
        with monkeypatch.context() as m:
            m.setattr(tps, "_merge_outbox", _lww_merge)
            froze += not torch.equal(tps._window_step_fn(ticks)(*args)[1], tflat)
    assert froze > 0 or ticks == 1, "no case exercised the merge freezes"


def assert_flat_equal_where_sent(got, want, P, N, what):
    """Flat outputs equal in the (10, P) mirror and in every outbox cell
    that carries a message. A MSG_NONE cell's other fields are never read
    (the decoder skips it), and there the scalar oracle writes zeros where
    the batched step leaves the node's term and ids."""
    cut = 10 * P
    assert torch.equal(got[:cut], want[:cut]), what
    og, ow = got[cut:].reshape(9, P, N), want[cut:].reshape(9, P, N)
    sent = ow[0] != 0
    assert torch.equal(og[0], ow[0]), what
    assert torch.equal(og[:, sent], ow[:, sent]), what


@pytest.mark.parametrize("ticks", [1, 4])
def test_py_window_matches_torch_window(ticks):
    """The python backend's window (scalar oracle) == the torch window."""
    rng = np.random.default_rng(5 + ticks)
    P, N = 8, 3
    for trial in range(3):
        me = trial % N
        params = random_params(rng)
        view, in10, member, pf = random_case(rng, P, N, me)
        args = port_inputs(params, view, in10, member, pf, me)
        tst, tflat = tps._window_step_fn(ticks)(*args)
        if ticks == 1:
            pst, pflat = tps._py_packed_step(*args[:4], in10, pf)
        else:
            pst, pflat = tps._py_packed_window(*args[:4], in10, pf, ticks)
        for a, b in zip(tst.leaves(), pst.leaves()):
            assert torch.equal(a, b)
        assert_flat_equal_where_sent(pflat, tflat, P, N, f"ticks={ticks} trial {trial}")
