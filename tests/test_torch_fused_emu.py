"""The CUDA kernel's own tick body against the JAX package, without a card.

``josefine_tpu_torch/ops/csrc/fused_step.cuh`` is compiled by g++ into a
host library (``fused_step_host.cpp``) that runs the kernel's warps one by
one: ``32 // N`` whole groups per warp, idle lanes, the ragged last warp,
each warp's double-buffered shared-memory mailbox and its per-warp metric
partials. Held against JAX
``cluster_step_impl`` stepped tick by tick, exactly, the way
``tests/test_pallas_step.py`` holds the Pallas body in interpret mode. The
JAX step is compiled without XLA's fusion pass (``jax_step_unfused``), which
keeps N = 8 and N = 16 at about a millisecond per tick on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from josefine_tpu.models import chained_raft as jcr
from josefine_tpu.models.types import LEADER, step_params as jax_step_params
from josefine_tpu_torch import interop
from josefine_tpu_torch.ops import fused_step

from torch_parity import (
    assert_msgs_equal,
    assert_state_equal,
    jax_step_unfused as jax_step,
    np_leaves,
    random_inbox_leaves,
    random_state_leaves,
    to_jax,
    torch_member,
    torch_msgs,
    torch_params,
    torch_state,
)

# name -> (P, N, step params, member slots off, crashed (p, n), peer_fresh, tile)
SCENARIOS = {
    "6x3": (6, 3, dict(auto_proposals=1), (), (), None, 2),
    "5x5": (5, 5, dict(auto_proposals=1), (), (), None, 2),
    "5x5-prevote0-tile1": (5, 5, dict(prevote=0, auto_proposals=2), (), (), None, 1),
    "5x5-partial-crash": (5, 5, dict(auto_proposals=1), ((slice(None), 4),), ((1, 0), (3, 2)),
                          None, 4),
    "6x3-peer-fresh": (6, 3, dict(hb_ticks=32), (), (), (1, 0, 1), 4),
    # The edges of 32 // N: 32 groups of 1, 16 of 2, 4 of 7 (28 lanes) or of
    # 8 (32 lanes), 2 of 16; every P leaves its last warp partly empty.
    "35x1-ragged": (35, 1, dict(auto_proposals=1), (), (), None, 24),
    "17x2-ragged": (17, 2, dict(auto_proposals=1), (), (), None, 24),
    "5x7-ragged": (5, 7, dict(auto_proposals=1), ((slice(None), 6),), ((2, 0),), None, 24),
    "6x8-ragged": (6, 8, dict(prevote=0, auto_proposals=1), (), (), None, 4),
    "3x16-ragged": (3, 16, dict(auto_proposals=1), (), ((1, 3),), None, 2),
    # P not a multiple of G = 10 groups per warp.
    "23x3-ragged": (23, 3, dict(auto_proposals=1), (), ((21, 2),), (1, 1, 0), 24),
    # Three warps of 6 groups: groups 5|6 and 11|12 sit on either side of a
    # warp boundary, the last warp holds one group.
    "13x5-warp-crossing": (13, 5, dict(auto_proposals=2), ((slice(None), 4),),
                           ((5, 0), (6, 1), (12, 2)), None, 6),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_emulated_kernel_matches_jax(name):
    P, N, kw, off, crashed, pf, tile = SCENARIOS[name]
    params = jax_step_params(**{"timeout_min": 3, "timeout_max": 8, "hb_ticks": 1, **kw})
    member = np.ones((P, N), bool)
    for idx in off:
        member[idx] = False
    jst, jmember = jcr.init_state(P, N, member=jnp.asarray(member), base_seed=42,
                                  params=params)
    dead = np.zeros((P, N), bool)
    for p, n in crashed:
        dead[p, n] = True
    jst = jcr.crash(jst, jnp.asarray(dead))
    jib = jcr.empty_inbox(P, N)
    props = np.zeros((P, N), np.int32)
    args = (torch_params(params), torch_member(jmember), torch_state(jst), torch_msgs(jib),
            torch.from_numpy(props))
    jpf = None if pf is None else jnp.asarray(pf, jnp.int32)

    est, eib, etot = fused_step.run_ticks_fused_emulated(*args, 30, tile=tile, peer_fresh=pf)
    totals = dict.fromkeys(fused_step.METRIC_FIELDS, 0)
    for _ in range(30):
        jst, jib, met = jax_step(params, jmember, jst, jib, jnp.asarray(props), jpf)
        for f in totals:
            totals[f] += int(np.asarray(getattr(met, f)).astype(np.int64).sum())
    assert_state_equal(est, jst, f"{name} emulated state")
    assert_msgs_equal(eib, jib, f"{name} emulated inbox")
    assert etot == totals
    role, alive = np.asarray(jst.role), np.asarray(jst.alive)
    assert (((role == LEADER) & alive).sum(axis=1) == 1).all()


@pytest.mark.parametrize("seed", range(6))
def test_emulated_kernel_fuzz_one_step(seed):
    """One tick of the C++ body from arbitrary states and message soups:
    seeds 2 and 3 across warp boundaries (13 groups of 5, 13 groups of 3),
    4 and 5 at N = 8 and 16 (4 and 2 groups per warp, the last warp ragged)."""
    rng = np.random.default_rng(200 + seed)
    P, N = ((6, 3), (5, 5), (13, 5), (13, 3), (6, 8), (3, 16))[seed]
    template, jib_t = jcr.init_state(P, N)[0], jcr.empty_inbox(P, N)
    for trial in range(12):
        params = jax_step_params(timeout_min=int(rng.integers(2, 6)),
                                 timeout_max=int(rng.integers(6, 12)),
                                 hb_ticks=int(rng.integers(1, 4)),
                                 auto_proposals=int(rng.integers(0, 3)),
                                 prevote=int(rng.integers(0, 2)))
        member = rng.random((P, N)) < 0.85
        st_leaves = random_state_leaves(rng, P, N)
        ib_leaves = random_inbox_leaves(rng, P, N)
        props = rng.integers(0, 3, (P, N)).astype(np.int32)
        jst2, jib2, met = jax_step(params, jnp.asarray(member), to_jax(template, st_leaves),
                                   to_jax(jib_t, ib_leaves), jnp.asarray(props))
        est, eib, etot = fused_step.run_ticks_fused_emulated(
            torch_params(params), torch.from_numpy(member),
            interop.state_from_numpy(st_leaves, device="cpu"),
            interop.msgs_from_numpy(ib_leaves, device="cpu"),
            torch.from_numpy(props), 1, tile=int(rng.integers(1, 5)))
        what = f"seed {seed} trial {trial}"
        assert_state_equal(est, jst2, what)
        assert_msgs_equal(eib, jib2, what)
        assert etot == {f: int(a.astype(np.int64).sum())
                        for f, a in zip(fused_step.METRIC_FIELDS, np_leaves(met))}, what
