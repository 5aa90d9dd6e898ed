"""Shared helpers of the ``test_torch_*`` suites: move JAX structs into the
PyTorch port through ``josefine_tpu_torch.interop``, compare leaves
exactly, and draw random states and message soups from numpy seeds.

Every comparison is exact integer equality: all leaves are int32, bool or
uint32 bit patterns.
"""

from __future__ import annotations

import gc
import pathlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from josefine_tpu.models import chained_raft as jcr
from josefine_tpu.models.types import step_params as jax_step_params
from josefine_tpu.raft import packed_step as jps
from josefine_tpu.utils.metrics import REGISTRY as JAX_REGISTRY
from josefine_tpu_torch import interop
from josefine_tpu_torch.chaos.harness import ChaosCluster, MembershipChaosCluster
from josefine_tpu_torch.chaos.search import ChaosSearch
from josefine_tpu_torch.chaos.soak import run_soak
from josefine_tpu_torch.chaos.wire_soak import run_wire_soak
from josefine_tpu_torch.models.types import step_params as port_step_params
from josefine_tpu_torch.raft.engine import RaftEngine
from josefine_tpu_torch.utils.metrics import REGISTRY
from josefine_tpu_torch.workload.driver import TrafficEngine

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


def random_params(rng: np.random.Generator):
    """JAX step params with small random timers, pre-vote on or off."""
    return jax_step_params(timeout_min=int(rng.integers(2, 5)),
                           timeout_max=int(rng.integers(5, 10)),
                           hb_ticks=int(rng.integers(1, 4)),
                           prevote=int(rng.integers(0, 2)))


def random_case(rng: np.random.Generator, P: int, N: int, me: int):
    """One node's view (slot ``me``) of a random (P, N) state, a random
    packed (10, P, N) engine input (nine message rows and the proposal-count
    row), a random member mask and optional keepalive flags, as numpy."""
    view = [a[:, me] for a in random_state_leaves(rng, P, N)]
    in10 = np.zeros((10, P, N), np.int32)
    in10[:9] = np.stack([a[:, 0] for a in random_inbox_leaves(rng, P, N)], 0)
    in10[9, :, 0] = rng.integers(0, 3, P)
    member = rng.random((P, N)) < 0.85
    pf = None if rng.random() < 0.3 else rng.integers(0, 2, N).astype(np.int32)
    return view, in10, member, pf


def jax_view_template(P: int, N: int, me: int):
    """A JAX node-view NodeState of the right structure, for ``to_jax``."""
    return jps._node_view(jcr.init_state(P, N)[0], me)


_JAX_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)josefine_tpu(?=[.\s])", re.M)
# An import of a sibling test module (``from test_integration import ...``):
# its objects would be the JAX package's, so every such line must be edited
# away (see :data:`INTEGRATION_EDITS` and the helpers below).
_SIBLING_IMPORT = re.compile(r"^\s*(?:from|import)\s+test_\w+", re.M)


def _is_fixture(v) -> bool:
    return (type(v).__name__ == "FixtureFunctionDefinition"
            or getattr(v, "_pytestfixturefunction", None) is not None)


def _port_namespace(name: str, edits, everywhere=()) -> dict:
    """``tests/<name>.py`` run as a module of its own against the port (see
    :func:`repointed`); returns its namespace."""
    path = pathlib.Path(__file__).with_name(f"{name}.py")
    src = _JAX_IMPORT.sub(r"\1josefine_tpu_torch", path.read_text())
    for old, new in edits:
        assert src.count(old) == 1, f"{name}: {old!r} matches {src.count(old)} times"
        src = src.replace(old, new)
    for old, new in everywhere:
        assert old in src, f"{name}: {old!r} matches nowhere"
        src = src.replace(old, new)
    sibling = _SIBLING_IMPORT.search(src)
    assert sibling is None, f"{name}: {sibling.group(0).strip()!r} is left un-replaced"
    ns = {"__name__": f"{name}__on_the_port", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), ns)
    for k, v in ns.items():
        mod = v.__name__ if isinstance(v, types.ModuleType) else getattr(v, "__module__", "")
        assert str(mod).split(".")[0] != "josefine_tpu", f"{name}: {k} is the JAX package's"
    return ns


def repointed(name: str, edits=(), leave_out: dict[str, str] | None = None,
              everywhere=()) -> dict:
    """The cases of ``tests/<name>.py``, run against the port.

    The JAX test module's source has every import of the JAX package
    re-pointed at the port and each ``(old, new)`` of ``edits`` made (each
    must match exactly once, so a drift of the original fails here), and
    runs as a module of its own. Each ``(old, new)`` of ``everywhere`` is
    made at every place it matches, and must match at least once. No import
    of a sibling test module may be left: such a module imports the JAX
    package. Returns its ``test_*`` functions, ``Test*`` classes and
    fixtures, less the cases named in ``leave_out`` (name -> the reason it
    is left out), for the calling test file to take into its namespace."""
    leave_out = leave_out or {}
    ns = _port_namespace(name, edits, everywhere)
    assert all(leave_out.values()), f"{name}: a case is left out without a reason"
    assert set(leave_out) <= set(ns), f"{name}: no {sorted(set(leave_out) - set(ns))}"
    return {k: v for k, v in ns.items()
            if (k.startswith(("test_", "Test")) or _is_fixture(v)) and k not in leave_out}


# The port's ``tests/test_integration.py``: its ``NodeManager`` builds port
# nodes with the engine on the host.
INTEGRATION_EDITS = [
    ("engine=EngineConfig(partitions=partitions,",
     'engine=EngineConfig(partitions=partitions, device="cpu",'),
]
NODE_CHAOS_EDITS = [("from test_integration import NodeManager, make_batch",
                     "from torch_parity import NodeManager, make_batch")]
# Import lines a suite's edits swap for the port's entry points with their
# engines on the host (the substitutes are defined below).
HOST = {
    "run_soak": ("from josefine_tpu_torch.chaos.soak import run_soak\n",
                 "from torch_parity import host_run_soak as run_soak\n"),
    "run_wire_soak": ("from josefine_tpu_torch.chaos.wire_soak import run_wire_soak\n",
                      "from torch_parity import host_run_wire_soak as run_wire_soak\n"),
    "TrafficEngine": ("from josefine_tpu_torch.workload.driver import TrafficEngine\n",
                      "from torch_parity import HostTrafficEngine as TrafficEngine\n"),
    "step_params": ("from josefine_tpu_torch.models.types import step_params\n",
                    "from torch_parity import host_step_params as step_params\n"),
    "RaftEngine": ("from josefine_tpu_torch.raft.engine import RaftEngine\n",
                   "from torch_parity import HostRaftEngine as RaftEngine\n"),
    "NodeManager": ("from test_integration import NodeManager\n",
                    "from torch_parity import NodeManager\n"),
}
# Helpers that suites import from a sibling JAX suite, served from that suite
# re-pointed at the port: module -> (its edits, the names served).
_SIBLINGS = {
    "test_integration": (INTEGRATION_EDITS, ("NodeManager", "make_batch")),
    "test_node_chaos": (NODE_CHAOS_EDITS, ("_metadata", "_produce_one")),
    "test_partition_groups": ([HOST["NodeManager"]], ("_create", "_wait_partitions")),
    "test_device_route": ([
        HOST["step_params"], HOST["RaftEngine"],
        # The port's state is a dataclass with ``leaves()``, not a pytree.
        ("zip(jax.tree.leaves(ea.state), jax.tree.leaves(er.state))",
         "zip(ea.state.leaves(), er.state.leaves())"),
    ], ("ListFsm", "_wire_key", "_would_route", "_assert_engines_equal")),
}
_sibling_ns: dict[str, dict] = {}


def __getattr__(name: str):
    """A helper of a sibling suite (``_SIBLINGS``), for the suites that
    import it from that module (``from torch_parity import NodeManager`` in
    their edits)."""
    for module, (edits, names) in _SIBLINGS.items():
        if name in names:
            if module not in _sibling_ns:
                _sibling_ns[module] = _port_namespace(module, edits)
            return _sibling_ns[module][name]
    raise AttributeError(name)


def host_step_params(*args, **kw):
    """The port's ``step_params`` on the host, for the suites that build an
    engine (``from torch_parity import host_step_params as step_params``)."""
    return port_step_params(*args, device="cpu", **kw)


class HostRaftEngine(RaftEngine):
    """The port's engine with its state on the host unless told otherwise,
    for the suites that build engines (``from torch_parity import
    HostRaftEngine as RaftEngine``)."""

    def __init__(self, *args, device="cpu", **kw):
        super().__init__(*args, device=device, **kw)


@pytest.fixture(autouse=True)
def only_port_nodes(monkeypatch):
    """Taken into a test file's namespace, fails every case there that
    builds a node of the JAX package; yields the port nodes each case
    builds."""
    import josefine_tpu.node as jax_node
    from josefine_tpu_torch import node as port_node

    def refuse(self, *args, **kw):
        raise AssertionError("a re-pointed suite built a node of the JAX package")

    built = []
    port_init = port_node.Node.__init__

    def record(self, *args, **kw):
        port_init(self, *args, **kw)
        built.append(self)

    monkeypatch.setattr(jax_node.Node, "__init__", refuse)
    monkeypatch.setattr(port_node.Node, "__init__", record)
    yield built


# The chaos and workload planes on the host, for the re-pointed suites: each
# entry point as the port has it, its engines on the CPU unless told
# otherwise (``HOST`` names the import lines that take them).


def host_run_soak(*args, device="cpu", **kw):
    return run_soak(*args, device=device, **kw)


def host_run_wire_soak(*args, device="cpu", **kw):
    return run_wire_soak(*args, device=device, **kw)


class HostChaosCluster(ChaosCluster):
    def __init__(self, *args, device="cpu", **kw):
        super().__init__(*args, device=device, **kw)


class HostMembershipChaosCluster(MembershipChaosCluster):
    def __init__(self, *args, device="cpu", **kw):
        super().__init__(*args, device=device, **kw)


class HostChaosSearch(ChaosSearch):
    def __init__(self, *args, device="cpu", **kw):
        super().__init__(*args, device=device, **kw)


class HostTrafficEngine(TrafficEngine):
    def __init__(self, *args, device="cpu", **kw):
        super().__init__(*args, device=device, **kw)




def fresh_registries() -> None:
    """Zero both packages' process-global metrics registries and collect the
    engines of earlier runs, whose scrape hooks would otherwise still publish
    into the next dump: a twin's two runs then read registries with the same
    (empty) history, whatever ran before them in the process."""
    gc.collect()
    JAX_REGISTRY.reset()
    REGISTRY.reset()
