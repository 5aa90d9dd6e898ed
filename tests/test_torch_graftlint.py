"""PyTorch port, graftlint: the JAX package's lint self-tests run against the
port's ``josefine_tpu_torch.analysis``, its jit family's cases as cases of
the port's device-program family (``@device_program`` for ``jax.jit``,
``torch`` for ``jnp``, the port's rule ids), and the acceptance gate: the
port's tree lints clean against ``josefine_tpu_torch/tools/lint_baseline.json``,
which holds no entries. The device family's seeds are held against the JAX
jit family's seeds over the JAX package, program by program. Mutation cases
show that the gate sees the faults it guards against: the engine's
profiling-timer pragma taken away, the active set's timer-mirror refetch
moved out of its audited method, a program builder's cache taken away, a
raw count fed to a builder, and a host sync inside a program.
"""

import ast
import json
import os
import subprocess
import sys

import pytest
from torch_parity import repointed

from josefine_tpu_torch.analysis import collect_findings
from josefine_tpu_torch.analysis import device_discipline as dd
from josefine_tpu_torch.analysis.core import (
    DEFAULT_BASELINE,
    REPO_ROOT,
    default_checkers,
    enclosing_functions,
    load_modules,
)
from josefine_tpu_torch.models.types import device_program

# The jit family's cases in the port's idiom, and the seeded file's jit
# violations as the device family's.
_DEVICE_IDIOM = [
    ("        import jax\n",
     "        from josefine_tpu_torch.models.types import device_program\n"),
    ("        import jax.numpy as jnp\n", "        import torch\n"),
    ("@jax.jit", "@device_program"),
    ("jax.jit(fn)", "device_program(fn)"),
    ("jnp.zeros", "torch.zeros"),
    ('"jit-tracer-leak"', '"dev-host-sync"'),
    ('"jit-host-np"', '"dev-host-np"'),
    ('"jit-uncached-builder"', '"dev-uncached-builder"'),
    ('"jit-unbucketed-shape"', '"dev-unbucketed-shape"'),
]
globals().update(repointed(
    "test_graftlint",
    edits=[
        ('path = os.path.join(REPO_ROOT, "josefine_tpu", "broker", "groups.py")',
         'path = os.path.join(REPO_ROOT, "josefine_tpu_torch", "broker", "groups.py")'),
    ],
    everywhere=_DEVICE_IDIOM))

ENGINE = os.path.join(REPO_ROOT, "josefine_tpu_torch", "raft", "engine.py")
PORT = os.path.join(REPO_ROOT, "josefine_tpu_torch")


def test_port_baseline_is_empty_and_is_the_default():
    assert DEFAULT_BASELINE == os.path.join("josefine_tpu_torch", "tools", "lint_baseline.json")
    with open(os.path.join(REPO_ROOT, DEFAULT_BASELINE)) as fh:
        assert json.load(fh)["entries"] == []


def test_port_checkers_leave_out_the_jit_family():
    """The port runs the JAX package's four families, its device-program
    family in the jit family's place, every scope inside the port."""
    names = [c.name for c in default_checkers()]
    assert names == ["determinism", "device-discipline", "mirror-coherence", "async-blocking"]
    for c in default_checkers():
        assert c.scope and all(s.startswith("josefine_tpu_torch/") for s in c.scope), c.name


def test_module_and_cli_lint_the_port_clean():
    for cmd in ([sys.executable, "-m", "josefine_tpu_torch.analysis"],
                [sys.executable, "-m", "josefine_tpu_torch.tools.lint"]):
        res = subprocess.run(cmd, cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stdout + res.stderr
        assert "graftlint: 0 new findings, 0 baselined" in res.stdout


def _lint_engine_copy(tmp_path, old, new):
    src = open(ENGINE).read()
    assert src.count(old) == 1, old
    p = tmp_path / "engine.py"
    p.write_text(src.replace(old, new))
    return [f for f in collect_findings([str(p)]) if f.file == str(p)]


def test_engine_copy_lints_clean(tmp_path):
    p = tmp_path / "engine.py"
    p.write_text(open(ENGINE).read())
    assert collect_findings([str(p)]) == []


def test_taking_the_profiling_pragma_away_is_a_finding(tmp_path):
    pragma = (" " * 36 + "# graftlint: allow(det-wallclock) — profiling plane only (off by "
              "default); timings feed /metrics, never the journal or state\n")
    fs = _lint_engine_copy(tmp_path, pragma, "")
    assert [(f.rule, f.context) for f in fs] == [("det-wallclock", "_tick_finish")]
    assert "t_done = time.perf_counter_ns()" in fs[0].snippet


def test_refetch_outside_its_audited_method_is_a_finding(tmp_path):
    fs = _lint_engine_copy(
        tmp_path, "    def _refetch_wake_inputs(self)", "    def _refetch_timers(self)")
    assert sorted({f.rule for f in fs}) == ["mirror-unlisted-write", "mirror-unpaired-mutation"]
    assert {f.context for f in fs} == {"_refetch_timers"}
    assert sorted(f.snippet.split(" = ")[0] for f in fs
                  if f.rule == "mirror-unlisted-write") == [
        "self._h_elapsed", "self._h_hb", "self._h_timeout"]


# ------------------------------------------------- the device-program family


def test_device_program_returns_the_function_itself():
    def f(x):
        return x

    assert device_program(f) is f


def _seeds(index_cls, modules, found, monkeypatch):
    """{(path under the package, program qualname)} of the seeds that
    ``index_cls`` discovers over ``modules``: its propagation is turned off,
    so only the marked programs remain."""
    monkeypatch.setattr(index_cls, "_propagate", lambda self: None)
    out = set()
    for mod in modules:
        ctx = enclosing_functions(mod.tree)
        rel = mod.rel.split("/", 1)[1]
        out |= {(rel, ctx[fn]) for fn in getattr(index_cls(mod), found)}
    return out


def _scope_modules(checker):
    paths = []
    for s in checker.scope:
        full = os.path.join(REPO_ROOT, s)
        if s.endswith("/"):
            paths += [os.path.join(full, f) for f in sorted(os.listdir(full)) if f.endswith(".py")]
        else:
            paths.append(full)
    return load_modules(paths)


_PS, _SH = "raft/packed_step.py", "parallel/sharded.py"
# Each seed of the JAX jit family over its scope -> the port's marked
# program, less those in _NO_TWIN.
TWINS = {
    (_PS, "_jax_packed_step"): (_PS, "_torch_packed_step"),
    (_PS, "_window_step_fn.fn"): (_PS, "_window_step_fn.fn"),
    (_PS, "_window_step_routed_fn.fn"): (_PS, "_window_step_fn.fn"),
    (_PS, "_sparse_window_fn.fn"): (_PS, "_sparse_window_fn.fn"),
    (_PS, "_sparse_window_routed_fn.fn"): (_PS, "_sparse_window_fn.fn"),
    (_PS, "_active_window_fn.fn"): (_PS, "_active_window_fn.fn"),
    (_PS, "_active_window_routed_fn.fn"): (_PS, "_active_window_fn.fn"),
    (_PS, "_decay_scatter_fn.fn"): (_PS, "_decay_scatter_fn.fn"),
    (_PS, "_decay_only_fn.fn"): (_PS, "_decay_only_fn.fn"),
    (_PS, "_gather_active"): (_PS, "_gather_active"),
    (_PS, "_route_scatter_fn.fn"): (_PS, "_route_scatter"),
    (_PS, "_route_scatter_new_fn.fn"): (_PS, "_route_scatter"),
    (_PS, "_route_scatter_vals_fn.fn"): (_PS, "_route_scatter_vals"),
    (_PS, "_route_scatter_vals_new_fn.fn"): (_PS, "_route_scatter_vals"),
    (_PS, "_ring_scatter_fn.fn"): (_PS, "_ring_scatter"),
    (_PS, "_ring_gather_fn.fn"): (_PS, "_ring_gather"),
    (_PS, "_merge_planes_fn"): (_PS, "_merge_planes_fn"),
    (_PS, "_purge_plane_row_fn"): (_PS, "_purge_plane_row_fn"),
    (_PS, "_lease_plane_scatter_fn"): (_PS, "_lease_plane_scatter_fn"),
    (_SH, "make_sharded_cluster_step.local_step"): (_SH, "make_sharded_cluster_step.step"),
    (_SH, "purge_plane_row_masked"): (_SH, "purge_plane_row_masked"),
    (_SH, "lease_plane_select"): (_SH, "lease_plane_select"),
}
_NO_TWIN = {
    (_PS, "_scan_quiet_ticks.body"):
        "the body of JAX's lax.scan over the quiet ticks is the loop body of the port's "
        "_scan_quiet_ticks, which every window program reaches by propagation",
}
# Marked programs of the port with no JAX seed, and why.
_SHARD_MAP_1P = ("JAX builds this program through _shard_map_1p, a wrapper its jit family "
                 "does not name, so the JAX family sees no seed (it registers the builder "
                 "all the same: its body holds jax.jit)")
PORT_ONLY = {
    (_SH, "make_sharded_active_window.fn"): _SHARD_MAP_1P,
    (_SH, "make_sharded_decay_only.fn"): _SHARD_MAP_1P,
    (_SH, "make_sharded_route_scatter.scatter"): _SHARD_MAP_1P,
    (_SH, "make_sharded_route_scatter.fresh"): _SHARD_MAP_1P,
    (_SH, "make_sharded_ring_scatter.fn"): _SHARD_MAP_1P,
    (_SH, "make_sharded_ring_gather.fn"): _SHARD_MAP_1P,
}


def test_device_seeds_match_the_jit_seeds_of_the_jax_package(monkeypatch):
    from josefine_tpu.analysis import jit_discipline as jd

    jax_seeds = _seeds(jd._ModuleIndex, _scope_modules(jd.JitDisciplineChecker()), "traced",
                       monkeypatch)
    port_seeds = _seeds(dd._ModuleIndex, _scope_modules(dd.DeviceDisciplineChecker()),
                        "programs", monkeypatch)
    assert jax_seeds == set(TWINS) | set(_NO_TWIN)
    assert port_seeds == set(TWINS.values()) | set(PORT_ONLY)


def test_device_builders_match_the_jit_builders_of_the_jax_package():
    """Every JAX jit builder is a registered program builder in the port,
    less those the port folds into one (the routed and new-plane variants
    take an optional plane) and those whose programs are plain functions."""
    from josefine_tpu.analysis import jit_discipline as jd

    jax_b = set().union(*(jd._ModuleIndex(m).cached_jit_builders()
                          for m in _scope_modules(jd.JitDisciplineChecker())))
    port_b = set().union(*(dd._ModuleIndex(m).cached_builders()
                           for m in _scope_modules(dd.DeviceDisciplineChecker())))
    folded = {"_window_step_routed_fn", "_sparse_window_routed_fn", "_active_window_routed_fn",
              "_route_scatter_fn", "_route_scatter_new_fn", "_route_scatter_vals_fn",
              "_route_scatter_vals_new_fn", "_ring_scatter_fn", "_ring_gather_fn"}
    assert port_b == jax_b - folded


def _lint_copy(tmp_path, rel, old, new, registry=()):
    """Lint a copy of the port's ``rel`` with ``old`` made ``new``, together
    with the port's modules ``registry`` (the builders it calls); returns the
    copy's findings and the line of ``new``'s first line in it."""
    src = open(os.path.join(PORT, rel)).read()
    assert src.count(old) == 1, old
    p = tmp_path / os.path.basename(rel)
    text = src.replace(old, new)
    p.write_text(text)
    line = text[:text.index(new)].count("\n") + 1
    fs = collect_findings([str(p)] + [os.path.join(PORT, r) for r in registry])
    return [f for f in fs if f.file == str(p)], line


def test_uncached_window_builder_is_a_finding(tmp_path):
    cache = "@functools.lru_cache(maxsize=None)\ndef _window_step_fn(ticks: int):"
    fs, line = _lint_copy(tmp_path, _PS, cache, "def _window_step_fn(ticks: int):")
    assert [(f.rule, f.context, f.snippet) for f in fs] == [
        ("dev-uncached-builder", "_window_step_fn", "return fn")]
    tree = ast.parse(open(tmp_path / "packed_step.py").read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "_window_step_fn")
    assert fn.lineno == line and fs[0].line == fn.body[-1].lineno


@pytest.mark.parametrize("rel,old,new", [
    ("raft/step_runner.py", "_active_window_fn(window),", "_active_window_fn(len(G)),"),
    ("raft/step_runner.py", "sh.make_sharded_active_window(self.mesh, plan.k,",
     "sh.make_sharded_active_window(self.mesh, len(G),"),
    ("raft/route.py", "make_sharded_route_scatter(self.mesh, B,",
     "make_sharded_route_scatter(self.mesh, len(gs),"),
], ids=["engine", "engine-sharded", "route-sharded"])
def test_raw_count_at_a_builder_call_site_is_a_finding(tmp_path, rel, old, new):
    fs, line = _lint_copy(tmp_path, rel, old, new, registry=(_PS, _SH))
    assert [(f.rule, f.line) for f in fs] == [("dev-unbucketed-shape", line)]
    assert "len(" in fs[0].snippet


def test_host_sync_inside_the_window_program_is_a_finding(tmp_path):
    head = "    def fn(params, member, me, state, in10, peer_fresh, plane=None):\n"
    fs, line = _lint_copy(tmp_path, _PS, head,
                          head + "        n_props = in10[9, :, 0].sum().item()\n")
    assert [(f.rule, f.line, f.context) for f in fs] == [
        ("dev-host-sync", line + 1, "_window_step_fn.fn")]
