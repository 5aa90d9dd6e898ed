"""graftlint device-program family — bounded program shapes, no host syncs
inside a program, one backend.

The port's counterpart of the JAX package's
``josefine_tpu/analysis/jit_discipline.py``: the same four disciplines,
written for PyTorch's idiom.

The engine's tick dispatch survives at P=100k because every device program
it builds is drawn from a coarse ladder: power-of-two active-set buckets
(``packed_step.active_bucket``), the sharded path's power-of-eight
per-shard buckets (``parallel/sharded.shard_bucket``,
``split_shard_rows``), and window lengths clamped to ``hb_ticks``. Eager
torch compiles nothing per shape, so a call site that feeds a raw count
into a program builder costs nothing today; it costs one captured program
per distinct value once the step is captured with ``torch.cuda.CUDAGraph``.
Likewise a ``.item()`` inside a program is no error in eager torch: it
stalls the host on the card every tick, and a captured program cannot hold
it at all. And ``np.*`` inside a program runs on the host, outside any
stream. This family makes those disciplines machine-checked over the
modules that build and dispatch the programs (``packed_step.py``,
``engine.py``, ``route.py``, ``payload_ring.py``, ``step_runner.py``,
``parallel/``).

Program discovery is module-local and conservative: seeds are functions
decorated with ``@device_program`` (``josefine_tpu_torch.models.types``,
which returns the function unchanged) and names passed to a
``device_program(...)`` call; program-ness propagates through module-local
calls (so shared helpers like ``_step_node`` and ``_flat_outputs`` are held
to the same rules as the programs that call them).

Rules:

* ``dev-host-sync`` — ``int()``/``float()``/``bool()`` on a non-literal,
  ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``/``.nonzero()``,
  ``torch.nonzero`` or a ``synchronize`` call inside a program: the host
  waits for the card.
* ``dev-host-np`` — ``np.*`` inside a program that does not take an ``xp``
  backend parameter (the dual-backend idiom: the python twin passes ``np``,
  the device path passes ``torch``). Dtype/constant attributes
  (``np.int32`` etc.) are exempt: they are plain objects, not array ops.
* ``dev-uncached-builder`` — a parameterized function that returns a marked
  nested program (or calls ``device_program(...)``) without
  ``functools.lru_cache``: every call builds a new closure identity, so no
  captured program can be reused.
* ``dev-unbucketed-shape`` — a call to a registered program builder (an
  lru_cached function that builds a marked program, discovered across the
  scanned modules; called by name or as ``module.builder``) whose
  shape-feeding argument is a raw computation (``len(...)``, arithmetic,
  an un-provenanced local) instead of a value routed through an approved
  bucket helper (``active_bucket`` / ``route_bucket`` / ``ring_bucket`` /
  ``shard_bucket`` / ``split_shard_rows``, tuple unpacks included; the port
  defines the first and the last two), a constant, an attribute (engine
  dims are fixed at init; ``ShardPlan.k`` is ladder-derived), a bool-valued
  comparison (two programs max), or a plain parameter (validated at ITS
  call site).
"""

from __future__ import annotations

import ast

from josefine_tpu_torch.analysis.core import (
    Checker,
    Finding,
    Module,
    collect_import_aliases,
    dotted_name,
    enclosing_functions,
)

_MARKER = "device_program"

_CACHE_DECORATORS = {"functools.lru_cache", "functools.cache",
                     "lru_cache", "cache"}

_BUCKET_HELPERS = {"active_bucket", "route_bucket", "ring_bucket",
                   "shard_bucket", "split_shard_rows"}

# Methods that copy a device value to the host (the host waits for the card).
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "nonzero", "synchronize"}

# numpy attributes that are plain objects (dtypes/constants), not host ops.
_NP_BENIGN = {
    "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "float16", "float32", "float64", "bool_", "intp",
    "ndarray", "dtype", "newaxis", "pi", "inf", "nan",
}


def _is_marker(name: str | None) -> bool:
    return name is not None and name.rsplit(".", 1)[-1] == _MARKER


def _func_params(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> set[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return set(names)


def _decorator_names(fn, aliases) -> set[str]:
    out = set()
    for dec in fn.decorator_list:
        d = dotted_name(dec, aliases)
        if d:
            out.add(d)
        if isinstance(dec, ast.Call):
            d = dotted_name(dec.func, aliases)
            if d:
                out.add(d)
    return out


def _is_marked(fn, aliases) -> bool:
    return any(_is_marker(d) for d in _decorator_names(fn, aliases))


def _walk_own(fn: ast.AST):
    """Walk a function's own body, skipping nested defs (they are visited
    separately iff themselves programs) and signature annotations."""

    def gen(node: ast.AST):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            yield child
            yield from gen(child)

    for stmt in fn.body:
        yield stmt
        yield from gen(stmt)


class _ModuleIndex:
    """Per-module function table, program set, and local call graph."""

    def __init__(self, module: Module):
        self.module = module
        self.aliases = collect_import_aliases(module.tree)
        # leaf name -> list of def nodes (collisions kept; conservative)
        self.defs: dict[str, list[ast.AST]] = {}
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs.setdefault(node.name, []).append(node)
        self.programs: set[ast.AST] = set()
        self._seed()
        self._propagate()

    def _seed(self) -> None:
        for nodes in self.defs.values():
            for fn in nodes:
                if _is_marked(fn, self.aliases):
                    self.programs.add(fn)
        for node in ast.walk(self.module.tree):
            if isinstance(node, ast.Call) and node.args and \
                    _is_marker(dotted_name(node.func, self.aliases)):
                arg = node.args[0]
                if isinstance(arg, ast.Name) and arg.id in self.defs:
                    self.programs.update(self.defs[arg.id])

    def _propagate(self) -> None:
        changed = True
        while changed:
            changed = False
            for fn in list(self.programs):
                for node in ast.walk(fn):
                    if isinstance(node, ast.Call) and \
                            isinstance(node.func, ast.Name) and \
                            node.func.id in self.defs:
                        for callee in self.defs[node.func.id]:
                            if callee not in self.programs:
                                self.programs.add(callee)
                                changed = True

    def builds_program(self, fn) -> ast.AST | None:
        """The node at which ``fn`` hands out a marked program it builds —
        a ``device_program(...)`` call, or a ``return`` of a marked nested
        def — or None."""
        nested = {n.name for n in ast.walk(fn)
                  if n is not fn and isinstance(n, (ast.FunctionDef,
                                                    ast.AsyncFunctionDef))
                  and _is_marked(n, self.aliases)}
        for node in _walk_own(fn):
            if isinstance(node, ast.Call) and _is_marker(
                    dotted_name(node.func, self.aliases)):
                return node
            if isinstance(node, ast.Return) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id in nested:
                return node
        return None

    def cached_builders(self) -> set[str]:
        """Names of lru_cached functions that build a marked program — the
        approved shape-parameterized builder pattern."""
        return {name for name, nodes in self.defs.items() for fn in nodes
                if _decorator_names(fn, self.aliases) & _CACHE_DECORATORS
                and self.builds_program(fn) is not None}


class DeviceDisciplineChecker(Checker):
    name = "device-discipline"
    scope = (
        "josefine_tpu_torch/raft/packed_step.py",
        "josefine_tpu_torch/raft/engine.py",
        "josefine_tpu_torch/raft/route.py",
        "josefine_tpu_torch/raft/payload_ring.py",
        "josefine_tpu_torch/raft/step_runner.py",
        "josefine_tpu_torch/parallel/",
    )
    rules = {
        "dev-host-sync":
            "host cast or copy (int/float/bool/.item/.tolist/.cpu/.numpy/"
            ".nonzero/synchronize) inside a device program",
        "dev-host-np":
            "np.* inside a device program without the xp backend parameter",
        "dev-uncached-builder":
            "parameterized device-program builder without "
            "functools.lru_cache",
        "dev-unbucketed-shape":
            "program-builder call fed a raw count instead of a "
            "bucket-helper value",
    }

    def __init__(self):
        self._builders: set[str] = set()
        self._indexes: dict[str, _ModuleIndex] = {}

    def prepare(self, modules: list[Module]) -> None:
        self._builders = set()
        self._indexes = {}
        for mod in modules:
            idx = _ModuleIndex(mod)
            self._indexes[mod.rel] = idx
            self._builders |= idx.cached_builders()

    def check(self, module: Module) -> list[Finding]:
        idx = self._indexes.get(module.rel) or _ModuleIndex(module)
        ctx = enclosing_functions(module.tree)
        findings: list[Finding] = []

        def emit(node: ast.AST, rule: str, message: str, hint: str) -> None:
            findings.append(Finding(
                file=module.rel, line=node.lineno, rule=rule,
                message=message, hint=hint, context=ctx.get(node, ""),
                snippet=module.snippet(node.lineno)))

        for fn in idx.programs:
            self._check_program(fn, idx, emit)
        self._check_builders_cached(idx, emit)
        self._check_builder_call_sites(module, emit)
        return findings

    # ---- inside programs --------------------------------------------------

    def _check_program(self, fn, idx: _ModuleIndex, emit) -> None:
        has_xp = "xp" in _func_params(fn)
        own_nodes = list(_walk_own(fn))
        # Outermost attribute chains only: `np.linalg.norm` is ONE
        # violation, not one per dotted level.
        inner_attrs = {id(n.value) for n in own_nodes
                       if isinstance(n, ast.Attribute)}
        for node in own_nodes:
            if isinstance(node, ast.Call):
                name = dotted_name(node.func, idx.aliases)
                if name in ("int", "float", "bool") and len(node.args) == 1 \
                        and not isinstance(node.args[0], ast.Constant):
                    emit(node, "dev-host-sync",
                         f"{name}() on a device value makes the host wait "
                         "for the card inside a program",
                         "keep the value on the device (torch ops / .to("
                         "dtype)) or hoist the cast out of the program")
                elif name in ("torch.nonzero", "torch.cuda.synchronize") or (
                        isinstance(node.func, ast.Attribute)
                        and node.func.attr in _SYNC_METHODS
                        and not node.args):
                    what = name if name and name.startswith("torch.") \
                        else f".{node.func.attr}()"
                    emit(node, "dev-host-sync",
                         f"{what} makes the host wait for the card inside "
                         "a program",
                         "return the tensor and read it outside the "
                         "program, or use a fixed-size device op")
            if not has_xp and isinstance(node, ast.Attribute) and \
                    id(node) not in inner_attrs:
                name = dotted_name(node, idx.aliases)
                if name and (name == "numpy"
                             or name.startswith("numpy.")):
                    leaf = name.split(".", 1)[1] if "." in name else ""
                    if leaf.split(".")[0] in _NP_BENIGN:
                        continue
                    emit(node, "dev-host-np",
                         f"{name} in a device program runs on the host, "
                         "outside the card's stream",
                         "use torch here, or take an `xp` backend parameter "
                         "(the dual-backend idiom) if this helper serves "
                         "both engines")

    # ---- builder caching --------------------------------------------------

    def _check_builders_cached(self, idx: _ModuleIndex, emit) -> None:
        for name, fns in idx.defs.items():
            for fn in fns:
                if not _func_params(fn):
                    continue
                if _decorator_names(fn, idx.aliases) & _CACHE_DECORATORS:
                    continue
                node = idx.builds_program(fn)
                if node is not None:
                    emit(node, "dev-uncached-builder",
                         f"{name}() builds a device program per call — no "
                         "two calls share a program",
                         "decorate the builder with "
                         "@functools.lru_cache(maxsize=None) so programs "
                         "are shared per shape key")

    # ---- builder call-site bucket discipline -------------------------------

    def _approved_arg(self, arg: ast.AST, approved_names: set[str]) -> bool:
        if isinstance(arg, ast.Constant):
            return True
        if isinstance(arg, ast.Attribute):
            return True  # engine dims (self.P/self.N/self._k_out): fixed
            # at init or grown through the sparse capacity ladder
        if isinstance(arg, ast.Name):
            return arg.id in approved_names
        if isinstance(arg, ast.Call):
            fn = arg.func
            leaf = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else "")
            return leaf in _BUCKET_HELPERS
        if isinstance(arg, ast.UnaryOp):
            return self._approved_arg(arg.operand, approved_names)
        if isinstance(arg, ast.Starred):
            return True  # *args forwarding — validated where built
        if isinstance(arg, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot, ast.Eq, ast.NotEq))
                for op in arg.ops):
            return True  # bool-valued flag (e.g. `plane is None`): two
            # programs max, the routed/new-plane axis — not a shape
        return False

    def _builder_name(self, call: ast.Call) -> str | None:
        fn = call.func
        if isinstance(fn, ast.Name) and fn.id in self._builders:
            return fn.id
        # The port reaches the sharded builders as `sh.make_sharded_...`.
        if isinstance(fn, ast.Attribute) and fn.attr in self._builders:
            return fn.attr
        return None

    def _check_builder_call_sites(self, module: Module, emit) -> None:
        if not self._builders:
            return

        def scan_scope(fn_node, body):
            approved: set[str] = set(
                _func_params(fn_node)) if fn_node is not None else set()

            # first pass: local provenance (order-insensitive on purpose —
            # assignment position vs use position doesn't matter for a
            # conservative approval set)
            def collect(node):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    return
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    if self._approved_arg(node.value, approved):
                        approved.add(node.targets[0].id)
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Tuple) \
                        and self._approved_arg(node.value, approved):
                    # Tuple unpack of an approved call — e.g.
                    # `B, lids, shard, pos = split_shard_rows(...)`: every
                    # unpacked name carries the ladder's provenance.
                    for elt in node.targets[0].elts:
                        if isinstance(elt, ast.Name):
                            approved.add(elt.id)
                for child in ast.iter_child_nodes(node):
                    collect(child)

            # run to fixpoint: `a = active_bucket(...)` then `b = a`
            before = -1
            while len(approved) != before:
                before = len(approved)
                for stmt in body:
                    collect(stmt)

            def walk(node):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    scan_scope(node, node.body)
                    return
                builder = isinstance(node, ast.Call) and \
                    self._builder_name(node)
                if builder:
                    call_args = list(node.args) + [kw.value
                                                   for kw in node.keywords]
                    for arg in call_args:
                        if not self._approved_arg(arg, approved):
                            emit(arg, "dev-unbucketed-shape",
                                 f"{builder}() fed a raw shape value — "
                                 "every distinct value is a program of its "
                                 "own once the step is captured",
                                 "route counts through active_bucket()/"
                                 "shard_bucket() (the approved ladders) "
                                 "before they reach a program builder")
                for child in ast.iter_child_nodes(node):
                    walk(child)

            for stmt in body:
                walk(stmt)

        scan_scope(None, module.tree.body)
