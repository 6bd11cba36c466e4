"""The port's public surface, member by member, held to the JAX package's.

Both trees are read by AST; neither package is imported, so the test runs in
well under a second and starts no kernel build. One case per module of
``mpc_local_planner_tpu/``; in it, for every public name (no leading
underscore, plus ``__init__`` and ``__call__``):

(a) each top-level function, class and module constant exists in the port's
    counterpart module (defined there or imported into it); the counterpart
    has the same relative path, except the two Pallas modules, whose
    counterparts are the CUDA modules (``PORT_MODULE``);
(b) each method, property, class attribute and dataclass field of each
    public class exists in the port's class or in one of its bases in the
    port (a member may move up the hierarchy);
(c) each parameter name of each function and method exists in the port's
    (the port may add parameters, such as ``device`` or ``dtype``, but drops
    none);
(d) each parameter default, class attribute, dataclass field and module
    constant whose value is made of literals (with arithmetic on them and
    calls of plain names, such as ``RobotLimits(...)``; with
    ``dataclasses.field(default=...)`` unwrapped) equals the port's.

``RENAMED`` (JAX name → port name) and ``BY_DESIGN`` (not ported) hold the
exceptions, each with its reason. An item is written ``path::name`` for a
top-level name, ``path::Class.member`` for a member and ``path::func(param)``
or ``path::Class.method(param)`` for a parameter. The last test holds the
tables to both trees and to the README's rename map.

``Tree`` is the one AST reader of the surface: ``tests/test_torch_surface.py``
takes each JAX ``__init__.py``'s exports from ``JAX.exports``.
"""

import ast
import re
from functools import lru_cache
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PACKAGE = ROOT / "mpc_local_planner_tpu"
PORT_PACKAGE = ROOT / "mpc_local_planner_tpu_torch"
JAX_MODULES = sorted(p.relative_to(JAX_PACKAGE).as_posix() for p in JAX_PACKAGE.glob("**/*.py"))
PORT_MODULE = {
    "ops/fused_al_sqp_pallas.py": "ops/fused_al_sqp_cuda.py",
    "ops/riccati_pallas.py": "ops/riccati_cuda.py",
}
DUNDERS = ("__init__", "__call__")

_KEY_TO_GENERATOR = "a jax.random key becomes a torch.Generator"
RENAMED = {
    "ops/fused_al_sqp_pallas.py::fused_solve": (
        "ops/fused_al_sqp_cuda.py::fused_solve_cuda", "the kernel's launcher is CUDA, not Pallas"),
    "ops/riccati_pallas.py::lqr_solve_pallas": (
        "ops/riccati_cuda.py::lqr_solve_cuda", "the kernel's launcher is CUDA, not Pallas"),
    "ops/riccati_pallas.py::make_lqr_solve_auto": (
        "ops/riccati_cuda.py::lqr_solve_auto",
        "no closure to jit: one function takes nx= and free_tau= as keywords"),
    "profiling.py::xla_trace": ("profiling.py::torch_trace", "torch.profiler, not the XLA one"),
    "solvers/al_sqp.py::solve_single": (
        "solvers/al_sqp.py::solve",
        "no vmap: solve takes one leading lane axis; make_solver(batched=False) takes one lane"),
    "solvers/al_sqp.py::solve_single_auto": (
        "solvers/al_sqp.py::make_solver", "the fused-or-not choice lives in make_solver"),
    "benchmarks.py::random_ensemble(key)": (
        "benchmarks.py::random_ensemble(generator)", _KEY_TO_GENERATOR),
    "benchmarks.py::family_ensemble(key)": (
        "benchmarks.py::family_ensemble(generator)", _KEY_TO_GENERATOR),
    "planner/serving.py::JourneyStream.init(key)": (
        "planner/serving.py::JourneyStream.init(generator)", _KEY_TO_GENERATOR),
    "planner/serving.py::StreamState.key": (
        "planner/serving.py::StreamState.generator", _KEY_TO_GENERATOR),
    "plants/simulated_plant.py::SimulatedPlant.output(key)": (
        "plants/simulated_plant.py::SimulatedPlant.output(generator)", _KEY_TO_GENERATOR),
    "plants/simulated_plant.py::SimulatedPlant.step(key)": (
        "plants/simulated_plant.py::SimulatedPlant.step(generator)", _KEY_TO_GENERATOR),
    "tasks/closed_loop.py::ClosedLoopControlTask.perform(key)": (
        "tasks/closed_loop.py::ClosedLoopControlTask.perform(generator)", _KEY_TO_GENERATOR),
    "solvers/al_sqp.py::fused_dispatch_ok(backend)": (
        "solvers/al_sqp.py::fused_dispatch_ok(device)",
        "the decision reads a torch.device, not a JAX backend name"),
}
_TILE = "the TPU's (sublane, lane) tile layout; the CUDA kernels lay out their own"
BY_DESIGN = {
    "ops/fused_al_sqp_pallas.py::SUBLANES": _TILE,
    "ops/fused_al_sqp_pallas.py::LANES": _TILE,
    "ops/fused_al_sqp_pallas.py::BT": _TILE,
    "ops/riccati_pallas.py::SUBLANES": _TILE,
    "ops/riccati_pallas.py::LANES": _TILE,
    "ops/riccati_pallas.py::BT": _TILE,
    "ops/fused_al_sqp_pallas.py::CHAINBREAK": "a timing probe whose results are wrong by design",
    "ops/fused_al_sqp_pallas.py::fused_solve(interpret)":
        "Pallas's interpret mode; fused_solve_plain takes its role",
    "ops/fused_al_sqp_pallas.py::fused_solve(debug_step)":
        "the Pallas kernel's in-kernel dumps of one step",
}


# --------------------------------------------------------------------------- #
# reading a tree
# --------------------------------------------------------------------------- #
FUNCTIONS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _public(name):
    return not name.startswith("_") or name in DUNDERS


def _statements(body):
    """The statements of a module body, those of its ``if``, ``try`` and
    ``with`` blocks included."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _statements(node.body + node.orelse)
        elif isinstance(node, ast.Try):
            yield from _statements(node.body + node.orelse + node.finalbody
                                   + [s for h in node.handlers for s in h.body])
        elif isinstance(node, ast.With):
            yield from _statements(node.body)
        else:
            yield node


def _bindings(body):
    """name -> FunctionDef, ClassDef or assigned value (None for an
    annotation alone) of each definition and plain-name assignment."""
    out = {}
    for node in body:
        if isinstance(node, (*FUNCTIONS, ast.ClassDef)):
            out.setdefault(node.name, node)  # a property's setter keeps its getter
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                for t in (target.elts if isinstance(target, ast.Tuple) else [target]):
                    if isinstance(t, ast.Name):
                        out[t.id] = node.value
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out[node.target.id] = node.value
    return out


class Tree:
    """One package read by AST: each module's bindings and imports, and each
    class's members with those of its bases in the package."""

    def __init__(self, root: Path):
        self.root, self.package = root, root.name

    @lru_cache(maxsize=None)
    def module(self, rel):
        """(bindings, imports) of module ``rel``, or None when there is
        none; imports map a name to (module, name) where the package defines
        it, else to None."""
        path = self.root / rel
        if not path.exists():
            return None
        body = list(_statements(ast.parse(path.read_text()).body))
        imports = {}
        for node in body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                for alias in node.names:
                    source = None
                    module = getattr(node, "module", None) or ""
                    if isinstance(node, ast.ImportFrom) and (
                            module + ".").startswith(self.package + "."):
                        sub = module[len(self.package) + 1:].replace(".", "/")
                        source = (f"{sub}.py" if sub else "__init__.py", alias.name)
                        if not (self.root / source[0]).exists():
                            source = (f"{sub}/__init__.py", alias.name)
                    imports[(alias.asname or alias.name).split(".")[0]] = source
        return _bindings(body), imports

    def exports(self, rel):
        """(names module ``rel`` imports, its ``__all__`` or None): the
        import surface of a package's ``__init__.py``."""
        bindings, imports = self.module(rel)
        listed = bindings.get("__all__")
        return set(imports) - {"annotations"}, None if listed is None else list(
            ast.literal_eval(listed))

    def has(self, rel, name):
        mod = self.module(rel)
        return mod is not None and (name in mod[0] or name in mod[1])

    def resolve(self, rel, name):
        """(module, node) where ``name`` of module ``rel`` is defined in the
        package, following imports; None when it is not."""
        for _ in range(8):
            mod = self.module(rel)
            if mod is None:
                return None
            if name in mod[0]:
                return rel, mod[0][name]
            if not mod[1].get(name):
                return None
            rel, name = mod[1][name]
        return None

    def members(self, rel, cls):
        """name -> node of each member of ``cls``, a ClassDef of module
        ``rel``, and of its bases in the package, the nearest first."""
        out, todo, seen = {}, [(rel, cls)], set()
        while todo:
            rel, cls = todo.pop(0)
            if id(cls) in seen:
                continue
            seen.add(id(cls))
            for name, node in _bindings(cls.body).items():
                out.setdefault(name, node)
            for base in cls.bases:
                found = self.resolve(rel, base.id) if isinstance(base, ast.Name) else None
                if found and isinstance(found[1], ast.ClassDef):
                    todo.append(found)
        return out

    def find(self, item):
        """(True, node) for a ``path::name`` or ``path::Class.member`` item
        that exists, the node None for a bare annotation or an import from
        outside the package; (False, None) when it does not exist."""
        path, qual, _ = _split(item)
        found = self.resolve(path, qual[0])
        if len(qual) == 1:
            return (True, found[1]) if found else (self.has(path, qual[0]), None)
        if found is None or not isinstance(found[1], ast.ClassDef):
            return False, None
        members = self.members(*found)
        return qual[1] in members, members.get(qual[1])


def _params(fn):
    """name -> default node (None: no default) of each parameter."""
    a = fn.args
    positional = a.posonlyargs + a.args
    defaults = [None] * (len(positional) - len(a.defaults)) + list(a.defaults)
    out = dict(zip((p.arg for p in positional), defaults))
    out.update(zip((p.arg for p in a.kwonlyargs), a.kw_defaults))
    out.update((extra.arg, None) for extra in (a.vararg, a.kwarg) if extra is not None)
    return out


_NOT_LITERAL = object()
_ARITHMETIC = (ast.Expression, ast.Constant, ast.Tuple, ast.List, ast.Dict, ast.Set, ast.Load,
               ast.UnaryOp, ast.BinOp, ast.unaryop, ast.operator, ast.keyword)


def _literal(node):
    """The value of a default or constant made of literals, arithmetic on
    them (``1.0 / 6.0``) and calls of plain names (``RobotLimits(...)``,
    read as (name, args, keywords)), with ``dataclasses.field(default=...)``
    unwrapped; ``_NOT_LITERAL`` else."""
    name = getattr(node, "func", None)
    if isinstance(node, ast.Call) and getattr(name, "attr", getattr(name, "id", None)) == "field":
        node = next((k.value for k in node.keywords if k.arg == "default"), None)
    if node is None:
        return _NOT_LITERAL
    calls = {n.func.id: id(n.func) for n in ast.walk(node)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
    if not all(isinstance(n, _ARITHMETIC) or isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
               or id(n) in calls.values() for n in ast.walk(node)):
        return _NOT_LITERAL
    names = {c: (lambda c: lambda *a, **k: (c, a, sorted(k.items())))(c) for c in calls}
    try:
        return eval(compile(ast.Expression(node), "<default>", "eval"), {"__builtins__": {}}, names)
    except (ArithmeticError, TypeError):
        return _NOT_LITERAL


def _split(item):
    """``path::Qual.name(param)`` -> (path, [qual parts], param or None)."""
    path, rest = item.split("::")
    m = re.fullmatch(r"([\w.]+)(?:\((\w+)\))?", rest)
    return path, m.group(1).split("."), m.group(2)


JAX = Tree(JAX_PACKAGE)
PORT = Tree(PORT_PACKAGE)


def _counterpart(item):
    """A JAX item's name in the port's counterpart module."""
    path, rest = item.split("::")
    return f"{PORT_MODULE.get(path, path)}::{rest}"


def _port_item(item):
    """The port's item for a JAX item: its rename, else its counterpart."""
    return RENAMED[item][0] if item in RENAMED else _counterpart(item)


def _port_has(item):
    path, qual, param = _split(item)
    exists, node = PORT.find(f"{path}::{'.'.join(qual)}")
    if param is None:
        return exists
    return isinstance(node, FUNCTIONS) and param in _params(node)


# --------------------------------------------------------------------------- #
# the walk
# --------------------------------------------------------------------------- #
def _default_problem(item, want_node, got_node):
    """(d): the port's default of ``item`` against JAX's, when JAX's is a
    literal."""
    want = _literal(want_node) if want_node is not None else _NOT_LITERAL
    if want is _NOT_LITERAL:
        return []
    got = _literal(got_node) if got_node is not None else _NOT_LITERAL
    if got is not _NOT_LITERAL and got == want and isinstance(got, bool) == isinstance(want, bool):
        return []
    return [f"(d) default differs: {item} = {want!r}, the port's "
            f"{ast.unparse(got_node) if got_node is not None else 'none'}"]


def _function_problems(item, fn):
    """(c) and (d) for the JAX function or method ``fn`` named ``item``."""
    target = _port_item(item)
    port_fn = PORT.find(target)[1]
    if not isinstance(port_fn, FUNCTIONS):
        return [f"(c) not a function in the port: {target}"]
    port_params, problems = _params(port_fn), []
    for name, default in _params(fn).items():
        p_item = f"{item}({name})"
        if p_item in BY_DESIGN:
            continue
        port_name = _split(RENAMED[p_item][0])[2] if p_item in RENAMED else name
        if port_name not in port_params:
            problems.append(f"(c) parameter missing: {p_item}")
        else:
            problems += _default_problem(p_item, default, port_params[port_name])
    return problems


def _missing(item, kind):
    """(a) or (b): None when the port has ``item`` or its rename, else the
    problem."""
    target = _port_item(item)
    if not _port_has(target):
        return f"{kind} missing: {item}" + (f" -> {target}" if item in RENAMED else "")
    return None


def surface_problems(rel):
    """Every way in which the port's counterpart of JAX module ``rel`` falls
    short of it, one string each."""
    if PORT.module(PORT_MODULE.get(rel, rel)) is None:
        return [f"module missing: {PORT_MODULE.get(rel, rel)}"]
    problems = []
    for name, node in JAX.module(rel)[0].items():
        item = f"{rel}::{name}"
        if not _public(name) or name in DUNDERS or item in BY_DESIGN:
            continue
        missing = _missing(item, "(a) name")
        if missing:
            problems.append(missing)
            continue
        if isinstance(node, FUNCTIONS):
            problems += _function_problems(item, node)
        elif not isinstance(node, ast.ClassDef):
            problems += _default_problem(item, node, PORT.find(_port_item(item))[1])
        else:
            for mname, member in _bindings(node.body).items():
                m_item = f"{item}.{mname}"
                if not _public(mname) or m_item in BY_DESIGN:
                    continue
                missing = _missing(m_item, "(b) member")
                if missing:
                    problems.append(missing)
                    continue
                if isinstance(member, FUNCTIONS):
                    problems += _function_problems(m_item, member)
                else:
                    problems += _default_problem(m_item, member, PORT.find(_port_item(m_item))[1])
    return problems


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_torch_port_has_the_jax_members(rel):
    assert surface_problems(rel) == []


# --------------------------------------------------------------------------- #
# the tables themselves
# --------------------------------------------------------------------------- #
def _jax_has(item):
    """The JAX module named in ``item`` defines what it names."""
    path, qual, param = _split(item)
    found = JAX.resolve(path, qual[0])
    if found is None or found[0] != path:
        return False
    node = found[1]
    if len(qual) > 1:
        members = _bindings(node.body) if isinstance(node, ast.ClassDef) else {}
        if qual[1] not in members:
            return False
        node = members[qual[1]]
    return param is None or isinstance(node, FUNCTIONS) and param in _params(node)


def _readme_renames():
    """The rows of the README's JAX → port map, as (JAX cell, port cell)."""
    text = (ROOT / "README.md").read_text()
    table = text.split("| JAX package | port |", 1)[1].split("\n\n", 1)[0]
    return [tuple(row.split("|")[1:3]) for row in table.strip().splitlines()[1:]]


def _leaf(item):
    _, qual, param = _split(item)
    return param or qual[-1]


def test_torch_surface_exception_tables_are_current():
    exempt = list(RENAMED) + list(BY_DESIGN)
    assert sorted(set(RENAMED) & set(BY_DESIGN)) == []
    assert all(reason for _, reason in RENAMED.values()) and all(BY_DESIGN.values())
    # every exemption names something of the JAX tree ...
    assert sorted(i for i in exempt if not _jax_has(i)) == []
    # ... that the port lacks under that name, and every rename's target exists
    assert sorted(i for i in exempt if _port_has(_counterpart(i))) == []
    assert sorted(t for t, _ in RENAMED.values() if not _port_has(t)) == []
    # the README's map names each rename: a row with both names
    rows = _readme_renames()
    named = [(re.compile(rf"\b{_leaf(i)}\b"), re.compile(rf"\b{_leaf(t)}\b"), i)
             for i, (t, _) in RENAMED.items()]
    assert sorted(i for j_re, p_re, i in named
                  if not any(j_re.search(j) and p_re.search(p) for j, p in rows)) == []
