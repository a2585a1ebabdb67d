"""Host-sync source lint over the port's captured scopes — AST only, no
import of the linted code.

The counterpart of ``repro.analysis.lint``, with JAX's three rule ids
and its pragma grammar (``# audit: allow(<rule>)`` on the line, on the
line above, or on or above a ``def`` line; see the package docstring).
What each rule catches in the port:

* ``host-sync`` — ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``;
  ``float()`` / ``int()`` / ``bool()`` of a non-constant; ``np.asarray``;
  ``torch.cuda.synchronize`` and any ``.synchronize()`` (a stream's, an
  event's).  On the card each one waits for the device; inside a CUDA
  graph capture it fails;
* ``traced-branch`` — a Python ``if`` / ``while`` on a value that a
  ``torch.`` call made in the same scope: a host read of the device
  (an error inside a capture).  Host metadata (``.shape``, ``.dtype``,
  ``.device``, ``.dim()``, ``.numel()``, ``.size()``, ...) and
  ``torch.is_tensor`` are not values of the device;
* ``unseeded-rng`` — numpy's global RNG (``np.random.<dist>``, a seedless
  ``np.random.default_rng()``), stdlib ``random.*``, and ``torch.rand*``
  / ``randn*`` / ``randint`` / ``normal`` without ``generator=``.

CLI::

    PYTHONPATH=src python -m repro_torch.analysis.lint [paths...]

Lints the registered scopes under ``src/repro_torch`` by default; prints
``path:line: rule-id: message`` per finding and exits non-zero if any
survive their pragmas.
"""
from __future__ import annotations

import ast
import re
import sys
from pathlib import Path
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Set, Union

RULES = ("host-sync", "traced-branch", "unseeded-rng")

# path relative to src/repro_torch -> function names, or "*" for a whole
# module.  A function listed here runs inside a CUDA graph capture or on
# the path that must not wait on the card (the episode's dispatch, a
# stream window, a decode call); any host sync inside it carries an
# explicit `# audit: allow(<rule>)` justification.
TRACED_SCOPES: Dict[str, Union[str, Set[str]]] = {
    "core/fleet.py": {
        "_key_chain", "slot_camera_keys", "_linspace_sel", "keep_selection",
        "_slot_encode", "_slot_finish", "fleet_control_step",
        "fleet_control_scan", "reducto_keep_step", "slot_front", "_finish",
        "_checked_row", "_episode_eager",
        # _EpisodeGraph's captured bodies
        "_slot_inputs", "_finish_into", "_front", "_put_cpack", "_step",
        "_full", "_drain",
    },
    "kernels/tx_codec/ops.py": {"encode_fleet", "encode_fleet_crf"},
    "core/elastic.py": {"init_state", "update", "update_scan"},
    "core/codec.py": "*",
    "core/scheduler.py": {"_episode_kwargs", "_episode_dispatch"},
    "core/utility.py": {"predict", "predict_grid", "utility_table", "fit"},
    "core/allocation.py": {
        "allocate_dp", "allocate_greedy", "allocate_fair",
        "build_utility_table",
    },
    "serve/stream.py": {"_dispatch_window"},
    # the LM's decode path: its designed syncs carry pragmas
    "models/moe.py": {"_local_moe"},
    "models/model.py": {"decode"},
    "serve/engine.py": {"step"},
}

_PRAGMA_RE = re.compile(r"#\s*audit:\s*allow\(([a-z-]+)\)")

# call roots whose results count as device values for `traced-branch`
_TRACED_ROOTS = {"torch"}
# torch calls whose results are host values (metadata, not device data)
_HOST_TORCH = {"is_tensor", "is_floating_point", "is_complex", "device",
               "Size", "finfo", "iinfo", "is_available", "device_count",
               "get_default_dtype", "is_grad_enabled", "current_stream"}
# tensor attributes and methods that read metadata, not the device
_METADATA = {"shape", "dtype", "device", "ndim", "is_cuda", "is_meta",
             "dim", "numel", "size", "element_size", "is_floating_point",
             "requires_grad", "layout"}
# numpy module aliases for the host-sync / rng rules
_NUMPY_ROOTS = {"np", "numpy"}
# method calls that read a device tensor on the host or wait for the card
_SYNC_METHODS = {
    "item": ".item() reads a device value on the host",
    "tolist": ".tolist() reads a device tensor on the host",
    "cpu": ".cpu() copies a device tensor to the host and waits for it",
    "numpy": ".numpy() reads a tensor on the host",
    "synchronize": ".synchronize() waits for the card",
}
# torch samplers that draw from the global generator without generator=
_TORCH_RNG = re.compile(r"^(rand\w*|randn\w*|randint\w*|normal)$")


class Finding(NamedTuple):
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"


def _attr_chain(node: ast.AST) -> List[str]:
    """`np.random.normal` -> ["np", "random", "normal"] (best effort)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return parts[::-1]


def _pragma_lines(source: str) -> Dict[int, Set[str]]:
    """1-based line -> rule ids allowed on that line."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        for m in _PRAGMA_RE.finditer(line):
            out.setdefault(i, set()).add(m.group(1))
    return out


def _device_values(node: ast.AST) -> Iterable[ast.AST]:
    """The sub-expressions of ``node`` that can hold device data: every
    node but those under a metadata read (``x.shape[0]``, ``x.dim()``),
    an identity test (``x is None``) or a fetch (``x.cpu()``: its value
    is on the host, and the fetch is a ``host-sync`` finding of its
    own)."""
    if isinstance(node, ast.Attribute) and node.attr in _METADATA:
        return
    if isinstance(node, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
        return
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr in _SYNC_METHODS):
        return
    yield node
    for child in ast.iter_child_nodes(node):
        yield from _device_values(child)


def _bound_names(target: ast.AST) -> Iterable[str]:
    """The names an assignment target binds or writes into: ``x``, the
    elements of ``a, b``, and ``x`` of ``x[i] = ...`` (not ``i``, nor
    ``obj`` of ``obj.attr = ...``)."""
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from _bound_names(elt)
    elif isinstance(target, ast.Starred):
        yield from _bound_names(target.value)
    elif isinstance(target, ast.Subscript):
        yield from _bound_names(target.value)


class _ScopeLinter(ast.NodeVisitor):
    """Lint one registered function body (or module when the registry
    marks the whole file)."""

    def __init__(self, path: str, findings: List[Finding]) -> None:
        self.path = path
        self.findings = findings
        self.traced_names: Set[str] = set()
        self.host_names: Set[str] = set()

    # -- device-value dataflow (one forward pass, as in the JAX linter;
    # each function starts from the names of the scope around it) ---------

    def _is_traced_expr(self, node: ast.AST) -> bool:
        for sub in _device_values(node):
            if isinstance(sub, ast.Call):
                chain = _attr_chain(sub.func)
                if (chain and chain[0] in _TRACED_ROOTS
                        and chain[-1] not in _HOST_TORCH):
                    return True
            elif isinstance(sub, ast.Name) and sub.id in self.traced_names:
                return True
        return False

    def _is_host_only(self, node: ast.AST) -> bool:
        """Built from constants, metadata reads and names bound to such
        values only (``float(N)`` after ``C, N = x.shape``)."""
        for sub in _device_values(node):
            if isinstance(sub, ast.Name) and sub.id not in self.host_names:
                return False
            if isinstance(sub, ast.Call) and not (
                    isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _METADATA):
                return False
        return True

    def visit_Assign(self, node: ast.Assign) -> None:
        names = {n for tgt in node.targets for n in _bound_names(tgt)}
        if self._is_traced_expr(node.value):
            self.traced_names |= names
            self.host_names -= names
        elif self._is_host_only(node.value):
            self.host_names |= names
            self.traced_names -= names
        self.generic_visit(node)

    def visit_FunctionDef(self, node) -> None:
        saved = (set(self.traced_names), set(self.host_names))
        self.generic_visit(node)
        self.traced_names, self.host_names = saved

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- rules ----------------------------------------------------------------

    def _add(self, node: ast.AST, rule: str, msg: str) -> None:
        self.findings.append(Finding(self.path, node.lineno, rule, msg))

    def visit_Call(self, node: ast.Call) -> None:
        chain = _attr_chain(node.func)
        dotted = ".".join(chain)
        # host-sync -----------------------------------------------------------
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _SYNC_METHODS):
            self._add(node, "host-sync", _SYNC_METHODS[node.func.attr])
        elif dotted in ("float", "int", "bool") and node.args and \
                not isinstance(node.args[0], ast.Constant) and \
                not self._is_host_only(node.args[0]):
            self._add(node, "host-sync",
                      f"{dotted}() concretizes its argument (a host read "
                      "of a device tensor, an error inside a capture)")
        elif chain[:1] and chain[0] in _NUMPY_ROOTS and dotted.endswith(
                ".asarray"):
            self._add(node, "host-sync",
                      f"{dotted} materializes on the host")
        # unseeded-rng --------------------------------------------------------
        if len(chain) >= 2 and chain[0] in _NUMPY_ROOTS and chain[1] == "random":
            if chain[-1] == "default_rng":
                if not node.args:
                    self._add(node, "unseeded-rng",
                              "np.random.default_rng() without a seed")
            else:
                self._add(node, "unseeded-rng",
                          f"{dotted} draws from numpy's global RNG state")
        elif len(chain) == 2 and chain[0] == "random":
            self._add(node, "unseeded-rng",
                      f"stdlib {dotted} draws from global RNG state")
        elif (len(chain) == 2 and chain[0] == "torch"
              and _TORCH_RNG.match(chain[1])
              and not any(k.arg == "generator" for k in node.keywords)):
            self._add(node, "unseeded-rng",
                      f"{dotted} without generator= draws from torch's "
                      "global generator")
        self.generic_visit(node)

    def _check_branch(self, node, kind: str) -> None:
        if self._is_traced_expr(node.test):
            self._add(node, "traced-branch",
                      f"Python {kind} on a device value — use torch.where "
                      "(host branching reads the device)")

    def visit_If(self, node: ast.If) -> None:
        self._check_branch(node, "if")
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._check_branch(node, "while")
        self.generic_visit(node)


def _iter_scopes(tree: ast.Module, spec: Union[str, Set[str]]
                 ) -> Iterable[ast.AST]:
    """The AST nodes to lint: the module itself for "*", else each
    (possibly nested / method) def whose name is registered."""
    if spec == "*":
        yield tree
        return
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name in spec:
            yield node


def _function_pragmas(tree: ast.Module, source: str) -> Dict[str, Set[str]]:
    """def name -> rules allowed for the WHOLE function (pragma on, or on
    the line directly above, the def line)."""
    pragmas = _pragma_lines(source)
    out: Dict[str, Set[str]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            allowed: Set[str] = set()
            for ln in range(node.lineno - 1,
                            node.body[0].lineno if node.body else node.lineno):
                allowed |= pragmas.get(ln, set())
            if allowed:
                out[node.name] = allowed
    return out


def lint_source(source: str, path: str,
                spec: Union[str, Set[str]]) -> List[Finding]:
    """Lint one file's source against a scope spec; pragma-suppressed
    findings are dropped."""
    tree = ast.parse(source, filename=path)
    pragmas = _pragma_lines(source)
    fn_pragmas = _function_pragmas(tree, source)

    def enclosing_allow(finding: Finding) -> Set[str]:
        allowed = (pragmas.get(finding.line, set())
                   | pragmas.get(finding.line - 1, set()))
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in fn_pragmas:
                end = getattr(node, "end_lineno", node.lineno)
                if node.lineno <= finding.line <= end:
                    allowed |= fn_pragmas[node.name]
        return allowed

    findings: List[Finding] = []
    seen: Set[int] = set()
    for scope in _iter_scopes(tree, spec):
        if id(scope) in seen:       # nested registered defs
            continue
        seen.add(id(scope))
        _ScopeLinter(path, findings).visit(scope)
    uniq = sorted(set(findings), key=lambda f: (f.line, f.rule, f.message))
    return [f for f in uniq if f.rule not in enclosing_allow(f)]


def lint_file(path: Path, spec: Union[str, Set[str]]) -> List[Finding]:
    return lint_source(path.read_text(), str(path), spec)


def lint_tree(src_root: Optional[Path] = None,
              scopes: Optional[Dict[str, Union[str, Set[str]]]] = None
              ) -> List[Finding]:
    """Lint every registered file under ``src/repro_torch`` (the default
    root)."""
    if src_root is None:
        src_root = Path(__file__).resolve().parents[1]
    scopes = TRACED_SCOPES if scopes is None else scopes
    findings: List[Finding] = []
    for rel, spec in sorted(scopes.items()):
        p = src_root / rel
        if not p.exists():
            findings.append(Finding(str(p), 0, "host-sync",
                                    "registered scope file missing "
                                    "(update lint.TRACED_SCOPES)"))
            continue
        findings.extend(lint_file(p, spec))
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help="files to lint with their registered scope "
                         "(default: every registered file)")
    args = ap.parse_args(argv)
    if args.paths:
        findings = []
        root = Path(__file__).resolve().parents[1]
        for raw in args.paths:
            p = Path(raw).resolve()
            rel = str(p.relative_to(root)) if p.is_relative_to(root) else raw
            spec = TRACED_SCOPES.get(rel.replace("\\", "/"))
            if spec is None:
                print(f"note: {raw} has no registered scopes; linting the "
                      "whole module")
                spec = "*"
            findings.extend(lint_file(p, spec))
    else:
        findings = lint_tree()
    for f in findings:
        print(f)
    if findings:
        print(f"lint: {len(findings)} violation(s) in registered scopes "
              "(fix, hoist out of the scope, or justify with "
              "`# audit: allow(<rule>)`)")
        return 1
    print("lint: registered scopes clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
