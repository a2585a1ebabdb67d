"""The port's host-sync lint (``repro_torch.analysis.lint``) against the
JAX package's (``repro.analysis.lint``): every fixture of
``tests/test_audit.py`` gives the same (rule, line) findings under both
linters (the port's reads the snippet with JAX's calls replaced by their
torch counterparts, line for line), the pragma grammar cases agree, the
torch-only rules fire, an ``.item()`` injected into ``fleet.slot_front``
is caught, and the live port tree lints clean with a reason on every
pragma."""
import ast
import re
from pathlib import Path

import pytest

from repro.analysis.lint import lint_source as jax_lint
from repro_torch.analysis import lint as lint_mod
from repro_torch.analysis.lint import RULES, lint_source
from test_audit import BAD_FIXTURES, CLEAN_FIXTURES

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch"

# JAX calls in the fixtures -> their torch counterparts, each on one line
TORCH_OF = (("jax.device_get(x)", "x.cpu()"),
            (".block_until_ready()", ".synchronize()"),
            ("jax.random.PRNGKey(0)", "torch.Generator().manual_seed(0)"),
            ("jax.lax.cond", "torch.cond"),
            ("jnp.", "torch."))


def to_torch(snippet: str) -> str:
    out = snippet
    for old, new in TORCH_OF:
        out = out.replace(old, new)
    assert "jax" not in out and "jnp" not in out, out
    assert out.count("\n") == snippet.count("\n")
    return out


def hits(findings):
    return sorted((f.rule, f.line) for f in findings)


@pytest.mark.parametrize("rule,line,snippet", BAD_FIXTURES)
def test_bad_fixture_same_findings_as_jax(rule, line, snippet):
    want = hits(jax_lint(snippet, "fixture.py", {"f"}))
    got = hits(lint_source(to_torch(snippet), "fixture.py", {"f"}))
    assert got == want
    assert (rule, line) in got


@pytest.mark.parametrize("snippet", CLEAN_FIXTURES)
def test_clean_fixture_same_findings_as_jax(snippet):
    assert jax_lint(snippet, "fixture.py", {"f"}) == []
    assert lint_source(to_torch(snippet), "fixture.py", {"f"}) == []


def test_outside_registered_scope_is_ignored():
    assert lint_source(to_torch(BAD_FIXTURES[0][2]), "fixture.py",
                       {"other"}) == []


# -- rules only the port's linter has ---------------------------------------

TORCH_BAD = [
    ("host-sync", 3, "def f(x):\n    y = torch.sum(x)\n    return y.tolist()\n"),
    ("host-sync", 2, "def f(x):\n    return x.cpu()\n"),
    ("host-sync", 2, "def f(x):\n    return x.numpy()\n"),
    ("host-sync", 2, "def f(x):\n    return bool(x)\n"),
    ("host-sync", 3, "def f(x):\n    y = x * 2\n    torch.cuda.synchronize()\n"),
    ("traced-branch", 3, "def f(x):\n    m = torch.amax(x)\n"
                         "    if m > 0:\n        return m\n    return x\n"),
    ("traced-branch", 3, "def f(x):\n    y = torch.where(x > 0, x, 0)\n"
                         "    while y.any():\n        y = y - 1\n"
                         "    return y\n"),
    ("unseeded-rng", 2, "def f(n):\n    return torch.randn(n)\n"),
    ("unseeded-rng", 2, "def f(n):\n    return torch.randint(0, 4, (n,))\n"),
    ("unseeded-rng", 2, "def f(n):\n    return torch.rand(n, n)\n"),
]

TORCH_CLEAN = [
    # a seeded generator; shape metadata; an identity test; a fetched
    # value on the host is not a device value
    "def f(n, g):\n    return torch.randn(n, generator=g)\n",
    "def f(x):\n    y = torch.zeros(3)\n    if y.shape[0] > 2 and y.dim() == 1:\n"
    "        return float(y.shape[0])\n    return x\n",
    "def f(x):\n    y = torch.sum(x)\n    if y is None:\n        return x\n"
    "    return y\n",
    "def f(x):\n    C, N = x.shape\n    return x / float(N)\n",
]


@pytest.mark.parametrize("rule,line,snippet", TORCH_BAD)
def test_torch_bad_fixture(rule, line, snippet):
    assert (rule, line) in hits(lint_source(snippet, "fixture.py", {"f"}))


@pytest.mark.parametrize("snippet", TORCH_CLEAN)
def test_torch_clean_fixture(snippet):
    assert lint_source(snippet, "fixture.py", {"f"}) == []


# -- pragma grammar (tests/test_audit.py's cases, under both linters) -------

PRAGMA_CASES = [
    ("def f(x):\n    return float(x)  # audit: allow(host-sync) fixture "
     "justification\n", []),
    ("def f(x):\n    # audit: allow(host-sync) fixture justification\n"
     "    return float(x)\n", []),
    ("# audit: allow(host-sync) whole-function justification\ndef f(x):\n"
     "    y = float(x)\n    return int(y)\n", []),
    ("def f(x):\n    return float(x)  # audit: allow(traced-branch) wrong "
     "id\n", ["host-sync"]),
    ("def f(x):\n    return float(x)  # audit: allow\n", ["host-sync"]),
]


@pytest.mark.parametrize("src,rules", PRAGMA_CASES)
def test_pragma_grammar_as_jax(src, rules):
    want = [f.rule for f in jax_lint(src, "fixture.py", {"f"})]
    got = [f.rule for f in lint_source(src, "fixture.py", {"f"})]
    assert got == want == rules


# -- the live tree ------------------------------------------------------------

def test_injected_item_in_slot_front_fails():
    src = (SRC / "core" / "fleet.py").read_text()
    anchor = re.search(r"\n(    reconnect = live_t & ~carry\.live_prev)\n",
                       src)
    assert anchor, "fleet.slot_front anchor line moved; update this test"
    injected = (src[:anchor.end(1)] + "\n    _probe = W_t.item()"
                + src[anchor.end(1):])
    inj_line = injected[:injected.index("_probe = W_t.item()")].count(
        "\n") + 1
    findings = lint_source(injected, "core/fleet.py",
                           lint_mod.TRACED_SCOPES["core/fleet.py"])
    assert [(f.rule, f.line) for f in findings] == [("host-sync", inj_line)]
    assert lint_source(src, "core/fleet.py",
                       lint_mod.TRACED_SCOPES["core/fleet.py"]) == []


def test_live_port_tree_lints_clean():
    findings = lint_mod.lint_tree()
    assert findings == [], "\n".join(str(f) for f in findings)
    assert lint_mod.main([]) == 0


def test_registry_functions_exist():
    for rel, spec in lint_mod.TRACED_SCOPES.items():
        path = SRC / rel
        assert path.exists(), rel
        if spec == "*":
            continue
        defs = {n.name for n in ast.walk(ast.parse(path.read_text()))
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        assert not set(spec) - defs, (rel, set(spec) - defs)


def test_every_pragma_names_a_rule_and_a_reason():
    pragma = re.compile(r"#\s*audit:\s*allow\(([a-z-]+)\)(.*)$")
    seen = 0
    for path in SRC.rglob("*.py"):
        if path.parent.name == "analysis":
            continue          # the linter's own docs and messages
        for line in path.read_text().splitlines():
            m = pragma.search(line)
            if m:
                seen += 1
                assert m.group(1) in RULES, (path, line)
                assert len(m.group(2).strip()) >= 10, (path, line)
    assert seen >= 15
