"""The port's graphlint (``paddle_tpu_torch/analysis/lint.py``, ``waivers.py``,
``graphlint.py``) against the JAX package's.

On every fixture of ``tests/fixtures/lint/`` and every source of the JAX
package, the port's lint gives the JAX lint's findings, in ``(rule_id,
line, func)``. Each rule catches its torch fixture under
``tests/fixtures/lint_torch/`` (GL001 3, GL002 2, GL003 5, GL004 3, GL005
3 findings), and the clean one has none. The gate passes on the shipped
port tree and fails on a bad fixture and on an unused waiver."""
import glob
import os
import subprocess
import sys

import pytest

from paddle_tpu.analysis import lint_file as jax_lint_file
from paddle_tpu.analysis import lint_rules as jax_lint_rules
from paddle_tpu_torch.analysis import (
    LintFinding,
    Waiver,
    lint_file,
    lint_rules,
    lint_source,
    load_waivers,
    match_waiver,
)
from paddle_tpu_torch.analysis.waivers import WaiverFormatError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FIXTURES = os.path.join(REPO, "tests", "fixtures", "lint")
FIXTURES = os.path.join(REPO, "tests", "fixtures", "lint_torch")


def _keys(findings):
    return [(f.rule_id, f.line, f.func) for f in findings]


@pytest.mark.parametrize("name", sorted(os.listdir(JAX_FIXTURES)))
def test_jax_fixture_findings_equal_the_jax_lints(name):
    path = os.path.join(JAX_FIXTURES, name)
    assert _keys(lint_file(path)) == _keys(jax_lint_file(path))


def test_jax_package_sources_give_the_jax_lints_findings():
    paths = sorted(glob.glob(os.path.join(REPO, "paddle_tpu", "**", "*.py"), recursive=True)
                   + glob.glob(os.path.join(REPO, "tools", "*.py")))
    assert len(paths) > 100
    differ = [p for p in paths if _keys(lint_file(p)) != _keys(jax_lint_file(p))]
    assert differ == []


def test_the_lint_imports_the_standard_library_only():
    """Pure ``ast``: the gate needs neither torch nor a card to read a tree."""
    import ast

    from paddle_tpu_torch.analysis import lint, waivers

    for mod in (lint, waivers):
        tree = ast.parse(open(mod.__file__).read())
        names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        names |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        assert names <= {"__future__", "ast", "os", "dataclasses", "typing"}, names


def test_rule_ids_and_slugs_are_the_jax_packages():
    mine, theirs = lint_rules(), jax_lint_rules()
    assert {s: v[0] for s, v in mine.items()} == {s: v[0] for s, v in theirs.items()}
    ids = [rid for rid, _, _ in mine.values()]
    assert sorted(ids) == ["GL001", "GL002", "GL003", "GL004", "GL005"]
    for rid, desc, hint in mine.values():
        assert desc and hint


@pytest.mark.parametrize("fixture,rule_id,count", [
    ("bad_stale_flag.py", "GL001", 3),
    ("bad_unlocked.py", "GL002", 2),
    ("bad_host_sync.py", "GL003", 5),
    ("bad_weak_type.py", "GL004", 3),
    ("bad_cache_pull.py", "GL005", 3),
])
def test_torch_fixture_is_caught(fixture, rule_id, count):
    findings = lint_file(os.path.join(FIXTURES, fixture))
    assert [f.rule_id for f in findings] == [rule_id] * count
    for f in findings:
        assert f.line > 0 and f.func and f.hint


def test_torch_clean_fixture_is_clean():
    assert lint_file(os.path.join(FIXTURES, "clean.py")) == []


@pytest.mark.parametrize("src,want", [
    # the loss handed to train_step by keyword, captured
    ("def f(m, x):\n    return flag('a')\n"
     "s = train_step(m, o, loss_fn=f)\n", ["GL001"]),
    # jit=False: the step runs eagerly at every call
    ("def f(m, x):\n    return flag('a')\n"
     "s = train_step(m, o, f, jit=False)\n", []),
    # eval_step's fn, and a def nested in a capture block
    ("def g(m, x):\n    return os.environ.get('A')\n"
     "s = eval_step(m, g)\n", ["GL001"]),
    ("def h(s):\n    with compiled_step():\n        def k():\n"
     "            return FLAGS_x\n        return k()\n", ["GL001"]),
    # dtype and device pinned: made on the card once
    ("@to_static\ndef f(x):\n    return x + torch.tensor(1, dtype=torch.int64, "
     "device=x.device)\n", []),
    # a literal tensor outside any captured body is not this rule's business
    ("def f(x):\n    return x + torch.tensor(1)\n", []),
])
def test_capture_entry_points(src, want):
    assert [f.rule_id for f in lint_source(src)] == want


def test_waiver_requires_justification(tmp_path):
    wf = tmp_path / "w.txt"
    wf.write_text("a.py GL001 *\n")
    with pytest.raises(WaiverFormatError):
        load_waivers(str(wf))
    wf.write_text("a.py GL001 *  # reviewed: eager loop\n")
    ws = load_waivers(str(wf))
    assert len(ws) == 1 and ws[0].reason.startswith("reviewed")


def test_waiver_matching_scopes():
    f = LintFinding("stale-flag-read", "GL001", "paddle_tpu_torch/serving/batcher.py", 10, 0,
                    "Batcher._assemble", "m", "h")
    ws = [Waiver("paddle_tpu_torch/serving/batcher.py", "GL001", "_assemble", "r")]
    assert match_waiver(ws, f) is ws[0]
    assert ws[0].used == 1
    f2 = LintFinding("stale-flag-read", "GL001", "paddle_tpu_torch/serving/batcher.py", 11, 0,
                     "Batcher.other", "m", "h")
    assert match_waiver(ws, f2) is None


def _gate(*args):
    return subprocess.run([sys.executable, "-m", "paddle_tpu_torch.analysis.graphlint", *args],
                          capture_output=True, text=True, cwd=REPO)


def test_gate_passes_on_the_shipped_port_tree():
    r = _gate("--check")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "graphlint: clean" in r.stdout


def test_gate_fails_on_a_bad_fixture_and_an_unused_waiver(tmp_path):
    r = _gate("--check", "--no-waivers", os.path.join(FIXTURES, "bad_stale_flag.py"))
    assert r.returncode == 1 and "GL001" in r.stdout
    shipped = open(os.path.join(REPO, "paddle_tpu_torch", "analysis",
                                "graphlint_waivers.txt")).read()
    wf = tmp_path / "w.txt"
    wf.write_text(shipped + "paddle_tpu_torch/nowhere.py GL001 *  # stale\n")
    r = _gate("--check", "--waivers", str(wf))
    assert r.returncode == 1 and "UNUSED waiver" in r.stdout
    wf.write_text("paddle_tpu_torch/nowhere.py GL001 *\n")
    assert _gate("--check", "--waivers", str(wf)).returncode == 2
