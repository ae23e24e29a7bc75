"""No part of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program."""

from __future__ import annotations

import ast
import sys

import pytest

from bench_port import harness


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(harness.HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax(path):
    assert not _imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted(
    (harness.HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    allowed = set(sys.stdlib_module_names) | {"numpy", "torch"}
    assert _imports(path) <= allowed


def test_loaded_forbidden_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "dream_go_tpu_like", object())
    monkeypatch.setitem(sys.modules, "jaxlib_free", object())
    assert "dream_go_tpu_like" not in harness.loaded_forbidden()
    assert "jaxlib_free" not in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "dream_go_tpu.ops", object())
    assert "dream_go_tpu.ops" in harness.loaded_forbidden()


def test_run_fails_without_a_card(monkeypatch, capsys):
    import torch

    from bench_port import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "train.dg128x9", "--seed", "1",
                  "--seconds", "1"])
    assert e.value.code != 0
    assert capsys.readouterr().out == ""
