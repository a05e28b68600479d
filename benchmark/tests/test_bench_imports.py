"""A static check over ``benchmark/``: no module imports JAX or the JAX
package, compared by whole top-level names (the port's
``stemgnn_tpu_torch`` begins with the JAX package's name), and the plain
references import nothing of the program."""

import ast
import glob
import os

from benchmark import common

FORBIDDEN = {"jax", "jaxlib", "flax", "stemgnn_tpu"}
PROGRAM = "stemgnn_tpu_torch"


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module
            for a in node.names:
                yield f"{node.module}.{a.name}"
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__" and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def _files():
    return sorted(glob.glob(os.path.join(common.HERE, "**", "*.py"),
                            recursive=True))


def test_no_module_imports_jax_or_the_jax_package():
    found = {}
    for path in _files():
        tops = {m.split(".", 1)[0] for m in _imports(path)}
        if tops & FORBIDDEN:
            found[path] = sorted(tops & FORBIDDEN)
    assert not found, found
    assert len(_files()) > 10


def test_the_check_tells_the_port_from_the_jax_package():
    assert PROGRAM.split(".", 1)[0] not in FORBIDDEN
    assert "stemgnn_tpu.ops".split(".", 1)[0] in FORBIDDEN


def _reference_closure():
    """The plain references and every benchmark module they import."""
    todo = sorted(glob.glob(os.path.join(common.HERE, "configs", "*.py")))
    seen = set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for mod in _imports(path):
            if mod.split(".", 1)[0] == "benchmark":
                rel = mod.split(".")[1:]
                cand = os.path.join(common.HERE, *rel) + ".py"
                if os.path.exists(cand):
                    todo.append(cand)
    return seen


def test_references_import_nothing_of_the_program():
    closure = _reference_closure()
    assert any(p.endswith("plain.py") for p in closure)
    for path in closure:
        tops = {m.split(".", 1)[0] for m in _imports(path)}
        assert PROGRAM not in tops and not tops & FORBIDDEN, path
