"""Nothing the benchmark runs loads JAX or the JAX package, compared by the
whole top-level module name, and the reference loads nothing of the
program."""

import ast
import pathlib
import subprocess
import sys

from portbench.tests.conftest import REPO

PKG = REPO / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "qpsk_tpu"}


def _imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax():
    for path in PKG.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").glob("*.py"):
        assert "qpsk_tpu_torch" not in _imports(path), path
    code = ("import sys; import portbench.reference.rx, "
            "portbench.reference.packet, portbench.reference.fdm; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & (FORBIDDEN | {"qpsk_tpu_torch"})


def test_a_run_loads_no_jax(tiny_root):
    code = (
        "import sys, time, torch\n"
        "from portbench import harness\n"
        "from portbench.run import forbidden_modules\n"
        f"r = harness.run(__import__('pathlib').Path({str(tiny_root)!r}), "
        "'qpsk2400-conv.tinycoded', 3, 0.1, False, torch.device('cpu'), "
        "time.perf_counter())\n"
        "assert r['correct'], r\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole(monkeypatch):
    import types

    from portbench.run import forbidden_modules
    monkeypatch.setitem(sys.modules, "qpsk_tpu_torch.fake_mod",
                        types.ModuleType("qpsk_tpu_torch.fake_mod"))
    assert "qpsk_tpu_torch.fake_mod" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "qpsk_tpu.fake_mod",
                        types.ModuleType("qpsk_tpu.fake_mod"))
    assert "qpsk_tpu.fake_mod" in forbidden_modules()
