"""Nothing the benchmark runs loads JAX or the JAX package, the program is
imported only by the entry, the frontend kinds (``frontends/``) and the
span reader, and the plain reference (``reference/`` and its subfolders)
loads nothing of the program. Modules are compared by their whole
top-level name (the part before the first dot): the port's name begins
with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "eacham_tpu"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = [p for p in HERE.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        bad = top_level_imports(p) & FORBIDDEN
        assert not bad, f"{p.relative_to(HERE)} imports {bad}"


def test_only_the_entry_side_imports_the_program():
    importers = {p.relative_to(HERE).as_posix() for p in HERE.rglob("*.py")
                 if "tests" not in p.parts and "eacham_tpu_torch" in top_level_imports(p)}
    assert {"entry.py", "frontends/dog.py"} <= importers
    assert all(p in ("entry.py", "spans.py") or p.startswith("frontends/")
               for p in importers), importers


def test_whole_names_are_compared():
    assert "eacham_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "eacham_tpu.sfm".split(".")[0] in FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    files = list((HERE / "reference").rglob("*.py"))
    assert HERE / "reference" / "frontends" / "dog.py" in files
    for p in files:
        names = top_level_imports(p)
        assert not names & (FORBIDDEN | {"eacham_tpu_torch"}), f"{p.name}: {names}"
        assert names <= {"__future__", "math", "numpy", "torch", "sfmbench"}, f"{p.name}: {names}"
    # and at run time: loading it loads no module of the program
    code = ("import sys; sys.path.insert(0, %r); "
            "import sfmbench.reference.judge, sfmbench.reference.frontends.dog; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('eacham_tpu_torch', 'eacham_tpu', 'jax')]; print(bad); assert not bad"
            % str(HERE.parent))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_a_run_refuses_a_process_holding_jax(monkeypatch):
    from sfmbench import run

    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert run.forbidden_modules() == ["jaxlib.xla_client"]
