"""The import guard, and the reference's independence from the program."""

import ast
import subprocess
import sys

from portbench import guard, run


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded({"jax.numpy": 0, "iterative_solvers_tpu.core": 0}) == [
        "iterative_solvers_tpu", "jax"]
    assert guard.forbidden_loaded({"iterative_solvers_tpu_torch.api": 0, "jaxtyping": 0,
                                   "flaxen": 0, "torch": 0}) == []


def test_a_run_loads_nothing_forbidden():
    code = ("import time, sys\n"
            "from portbench.tests._cells import run_small\n"
            "res, _ = run_small('gamma2d.mg_8192', trace=True)\n"
            "from portbench import guard\n"
            "print(res['correct'], guard.forbidden_loaded())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "True []"


def test_reference_imports_nothing_of_the_program():
    for path in (run.ROOT / "portbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("iterative_solvers_tpu_torch",
                                                  *guard.FORBIDDEN), (path, name)
    code = ("import sys, portbench.reference.poisson\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'iterative_solvers_tpu_torch', 'iterative_solvers_tpu', 'jax'}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.stdout.strip() == "[]", p.stderr[-2000:]
