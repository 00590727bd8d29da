"""Nothing the harness loads is JAX or the JAX package, and the reference
loads nothing of the program.  Top-level module names (before the first
dot) are compared whole: the port's name begins with the JAX package's."""
import ast
import glob
import json
import os
import subprocess
import sys

from benchmark import run
from benchmark.harness import cells

JAX_SIDE = {"jax", "jaxlib", "flax", "deep3dmap_tpu"}
PORT = "deep3dmap_tpu_torch"


def _top_names(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=cells.ROOT, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_program():
    names = _top_names("import benchmark.reference.neuralrecon, benchmark.reference.optim")
    assert not names & (JAX_SIDE | {PORT})


def test_a_whole_run_loads_no_jax():
    """A cell driven end to end on the CPU (the program, the reference, the
    trace, the readers) leaves no module of JAX or the JAX package loaded."""
    names = _top_names(
        "import time\n"
        "from benchmark.tests.tiny import tiny_cell\n"
        "from benchmark.harness import drivers\n"
        "c = tiny_cell('nr_scannet.stream')\n"
        "drivers.run_cell(c, 3, 0.1, True, 'cpu', time.perf_counter())\n")
    assert PORT in names
    assert not names & JAX_SIDE


def test_sources_import_no_jax():
    """The benchmark's own sources name no JAX module in an import; the
    reference's name none of the program's."""
    bench = cells.BENCH_DIR
    for path in glob.glob(os.path.join(bench, "**", "*.py"), recursive=True):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                mods = [node.module]
            tops = {m.split(".")[0] for m in mods}
            assert not tops & JAX_SIDE, (path, mods)
            if os.sep + "reference" + os.sep in path:
                assert PORT not in tops, (path, mods)


def test_run_flags_jax_by_whole_top_level_name(monkeypatch):
    fake = dict(sys.modules)
    fake.update({"deep3dmap_tpu_torch.ops": sys, "jaxtyping": sys})
    monkeypatch.setattr(sys, "modules", fake)
    assert run.loaded_forbidden() == []
    fake["deep3dmap_tpu.ops.x"] = sys
    fake["jax"] = sys
    assert run.loaded_forbidden() == ["deep3dmap_tpu", "jax"]
