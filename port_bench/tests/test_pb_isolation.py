"""Nothing of the benchmark loads JAX or the JAX package, and the plain
reference imports nothing of the program."""

import ast
import subprocess
import sys

from port_bench import harness

CHECK = """
import importlib.util, sys
from pathlib import Path
import port_bench.run, port_bench.calibrate, port_bench.faults
import port_bench.drivers.embed, port_bench.drivers.train
import port_bench.drivers.eval
import port_bench.reference.encoder, port_bench.reference.policy
for path in Path("port_bench/metrics").glob("*.py"):
    port_bench.run.reader(path.name[:-3])
bad = sorted({n.split(".")[0] for n in sys.modules
              if n.split(".")[0] in ("jax", "jaxlib", "flax",
                                     "pvr_habitat_tpu")})
assert "pvr_habitat_tpu_torch" in {n.split(".")[0] for n in sys.modules}
print(",".join(bad))
"""


def test_no_jax_in_the_process():
    out = subprocess.run([sys.executable, "-c", CHECK],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == ""


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"pvr_habitat_tpu_torch", "pvr_habitat_tpu",
                           "jax", "jaxlib", "flax"}, path


def test_forbidden_names_compare_whole_top_level():
    from port_bench.run import forbidden_modules

    saved = dict(sys.modules)
    try:
        sys.modules["pvr_habitat_tpu_torch.fake"] = sys
        assert "pvr_habitat_tpu" not in forbidden_modules()
        sys.modules["pvr_habitat_tpu.fake"] = sys
        assert forbidden_modules() == ["pvr_habitat_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
