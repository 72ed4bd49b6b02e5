"""What the harness and its references import: never JAX or the JAX
package (top-level names compared whole, since the port's name begins
with the JAX package's), and the references nothing of the port."""

import ast
import json
import subprocess
import sys

from perfbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "raft_tpu"}


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_sources_name_no_forbidden_module():
    for path in spec.HERE.rglob("*.py"):
        assert not _top_level_imports(path) & FORBIDDEN, path
    for path in (spec.HERE / "reference").rglob("*.py"):
        assert "raft_tpu_torch" not in _top_level_imports(path), path


def test_harness_loads_no_forbidden_module():
    loaded = _loaded(
        "import json, sys\n"
        "import perfbench.run, perfbench.series, perfbench.control\n"
        "from perfbench import spec\n"
        "for kind in ('systems', 'loops', 'reference', 'metrics'):\n"
        "    for p in sorted((spec.HERE / kind).glob('*.py')):\n"
        "        spec.module(kind, p.stem)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "raft_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    loaded = _loaded(
        "import json, sys\n"
        "from perfbench import spec\n"
        "for p in sorted((spec.HERE / 'reference').glob('*.py')):\n"
        "    spec.module('reference', p.stem)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not loaded & (FORBIDDEN | {"raft_tpu_torch"})


def test_forbidden_check_compares_whole_names(monkeypatch):
    from perfbench import run

    monkeypatch.setitem(sys.modules, "raft_tpu_torch_like", sys)
    assert "raft_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "raft_tpu.core", sys)
    assert run.forbidden_modules() == ["raft_tpu"]
