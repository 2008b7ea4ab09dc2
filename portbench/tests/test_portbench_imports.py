"""What the harness runs loads neither JAX nor the JAX package, compared by
whole top-level names; the reference loads nothing of the program."""

import ast
import json
import subprocess
import sys

from conftest import REPO, SMALL

FORBIDDEN = {"jax", "jaxlib", "flax", "pytorch_toolbelt_tpu"}
REFERENCE = REPO / "portbench" / "reference"


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    code = ("import sys, time; sys.path.insert(0, '.'); from portbench import harness, control\n"
            f"r, _ = harness.run('unet32-int8.d4-5000', 7, 0.5, True, time.perf_counter(), device='cpu', "
            f"overrides={json.dumps(SMALL['unet32-int8.d4-5000'])})\nassert r['correct']")
    loaded = _modules_after(code)
    assert "pytorch_toolbelt_tpu_torch" in loaded and not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.'); from pathlib import Path\n"
            "from portbench.harness import load_module\n"
            "from portbench.reference import common, entries\n"
            "for p in sorted(Path('portbench/reference').glob('*-*.py')): load_module(p)")
    loaded = _modules_after(code)
    assert not loaded & (FORBIDDEN | {"pytorch_toolbelt_tpu_torch"})


def test_the_reference_imports_only_torch_numpy_and_itself():
    allowed = {"math", "typing", "numpy", "torch", "portbench"}
    for path in REFERENCE.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in allowed, f"{path.name} imports {name}"
                if name.startswith("portbench"):
                    assert name in ("portbench", "portbench.reference"), f"{path.name} imports {name}"
