"""The import boundary: nothing under tee_bench imports JAX or the JAX
package (``repro``), by whole top-level name; the plain reference and what
it uses import nothing of the port either."""

import ast
import subprocess
import sys
from pathlib import Path

from teebench import runner

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# the harness files that may reach the port (the system under test)
PORT_USERS = {"program.py", "runner.py", "calibrate.py"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    return [p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts]


def test_no_file_imports_jax_or_the_jax_package():
    bad = {str(p.relative_to(HERE)): sorted(set(_imports(p)) & FORBIDDEN)
           for p in _sources()}
    assert not {k: v for k, v in bad.items() if v}


def test_only_the_program_adapter_imports_the_port():
    users = {p.name for p in _sources() if "repro_torch" in _imports(p)
             and "tests" not in p.relative_to(HERE).parts}
    assert users <= PORT_USERS, users
    for p in (HERE / "configs").glob("*.py"):
        assert "repro_torch" not in set(_imports(p))


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro_torch_lookalike" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert runner.forbidden_modules() == ["repro.core"]


def test_the_reference_runs_without_the_port():
    code = (
        "import sys; sys.path[:0] = [%r]\n"
        "from teebench import spec, weights\n"
        "import numpy as np\n"
        "cfg = dict(hidden_size=32, intermediate_size=48, "
        "num_attention_heads=2, num_key_value_heads=1, head_dim=16, "
        "num_hidden_layers=1, vocab_size=50, rope_theta=1e4, "
        "rms_norm_eps=1e-5, tie_word_embeddings=True, "
        "torch_dtype='float32', reference='dense_decoder')\n"
        "ref = spec.reference(cfg)\n"
        "out = ref.logits(cfg, 3, [np.arange(1, 9)], [(2, 8)], "
        "device='cpu')\n"
        "assert out[0].shape == (6, 50)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'repro', 'repro_torch')]\n"
        "assert not bad, bad\n") % str(HERE)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
