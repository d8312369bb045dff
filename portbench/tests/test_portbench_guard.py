"""No module of the benchmark imports JAX or the JAX package, by the
top-level name compared whole (the port's name begins with the JAX
package's); the reference imports nothing of the program; and a run's
process holds none of them once its window has closed."""
import ast
import json
import os
import subprocess
import sys

from portbench.harness import FORBIDDEN

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
PROGRAM = 'hicpeaks_tpu_torch'


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    return names


def modules(sub=''):
    for root, _, files in os.walk(os.path.join(PKG, sub)):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(root, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in modules():
        bad = top_level_imports(path) & set(FORBIDDEN)
        assert not bad, f'{path} imports {bad}'


def test_reference_imports_nothing_of_the_program():
    for sub in ('reference', 'gen'):
        for path in modules(sub):
            assert PROGRAM not in top_level_imports(path), path


def test_a_run_holds_no_jax_module(tmp_path):
    """A whole run of a tiny cell on the CPU, in a process of its own:
    the top-level modules it holds at the end include the program and
    none of FORBIDDEN."""
    code = f'''
import json, sys, time, torch
sys.path.insert(0, {REPO!r})
from portbench.tests.tiny import make_root
from portbench import harness
root = make_root({str(tmp_path)!r})
res, _ = harness.measure(harness.Cell(root, 'bhfdr-k562-10kb.genome'), 3,
                         0.1, False, torch.device('cpu'), time.perf_counter())
print(json.dumps([res['correct'],
                  sorted({{m.split('.')[0] for m in sys.modules}})]))
'''
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300, check=True)
    correct, names = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct
    assert PROGRAM in names
    assert not set(names) & set(FORBIDDEN)
