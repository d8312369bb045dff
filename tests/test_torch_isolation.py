"""Static check that the port stands alone: no ``.py`` file under
hicpeaks_tpu_torch/, and not chip_smoke.py, imports ``jax``, ``h5py`` or
``hicpeaks_tpu``, or names a path into ``hicpeaks_tpu/`` or ``native/``.

Docstrings may name the JAX counterparts, and a ``file:line`` label of a
TPU kernel (chip_smoke.py's ``replaces`` field) is a reference, not a path
that is read; every other string constant is checked."""
import ast
import os
import re

import pytest

from .torch_threads import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, 'hicpeaks_tpu_torch')

_FORBIDDEN_MODULES = ('jax', 'hicpeaks_tpu', 'h5py')
_PATH_RE = re.compile(r'(^|[/\\])(hicpeaks_tpu|native)([/\\]|$)')
_LABEL_RE = re.compile(r'^hicpeaks_tpu/[\w/]+\.py:\d+$')


def _port_files():
    out = [os.path.join(REPO, 'chip_smoke.py')]
    for root, _, files in os.walk(PKG):
        out.extend(os.path.join(root, f) for f in sorted(files)
                   if f.endswith('.py'))
    return sorted(out)


def _docstring_nodes(tree):
    ids = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and \
                    isinstance(first.value, ast.Constant) and \
                    isinstance(first.value.value, str):
                ids.add(id(first.value))
    return ids


def _forbidden_module(name):
    return name is not None and any(
        name == m or name.startswith(m + '.') for m in _FORBIDDEN_MODULES)


def violations(path):
    """(line, what) for every forbidden import or path string in a file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    docs = _docstring_nodes(tree)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [(node.lineno, f'import {a.name}') for a in node.names
                      if _forbidden_module(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and _forbidden_module(node.module):
                found.append((node.lineno, f'from {node.module} import'))
        elif isinstance(node, ast.Call):
            # importlib.import_module('jax...') / __import__('hicpeaks_tpu')
            fn = node.func
            fname = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, 'id', None)
            if fname in ('import_module', '__import__') and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    _forbidden_module(node.args[0].value):
                found.append((node.lineno,
                              f'{fname}({node.args[0].value!r})'))
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            if id(node) in docs or _LABEL_RE.match(node.value):
                continue
            if node.value in ('hicpeaks_tpu', 'native') or \
                    _PATH_RE.search(node.value):
                found.append((node.lineno, f'path string {node.value!r}'))
    return found


@pytest.mark.parametrize('path', _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_file_imports_nothing_of_jax_or_the_jax_package(path):
    bad = violations(path)
    assert not bad, f'{os.path.relpath(path, REPO)}: {bad}'


@pytest.mark.parametrize('src', [
    'import jax.numpy as jnp',
    'from hicpeaks_tpu.core import poolplan',
    'import hicpeaks_tpu',
    'import h5py',
    'from h5py import File',
    'importlib.import_module("hicpeaks_tpu.io.synth")',
    'p = os.path.join(ROOT, "native", "libbandbuild.so")',
    'p = "hicpeaks_tpu/io/synth.py"',
    'p = f"{root}/native/Makefile"',
])
def test_checker_flags_each_kind_of_fault(tmp_path, src):
    f = tmp_path / 'mod.py'
    f.write_text('"""hicpeaks_tpu/ops/band.py in a docstring is fine."""\n'
                 'REF = "hicpeaks_tpu/ops/pallas_scan.py:141"\n' + src + '\n')
    bad = violations(str(f))
    assert [line for line, _ in bad] == [3], bad


def _imports_thread_fixture(tree):
    return any(isinstance(node, ast.ImportFrom) and node.level == 1
               and node.module == 'torch_threads'
               and any(a.name == 'one_intra_op_thread' for a in node.names)
               for node in ast.walk(tree))


def test_every_port_test_module_runs_on_one_intra_op_thread():
    """Every tests/test_torch_*.py imports the shared one-thread fixture
    (tests/torch_threads.py), and that module imports nothing but pytest
    and torch, as the card's host runs these files without JAX."""
    tests = os.path.join(REPO, 'tests')
    missing = []
    for name in sorted(os.listdir(tests)):
        if name.startswith('test_torch_') and name.endswith('.py'):
            with open(os.path.join(tests, name)) as f:
                if not _imports_thread_fixture(ast.parse(f.read(), name)):
                    missing.append(name)
    assert not missing, f'without the shared thread fixture: {missing}'
    with open(os.path.join(tests, 'torch_threads.py')) as f:
        tree = ast.parse(f.read())
    names = {a.name for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names}
    assert not any(isinstance(node, ast.ImportFrom)
                   for node in ast.walk(tree))
    assert names == {'pytest', 'torch'}, names
