"""A run loads neither JAX nor the JAX package, and the reference loads
nothing of the measured program.

Module names are compared by their whole top-level name: the program's
name begins with the JAX package's."""

import ast
import json
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.tiny import CELLS

REFERENCE = os.path.join(harness.HERE, 'reference')
PROGRAM = 'eve_tpu_torch'


def _python(code):
    env = dict(os.environ, PYTHONPATH=harness.ROOT)
    out = subprocess.run([sys.executable, '-c', code], cwd=harness.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize('cell', CELLS)
def test_a_run_loads_no_jax(cell):
    got = _python(
        'import json, sys\n'
        'from benchmark import harness\n'
        'from benchmark.tests import tiny\n'
        'r = tiny.measure(%r, seconds=1.0, trace=1)\n'
        'print(json.dumps({"correct": r["correct"],\n'
        '                  "loaded": harness.forbidden_modules(),\n'
        '                  "program": "eve_tpu_torch" in sys.modules}))\n'
        % cell)
    assert got['loaded'] == []
    assert got['program'] and got['correct']


def test_forbidden_names_are_whole_top_level_names():
    sys.modules.setdefault('eve_tpu_torch_lookalike', sys)
    try:
        assert 'eve_tpu_torch_lookalike' not in harness.forbidden_modules()
    finally:
        sys.modules.pop('eve_tpu_torch_lookalike', None)


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for name in sorted(os.listdir(REFERENCE)):
        if name.endswith('.py'):
            for module in _imported(os.path.join(REFERENCE, name)):
                top = module.split('.')[0]
                assert top not in harness.FORBIDDEN + (PROGRAM,), (name,
                                                                   module)
    got = _python(
        'import json, sys\n'
        'import benchmark.reference.eve, benchmark.reference.train\n'
        'import benchmark.reference.flops, benchmark.reference.precision\n'
        'print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))\n')
    assert not set(got) & set(harness.FORBIDDEN + (PROGRAM,))
