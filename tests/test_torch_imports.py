"""The port imports neither JAX nor anything of eve_tpu.

A subprocess imports every module of ``eve_tpu_torch`` and then checks
``sys.modules``; an AST walk checks that no file of the package, and not
``chip_smoke.py``, names ``jax``, ``flax``, ``optax`` or ``eve_tpu`` in an
import. The same subprocess checks that importing the package pulls in
neither ``h5py``, ``cv2`` nor ``gspread``, which the card's machine does
not have: the dataset reader, the overlay and the Google Sheets logger
import them where they read, draw or log.
"""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, 'eve_tpu_torch')
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'eve_tpu')
# Host libraries of the reader, the overlay and the Google Sheets logger,
# imported on first use.
LAZY = ('h5py', 'cv2', 'gspread', 'oauth2client')


def _package_files():
    for dirpath, _, files in os.walk(PACKAGE):
        for name in sorted(files):
            if name.endswith('.py'):
                yield os.path.join(dirpath, name)


def _module_names():
    for path in _package_files():
        rel = os.path.relpath(path, ROOT)[:-len('.py')].split(os.sep)
        if rel[-1] == '__init__':
            rel = rel[:-1]
        yield '.'.join(rel)


def test_importing_every_module_pulls_in_no_jax():
    modules = sorted(_module_names())
    assert {'eve_tpu_torch.serve', 'eve_tpu_torch.data.dataset',
            'eve_tpu_torch.cli.inference', 'eve_tpu_torch.cli.train',
            'eve_tpu_torch.train.gsheet',
            'eve_tpu_torch.data.framecache',
            'eve_tpu_torch.models.refine_net_tpu', 'eve_tpu_torch.export',
            'eve_tpu_torch.cli.export_model',
            'eve_tpu_torch.utils.tensors',
            'eve_tpu_torch.parallel', 'eve_tpu_torch.parallel.mesh'} <= set(
                modules)
    code = (
        'import importlib, json, sys\n'
        'for m in %r:\n'
        '    importlib.import_module(m)\n'
        'print(json.dumps(sorted(m for m in sys.modules\n'
        '    if m.split(".")[0] in %r)))\n' % (modules, FORBIDDEN + LAZY))
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == '[]', out.stdout


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


@pytest.mark.parametrize('path', list(_package_files()) + [
    os.path.join(ROOT, 'chip_smoke.py')],
    ids=lambda p: os.path.relpath(p, ROOT))
def test_no_file_imports_jax_or_eve_tpu(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, '%s imports %s' % (path, bad)
