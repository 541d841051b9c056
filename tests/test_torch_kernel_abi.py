"""The ctypes signatures of the port's kernels match their C entry points.

ctypes passes each argument as the type named in ``argtypes``; a pointer
declared ``c_int`` is cut to 32 bits and an ``int`` declared ``c_float``
arrives as garbage, and either would show only on the card. This test
parses the ``extern "C"`` block of each source under ``csrc/``
(``heatmap_kernels.cu``, ``norm_kernels.cu``) on the CPU and holds the
``_SIGNATURES`` of its module under ``kernels/`` to it: the same
functions, argument counts and kinds (pointer <-> ``c_void_p``, ``int``
<-> ``c_int``, ``float`` <-> ``c_float``).
"""

import ctypes
import os
import re

import pytest

from eve_tpu_torch.kernels import build
from eve_tpu_torch.kernels import heatmap_kernels as tkern
from eve_tpu_torch.kernels import norm_kernels

SOURCE = os.path.join(build.CSRC_DIR, 'heatmap_kernels.cu')
# Each kernel module and its source.
MODULES = ((tkern, SOURCE),
           (norm_kernels, os.path.join(build.CSRC_DIR, 'norm_kernels.cu')))
# Every entry point's module and source, by name.
ENTRY_POINTS = {name: (module, source) for module, source in MODULES
                for name in module._SIGNATURES}
KINDS = {ctypes.c_void_p: 'pointer', ctypes.c_int: 'int',
         ctypes.c_float: 'float'}


def _strip_comments(text):
    text = re.sub(r'/\*.*?\*/', ' ', text, flags=re.S)
    return re.sub(r'//[^\n]*', ' ', text)


def _extern_c_block(text):
    start = text.index('extern "C" {')
    depth, i = 0, text.index('{', start)
    for j in range(i, len(text)):
        depth += {'{': 1, '}': -1}.get(text[j], 0)
        if depth == 0:
            return text[i + 1:j]
    raise AssertionError('unterminated extern "C" block')


def _kind(param):
    param = ' '.join(param.split())
    if '*' in param:
        return 'pointer'
    ctype = re.sub(r'\b(const|volatile)\b', '', param).split()[0]
    return {'int': 'int', 'float': 'float'}[ctype]


def c_entry_points(path=SOURCE):
    """{name: [kind of each argument]} of the top-level functions."""
    block = _extern_c_block(_strip_comments(open(path).read()))
    found = {}
    depth = 0
    pos = 0
    # Only definitions at the block's top level, not calls inside bodies.
    for m in re.finditer(r'[{}]|\bint\s+(\w+)\s*\(([^)]*)\)\s*\{', block):
        if m.group(0) == '{':
            depth += 1
        elif m.group(0) == '}':
            depth -= 1
        else:
            if depth == 0:
                params = [p for p in m.group(2).split(',') if p.strip()]
                found[m.group(1)] = [_kind(p) for p in params]
            depth += 1  # the body's brace is part of the match
        pos = m.end()
    assert depth == 0 and pos
    return found


def test_every_entry_point_has_a_signature():
    entries = c_entry_points()
    assert {'eve_render_heatmaps', 'eve_soft_argmax',
            'eve_empty_kernel'} <= set(entries)
    assert set(entries) == set(tkern._SIGNATURES)
    for module, source in MODULES[1:]:
        assert set(c_entry_points(source)) == set(module._SIGNATURES)
    assert 'eve_instance_norm' in ENTRY_POINTS


@pytest.mark.parametrize('name', sorted(ENTRY_POINTS))
def test_signature_matches_c_entry_point(name):
    module, source = ENTRY_POINTS[name]
    want = c_entry_points(source)[name]
    got = [KINDS[t] for t in module._SIGNATURES[name]]
    assert got == want, '%s: ctypes %s, C %s' % (name, got, want)


def test_parser_sees_kinds_and_counts(tmp_path):
    src = tmp_path / 'k.cu'
    src.write_text(
        'namespace { int helper(int a) { return a; } }\n'
        'extern "C" {\n'
        '// int commented_out(int a) {\n'
        'int f(const void* a, void *b, int n, float x,\n'
        '      const float* c) {\n'
        '  if (n) { return helper(n); }\n'
        '  return 0;\n'
        '}\n'
        'int g(int n, float beta, void* stream) { return 0; }\n'
        '}  // extern "C"\n')
    assert c_entry_points(str(src)) == {
        'f': ['pointer', 'pointer', 'int', 'float', 'pointer'],
        'g': ['int', 'float', 'pointer']}
