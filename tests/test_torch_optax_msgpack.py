"""The port's msgpack decoder (``utils/msgpack_tree.py``) against flax's
encoder, and eve_tpu's older ``optimizer_0.msgpack`` read through it.

- For every chain layout of ``tests/test_torch_optax_export.py``, an
  eve_tpu optax state (``build_optimizer(...).init`` of the full-width
  tree, every leaf then filled from a seeded stream) packed by
  ``flax.serialization.to_bytes`` decodes to the keys, dtypes and values
  of eve_tpu's ``flatten_tree`` (the npz route), bitwise, and
  ``optax_optimizer_tree`` makes the same port optimizer tree of both.
- Arrays that flax chunks (``MAX_CHUNK_SIZE`` patched to a few bytes)
  join back; numpy scalars, Python scalars, bfloat16 leaves (a
  ``torch.bfloat16`` tensor of the same bits), and map keys packed as str
  or as bin decode as ``msgpack_restore`` gives them.
- Anything outside the subset flax writes raises, naming the type byte.
- Importing the package never imports ``msgpack``
  (``tests/test_torch_imports.py``).
"""

import msgpack
import numpy as np
import pytest
import torch

import flax.serialization
import jax
import jax.numpy as jnp

from eve_tpu.train.checkpoint import flatten_tree as jflatten
from eve_tpu_torch.train import checkpoint as tckpt
from eve_tpu_torch.utils import msgpack_tree
from tests import test_torch_optax_export as tx_export
from tests import test_torch_train_moments as tm
from tests.test_torch_train_moments import (  # noqa: F401
    _few_threads, initial_tree)


def _filled(state, seed, updates, mini_step):
    """``state`` with every float leaf drawn from a seeded stream (the
    second moments positive), the counts ``updates`` and ``mini_step``."""
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if leaf.dtype == jnp.int32:
            return np.int32(mini_step if 'mini_step' in name else updates)
        v = rs.normal(size=leaf.shape).astype(leaf.dtype)
        return np.abs(v) if '.nu' in name else v

    return jax.tree_util.tree_map_with_path(fill, state)


@pytest.mark.parametrize('layout', sorted(tx_export.STRUCTURE))
def test_msgpack_route_is_the_npz_route(layout, initial_tree):
    json_name, extra, _ = tx_export.STRUCTURE[layout]
    tx, tc = tm._configs(json_name, dict(tx_export.BASE, **extra))
    subs = ['eye_net'] + (['refine_net'] if tc.refine_net_enabled else [])
    tree = {k: initial_tree[k] for k in subs}
    accumulation = tc.gradient_accumulation_steps
    mini_step = 1 if accumulation > 1 else 0
    opt_state = _filled(tx.init(tree), 5, 2, mini_step)
    npz = jflatten(opt_state)
    decoded = tckpt.flatten_tree(msgpack_tree.loads(
        flax.serialization.to_bytes(opt_state)))
    assert sorted(decoded) == sorted(npz)
    for k, v in npz.items():
        assert decoded[k].dtype == v.dtype, k
        np.testing.assert_array_equal(decoded[k], v, err_msg=k)
    state = tm._port_state(tc, tree)
    state.step = 2 * accumulation + mini_step
    a = tckpt.optax_optimizer_tree(state, npz)
    b = tckpt.optax_optimizer_tree(state, decoded)
    for part in ('state', 'grad'):
        assert a[part].keys() == b[part].keys()
    assert a['state'] and bool(a['grad']) == bool(mini_step)
    for name, values in a['state'].items():
        for k, v in values.items():
            assert b['state'][name][k].dtype == v.dtype
            np.testing.assert_array_equal(b['state'][name][k], v,
                                          err_msg=name + k)
    for name, g in a['grad'].items():
        np.testing.assert_array_equal(b['grad'][name], g, err_msg=name)


def test_chunked_arrays_join(monkeypatch):
    monkeypatch.setattr(flax.serialization, 'MAX_CHUNK_SIZE', 12)
    tree = {'a': np.arange(30, dtype=np.float32).reshape(2, 3, 5),
            'b': {'c': np.arange(7, dtype=np.int64), 'd': np.float32(1.5)},
            'e': np.ones((3,), np.float32)}
    data = flax.serialization.msgpack_serialize(tree)
    assert b'__msgpack_chunked_array__' in data
    got, want = msgpack_tree.loads(data), flax.serialization.msgpack_restore(
        data)
    for k in ('a', 'e'):
        assert got[k].dtype == want[k].dtype and got[k].shape == (
            want[k].shape)
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got['b']['c'], tree['b']['c'])
    assert got['b']['d'] == np.float32(1.5)


def test_scalars_bfloat16_and_keys():
    tree = {'f32': np.float32(2.5), 'i8': np.int8(-3), 'u64': np.uint64(7),
            'bool': np.bool_(True), 'zero_d': np.asarray(4, np.int32),
            'py': {'int': 5, 'neg': -40, 'big': 2 ** 40, 'float': 0.1,
                   'true': True, 'none': None, 'text': 'x' * 40},
            'empty': {}, 'arrays': {
                'f64': np.linspace(0, 1, 5),
                'u16': np.arange(4, dtype=np.uint16),
                'b': np.array([True, False]), 'none': np.zeros((0, 3))},
            'bf16': jnp.asarray([1.5, -2.0, 3.25], jnp.bfloat16)}
    data = flax.serialization.to_bytes(tree)
    got, want = msgpack_tree.loads(data), flax.serialization.msgpack_restore(
        data)
    for k in ('f32', 'i8', 'u64', 'bool'):
        assert type(got[k]) is type(want[k]) and got[k] == want[k], k
    assert got['zero_d'].shape == () and got['zero_d'].dtype == np.int32
    assert got['py'] == want['py'] and got['empty'] == {}
    for k, v in want['arrays'].items():
        assert got['arrays'][k].dtype == v.dtype, k
        np.testing.assert_array_equal(got['arrays'][k], v, err_msg=k)
    bf16 = got['bf16']
    assert bf16.dtype == torch.bfloat16
    assert bf16.view(torch.uint16).numpy().tobytes() == \
        np.asarray(want['bf16']).tobytes()
    assert bf16.float().tolist() == [1.5, -2.0, 3.25]
    # Keys as bin, or as raw str (msgpack's old string format), and every
    # container width.
    assert msgpack_tree.loads(msgpack.packb({b'k': [1, 2], 'j': b'\x00'},
                                            use_bin_type=True)) == {
        'k': [1, 2], 'j': b'\x00'}
    assert msgpack_tree.loads(msgpack.packb({'k': 1}, use_bin_type=False)) \
        == {'k': 1}
    wide = {str(i): list(range(i % 20)) for i in range(70000)}
    assert msgpack_tree.loads(msgpack.packb(wide)) == wide
    long = {'s': 'y' * 70000, 'b': b'z' * 300}
    assert msgpack_tree.loads(msgpack.packb(long)) == long


@pytest.mark.parametrize('data, byte', [
    (msgpack.packb(msgpack.ExtType(2, b'ab')), '0xd5'),
    (msgpack.packb({'t': msgpack.Timestamp(1)}), '0xd6'),
    (msgpack.packb(msgpack.ExtType(7, b'x' * 20)), '0xc7'),
    (b'\xc1', '0xc1'),
], ids=['complex-ext', 'timestamp-ext', 'ext8', 'reserved'])
def test_outside_the_subset_raises(data, byte):
    with pytest.raises(ValueError, match=byte):
        msgpack_tree.loads(data)


def test_truncated_and_trailing_bytes_raise():
    data = flax.serialization.to_bytes({'a': np.arange(4.0)})
    with pytest.raises(ValueError, match='past the end'):
        msgpack_tree.loads(data[:-3])
    with pytest.raises(ValueError, match='after the value'):
        msgpack_tree.loads(data + b'\x00')
