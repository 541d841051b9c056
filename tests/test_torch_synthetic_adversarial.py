"""The port's adversarial appearance (``eve_tpu_torch/data/synthetic.py``)
against eve_tpu's, on the CPU.

The renderer is numpy in both packages, drawing from the
``RandomState`` in the same order: the latents and, for the same gazes
and latents, the patches are equal bitwise; so are the two decoders on
the same patches. ``make_synthetic_batch(appearance='adversarial')``
holds within rtol/atol 1e-6, as ``tests/test_torch_serve.py`` holds the
disc batch (its gaze labels come from each package's float32 geometry),
but for the eye patches, where a last-bit label difference can move one
pixel by one level (the test's docstring has the measured rate).
Patches stay small (32-48 px, a few of them): the oracle re-renders 81
candidate gazes at each of 3 levels.
"""

import numpy as np
import pytest

from eve_tpu.data import synthetic as jsynthetic
from eve_tpu_torch.data import synthetic


@pytest.mark.parametrize('lead', [(), (5,), (2, 3)], ids=str)
def test_latents_are_eve_tpus(lead):
    ours = synthetic.sample_appearance_latents(np.random.RandomState(4),
                                               lead)
    theirs = jsynthetic.sample_appearance_latents(np.random.RandomState(4),
                                                  lead)
    assert ours.keys() == theirs.keys()
    for k, v in theirs.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


@pytest.mark.parametrize('size, lead', [(32, (2, 3)), (48, (4,))])
def test_patches_are_eve_tpus(size, lead):
    rs = np.random.RandomState(size)
    gaze = rs.uniform(-0.6, 0.6, lead + (2,)).astype(np.float32)
    latents = jsynthetic.sample_appearance_latents(rs, lead)
    ours = synthetic.render_gaze_patches_adversarial(gaze, size, latents)
    theirs = jsynthetic.render_gaze_patches_adversarial(gaze, size, latents)
    assert ours.dtype == theirs.dtype == np.uint8
    assert ours.shape == lead + (size, size, 3)
    np.testing.assert_array_equal(ours, theirs)
    # The appearance is not the disc's: the brightest pixels are glints.
    assert not np.array_equal(
        ours, synthetic.render_gaze_patches(gaze, size))


def _recording(module, monkeypatch):
    """Record the latents ``module.make_synthetic_batch`` draws."""
    drawn, sample = [], module.sample_appearance_latents

    def record(rng, lead):
        drawn.append(sample(rng, lead))
        return drawn[-1]

    monkeypatch.setattr(module, 'sample_appearance_latents', record)
    return drawn


@pytest.mark.parametrize('frame_dtype', [np.uint8, np.float32],
                         ids=['uint8', 'float32'])
def test_adversarial_batch_matches_eve_tpu(frame_dtype, monkeypatch):
    """Every entry within 1e-6 but the eye patches. A patch is a quantised
    function of its gaze label, and the two packages' float32 labels
    differ in the last bits (up to 1.2e-7 rad), which flips a pixel on a
    rounding edge by one level: 4 of 3.7 million values over 100 seeds of
    this batch. So each package's patches are held bitwise to eve_tpu's
    renderer on its own labels and the same latents, and to each other
    within one level in at most 1e-4 of the values."""
    kw = dict(batch_size=2, sequence_len=3, eyes_size=32, fps=25.0,
              frame_dtype=frame_dtype, appearance='adversarial')
    drawn = [_recording(m, monkeypatch) for m in (synthetic, jsynthetic)]
    ours = synthetic.make_synthetic_batch(np.random.RandomState(6), **kw)
    theirs = jsynthetic.make_synthetic_batch(np.random.RandomState(6), **kw)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == v.dtype, k
        if not k.endswith('_eye_patch'):
            np.testing.assert_allclose(ours[k], v, rtol=1e-6, atol=1e-6,
                                       err_msg=k)
    assert len(drawn[0]) == len(drawn[1]) == 2
    level = 1 if frame_dtype == np.uint8 else 2.0 / 255.0
    for (side, a), b in zip((('left', drawn[0][0]), ('right', drawn[0][1])),
                            drawn[1]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for batch in (ours, theirs):
            patch = jsynthetic.render_gaze_patches_adversarial(
                batch[side + '_g_tobii'], 32, a)
            if frame_dtype == np.float32:
                patch = patch.astype(np.float32) * (2.0 / 255.0) - 1.0
            np.testing.assert_array_equal(batch[side + '_eye_patch'], patch)
        diff = np.abs(ours[side + '_eye_patch'].astype(np.float64) -
                      theirs[side + '_eye_patch'])
        assert diff.max() <= level * (1 + 1e-6)
        assert np.count_nonzero(diff) <= 1e-4 * diff.size
    disc = synthetic.make_synthetic_batch(np.random.RandomState(6),
                                          **dict(kw, appearance='disc'))
    assert not np.array_equal(disc['left_eye_patch'],
                              ours['left_eye_patch'])


def test_decoders_are_eve_tpus():
    rs = np.random.RandomState(9)
    gaze = rs.uniform(-0.5, 0.5, (3, 2)).astype(np.float32)
    latents = jsynthetic.sample_appearance_latents(rs, (3,))
    patches = jsynthetic.render_gaze_patches_adversarial(gaze, 32, latents)
    ours = synthetic.oracle_decode_gaze(patches, latents)
    theirs = jsynthetic.oracle_decode_gaze(patches, latents)
    np.testing.assert_array_equal(ours, theirs)
    # One coarse cell of the last level is 1/32 rad.
    np.testing.assert_allclose(ours, gaze, atol=1.0 / 32)
    for p in (patches, jsynthetic.render_gaze_patches(gaze, 32)):
        np.testing.assert_array_equal(synthetic.decode_gaze_from_patch(p),
                                      jsynthetic.decode_gaze_from_patch(p))
    disc = synthetic.decode_gaze_from_patch(
        synthetic.render_gaze_patches(gaze, 48))
    np.testing.assert_allclose(disc, gaze, atol=0.1)
