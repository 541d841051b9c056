"""The layout-transpose reader on synthetic stretches: cuDNN's NCHW<->NHWC
transposes' ms a batch, 0 from a channels-last stretch, and nothing where
the program has no norm-kernel module."""

import builtins

import pytest

from benchmark import harness
from benchmark.trace import Stretch

TRANSPOSES = 'eve.layout_transpose_ms.offline'
NCHW_TO_NHWC = ('void cudnn::engines_precompiled::nchwToNhwcKernel'
                '<__nv_bfloat16, __nv_bfloat16, float, false, true>(...)')
NHWC_TO_NCHW = ('void cudnn::engines_precompiled::nhwcToNchwKernel'
                '<__nv_bfloat16, __nv_bfloat16, float, true, false>(...)')


def _record(device, units=2):
    return {'stretch': Stretch(0.0, 1.0, device, []), 'stretch_units': units}


def test_transpose_reader_sums_cudnns_transposes_a_batch():
    """A stretch of an NCHW bf16 forward: both transposes, summed over the
    stretch's batches; the convolutions and copies beside them are not."""
    rec = _record([
        (NCHW_TO_NHWC, 0.0, 0.004),
        ('sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc',
         0.01, 0.02),
        (NHWC_TO_NCHW, 0.03, 0.032),
        ('void at::native::elementwise_kernel<128, 4, direct_copy>(...)',
         0.04, 0.05),
        ('Memcpy HtoD (Pageable -> Device)', 0.06, 0.07)])
    assert harness.reader(TRANSPOSES)(rec) == pytest.approx(3.0)


def test_transpose_reader_reads_0_from_a_channels_last_stretch():
    rec = _record([
        ('sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc',
         0.0, 0.01),
        ('void (anonymous namespace)::instance_norm_kernel_nhwc<32>(...)',
         0.02, 0.03)])
    assert harness.reader(TRANSPOSES)(rec) == 0.0
    assert harness.reader(TRANSPOSES)({'stretch': None}) is None


def test_transpose_reader_reads_nothing_without_the_kernels_module(
        monkeypatch):
    """A program without ``eve_tpu_torch.kernels.norm_kernels`` (a commit
    before the norm kernel) reads nothing."""
    real = builtins.__import__

    def refuse(module, *args, **kwargs):
        if module == 'eve_tpu_torch.kernels.norm_kernels':
            raise ImportError(module)
        return real(module, *args, **kwargs)

    monkeypatch.setattr(builtins, '__import__', refuse)
    assert harness.reader(TRANSPOSES)(_record([(NCHW_TO_NHWC, 0.0, 0.001)])
                                      ) is None
