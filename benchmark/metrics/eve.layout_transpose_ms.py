"""cuDNN's NCHW<->NHWC layout transposes: their device ms a batch in the
traced stretch (kernels whose names hold ``nchwToNhwc`` or ``nhwcToNchw``),
0 when none ran. Near 0 when the bf16 EVE forward runs channels-last, the
transposes around each bf16 convolution when it runs NCHW. Nothing under a
program without ``eve_tpu_torch.kernels.norm_kernels``, as the norm
kernel's readers."""

from benchmark import stats

KERNELS = ("nchwToNhwc", "nhwcToNchw")


def read(record):
    stretch = record.get("stretch")
    if stretch is None:
        return None
    try:
        import eve_tpu_torch.kernels.norm_kernels  # noqa: F401
    except ImportError:
        return None
    return stats.per(sum(t for name, t in stretch.kernels()
                         if any(k in name for k in KERNELS)) * 1e3,
                     record["stretch_units"])
