"""The instance-norm kernel's device ms a batch in the traced stretch: its
launches' times summed over the stretch's batches, 0 when none ran.
Nothing under a program without the kernel's module (a commit before it
came)."""

from benchmark import stats

KERNEL = "instance_norm_kernel"


def read(record):
    stretch = record.get("stretch")
    if stretch is None:
        return None
    try:
        import eve_tpu_torch.kernels.norm_kernels  # noqa: F401
    except ImportError:
        return None
    return stats.per(sum(t for _, t in stretch.kernels(KERNEL)) * 1e3,
                     record["stretch_units"])
