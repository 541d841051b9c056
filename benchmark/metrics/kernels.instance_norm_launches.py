"""The instance-norm kernel's launches a batch in the traced stretch: 59
when every norm of the bf16 EVE forward runs through it, 0 when none does.
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
    return stats.per(float(len(stretch.kernels(KERNEL))),
                     record["stretch_units"])
