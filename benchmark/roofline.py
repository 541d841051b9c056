"""The chip's peaks and the heatmap kernels' bytes, from the cells' shapes.

Peaks: NVIDIA's published dense figures for one H100 SXM at its full
700 W (bf16 989 TFLOP/s on the tensor cores; float32 67 TFLOP/s outside
them, as a float32 configuration with TF32 off runs; HBM3 3.35 TB/s). A
card held below 700 W reaches less; every run prints its power limit.

Bytes: each input byte read once and each output byte written once, as
the work needs them, whatever a kernel rereads.
"""

PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}
HBM_BYTES_PER_S = 3.35e12
HEATMAP_H, HEATMAP_W = 72, 128
F32 = 4


def render_bytes(n, sigmas=1, masked=False, h=HEATMAP_H, w=HEATMAP_W):
    """The render kernel: (n, 2) float32 centres (and an (n,) mask) in,
    (sigmas, n, h, w) float32 maps out."""
    return n * 2 * F32 + (n * F32 if masked else 0) + sigmas * n * h * w * F32


def soft_argmax_bytes(n, h=HEATMAP_H, w=HEATMAP_W):
    """The soft-argmax kernel: (n, h, w) float32 maps in, (n, 2) out."""
    return n * h * w * F32 + n * 2 * F32


KERNEL_BYTES = {'render_heatmaps_kernel': render_bytes,
                'soft_argmax_kernel': soft_argmax_bytes}


def kernel_roofline_pct(stretch, kernel, call):
    """Share of the bytes bound that ``kernel``'s launches in ``stretch``
    reached: the launches' least time at ``HBM_BYTES_PER_S`` over their
    measured time, in %. ``call``: the launch's shape arguments. None when
    the stretch holds no such launch."""
    launches = stretch.kernels(kernel)
    if not launches:
        return None
    bound = KERNEL_BYTES[kernel](**call) / HBM_BYTES_PER_S
    return 100.0 * bound * len(launches) / sum(t for _, t in launches)


def reader(kernel):
    """A metric reader of ``kernel``'s share of its bytes bound: the
    record's traced stretch and the kernel's call in ``kernel_calls``."""
    def read(record):
        stretch = record.get('stretch')
        if stretch is None:
            return None
        return kernel_roofline_pct(stretch, kernel,
                                   record['kernel_calls'][kernel])
    return read
