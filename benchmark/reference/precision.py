"""The rounding for the control of ``correct`` in a bfloat16
configuration: the reference computed one step below the configuration's
precision, the step a later change might be tempted to take.

``fp8``: each operand of a convolution is scaled by its absolute maximum
to the float8 e4m3 range (per tensor, as fp8 GEMMs take their scales),
rounded to float8 e4m3 and scaled back; the product accumulates in
float32. Plain tensor arithmetic, so the control runs the same on the
card and on the CPU. (A float32 configuration's control is the program's
own TF32 path: ``benchmark.control``.)
"""

import torch

FP8_MAX = 448.0


def fp8(t):
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
