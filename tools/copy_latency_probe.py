#!/usr/bin/env python3
"""Latency of one CTA's slice copy, TMA bulk copy against float4 threads.

    python3 tools/copy_latency_probe.py

Builds ``tools/copy_latency_probe.cu`` with the port's nvcc flags and times,
with ``chip_smoke.time_gpu`` (a 50-launch CUDA-event chain behind a device
sleep), kernels that do nothing but move each CTA's slice at the heatmap
kernels' serving shapes (N = 80 maps of 72 x 128 float32):

- soft-argmax: 160 CTAs (clusters of 2 a map) each loading an 18,432-byte
  slice, by one TMA bulk copy or by 256 threads' float4 loads;
- render: 240 CTAs each storing a 12,288-byte slice (24 rows), by one TMA
  bulk store or by float4 stores;

beside an empty kernel of the same grid. Prints one line each and the
card. Needs a CUDA card; exits non-zero without one.
"""

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = (('soft-argmax slice', 160, 18432, (0, 1, 2)),
          ('render slice', 240, 12288, (0, 3, 4)))
KINDS = {0: 'empty kernel', 1: 'TMA bulk load', 2: 'float4 loads',
         3: 'TMA bulk store', 4: 'float4 stores'}


def main():
    if not torch.cuda.is_available():
        print('copy_latency_probe: no CUDA card visible')
        return 2
    import chip_smoke
    from eve_tpu_torch.kernels import build
    lib_path = os.path.join(build.build_dir(), 'copy_latency_probe.so')
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, '-o', lib_path,
                    os.path.join(ROOT, 'tools', 'copy_latency_probe.cu')],
                   check=True)
    lib = ctypes.CDLL(lib_path)
    lib.probe_launch.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
    lib.probe_launch.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for what, ctas, slice_bytes, kinds in SHAPES:
        buf = torch.rand(ctas * slice_bytes // 4, device='cuda')
        out = torch.empty(ctas, device='cuda')

        def launch(kind):
            err = lib.probe_launch(kind, buf.data_ptr(), out.data_ptr(), ctas,
                                   slice_bytes, stream)
            if err:
                raise RuntimeError('probe kernel %d: cudaError %d'
                                   % (kind, err))

        for kind in kinds:
            ms = chip_smoke.time_gpu(lambda: launch(kind))
            print('%s, %d CTAs x %d bytes: %-14s %.5f ms'
                  % (what, ctas, slice_bytes, KINDS[kind], ms), flush=True)
    print('card:', chip_smoke.card_line())
    return 0


if __name__ == '__main__':
    sys.exit(main())
