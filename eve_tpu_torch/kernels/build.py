"""Build and load the port's CUDA kernels.

Each source under ``eve_tpu_torch/csrc/`` is compiled by ``nvcc`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
library is built at first use into ``build/eve_tpu_torch/`` beside the
package (or ``$EVE_TORCH_BUILD_DIR``), under a name keyed on the hash of
every file under ``csrc/`` and the flags, so an edited source or header
rebuilds. The build writes a temporary file and renames it into place, so
processes that build at the same time never load a partial library.

Nothing here runs at import: the CPU tests import every module on hosts
without ``nvcc`` or a card.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, 'csrc')

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')

_lock = threading.Lock()
_loaded = {}


def build_dir():
    """Directory that holds the built libraries."""
    return os.environ.get('EVE_TORCH_BUILD_DIR') or os.path.join(
        os.path.dirname(PACKAGE_DIR), 'build', 'eve_tpu_torch')


def find_nvcc():
    """Path of ``nvcc``; raises if the CUDA toolkit is not installed."""
    candidates = []
    for var in ('CUDA_HOME', 'CUDA_PATH'):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], 'bin', 'nvcc'))
    candidates.append('/usr/local/cuda/bin/nvcc')
    for path in candidates:
        if os.path.isfile(path):
            return path
    found = shutil.which('nvcc')
    if found:
        return found
    raise RuntimeError('nvcc not found (looked in $CUDA_HOME, '
                       '/usr/local/cuda and $PATH): the CUDA kernels of '
                       'eve_tpu_torch need the CUDA toolkit')


def library_path(name):
    """Where the library built from ``csrc/<name>.cu`` goes.

    The name is keyed on every file under ``csrc/`` (names and contents)
    and the flags, so an edited header rebuilds the libraries that may
    include it.
    """
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC_DIR)):
        path = os.path.join(CSRC_DIR, fname)
        if os.path.isfile(path):
            with open(path, 'rb') as f:
                digest.update(b'\0' + fname.encode() + b'\0' + f.read())
    return os.path.join(build_dir(),
                        '%s-%s.so' % (name, digest.hexdigest()[:16]))


def compile_library(name, verbose=False):
    """Compile ``csrc/<name>.cu`` if its library is missing.

    Returns ``(path, seconds, compiler_output)``; seconds is 0.0 when the
    library was already built. ``verbose`` adds ``-Xptxas -v`` (registers,
    shared memory and spills of each kernel) to a build that runs.
    """
    path = library_path(name)
    if os.path.isfile(path):
        return path, 0.0, ''
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = '%s.%d.tmp' % (path, os.getpid())
    cmd = [find_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ['-Xptxas', '-v']
    cmd += ['-o', tmp, os.path.join(CSRC_DIR, name + '.cu')]
    start = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, check=False)
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError('nvcc failed on %s.cu (exit %d):\n%s'
                           % (name, proc.returncode, proc.stdout))
    os.replace(tmp, path)
    return path, seconds, proc.stdout


def load_library(name, signatures):
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process.

    ``signatures`` maps each C function to its ``argtypes``; every function
    returns an ``int`` (a ``cudaError_t``).
    """
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path, _, _ = compile_library(name)
            lib = ctypes.CDLL(path)
            for fn_name, argtypes in signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _loaded[name] = lib
        return lib
