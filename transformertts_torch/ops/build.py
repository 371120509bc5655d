"""Build the port's CUDA sources into shared libraries and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` builds it in seconds; ``csrc/*.cuh`` are headers the sources share. The build runs at first use, never at import,
into ``build/torch_kernels/`` beside the package (listed in ``.gitignore``),
keyed on a hash of the source and the flags: an edited source rebuilds, an
unchanged one loads the library already built.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / 'build' / 'torch_kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC')
# sources whose kernels round every product and sum on its own, as their
# plain versions do: no fused multiply-add
SOURCE_FLAGS = {'griffin_lim': ('-fmad=false',)}

# what a kernel uses on the card, as its library's resource entries report it
RESOURCES = ('registers', 'spill_bytes', 'static_smem_bytes', 'dynamic_smem_bytes',
             'blocks_per_sm', 'threads')

_loaded = {}


def nvcc_path() -> str:
    """nvcc on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    candidate = Path(home) / 'bin' / 'nvcc'
    if candidate.exists():
        return str(candidate)
    raise RuntimeError('nvcc not found: the CUDA kernels are built with the '
                       'CUDA toolkit (PATH, CUDA_HOME or /usr/local/cuda)')


def nvcc_flags(name: str) -> tuple:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    # the shared headers are part of every source's digest
    sources = [CSRC / f'{name}.cu', *sorted(CSRC.glob('*.cuh'))]
    digest = hashlib.sha256(b''.join(f.read_bytes() for f in sources)
                            + ' '.join(nvcc_flags(name)).encode())
    return BUILD_DIR / f'lib{name}-{digest.hexdigest()[:16]}.so'


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the library for this source exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never load
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *nvcc_flags(name), '-o', tmp, str(CSRC / f'{name}.cu')],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on {name}.cu:\n{proc.stderr}')
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<name>.cu`` once."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]


def build_all(names) -> list:
    """Build several sources at once, one nvcc each, all started together."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return list(pool.map(build, names))


def resources(name: str, entry: str, args: tuple, keys: tuple = RESOURCES) -> dict:
    """What a kernel of ``csrc/<name>.cu`` uses on the card: its C entry
    ``entry`` takes the int ``args`` and fills one int for each of ``keys``
    from ``cudaFuncGetAttributes`` and the occupancy calculator (spill bytes
    are its local memory a thread)."""
    fn = getattr(load(name), entry)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(keys))()
    err = fn(*args, out)
    if err != 0:
        raise RuntimeError(f'{entry}{tuple(args)} failed: CUDA error {err}')
    return dict(zip(keys, out))
