"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each source `rigl_tpu_torch/csrc/<name>.cu` has a plain C interface and
is compiled, at its first use in a process, into
`rigl_tpu_torch/_build/lib<name>_<hash>.so` (a directory git ignores).
The hash covers the source and the flags, so an edited source rebuilds
and an unchanged one loads the library already built.  nvcc's output,
including `-Xptxas -v`'s register and spill report, is kept beside the
library as `<same name>.log`.

Nothing here runs at import time: a machine without nvcc or a GPU can
import every module of the package.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def _nvcc() -> str:
  """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default prefix
  (the search order of torch.utils.cpp_extension)."""
  home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
  if home and (Path(home) / 'bin' / 'nvcc').exists():
    return str(Path(home) / 'bin' / 'nvcc')
  found = shutil.which('nvcc')
  if found:
    return found
  default = Path('/usr/local/cuda/bin/nvcc')
  if default.exists():
    return str(default)
  raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH')


def build(name: str) -> Path:
  """Compiles csrc/<name>.cu unless the library for its hash exists."""
  src = CSRC / f'{name}.cu'
  digest = hashlib.sha256(src.read_bytes()
                          + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
  so = BUILD_DIR / f'lib{name}_{digest}.so'
  if so.exists():
    return so
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
  cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(src)]
  proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
  so.with_suffix('.log').write_text(proc.stdout + proc.stderr)
  if proc.returncode:
    raise RuntimeError(f'nvcc failed ({proc.returncode}) building {name}:\n'
                       f'{proc.stderr[-4000:]}')
  os.replace(tmp, so)   # atomic: a concurrent loader sees all or nothing
  return so


@functools.cache
def load(name: str) -> ctypes.CDLL:
  """The loaded library for csrc/<name>.cu, built first if needed."""
  return ctypes.CDLL(str(build(name)))
