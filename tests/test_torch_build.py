"""The kernel build's digest (rigl_tpu_torch/ops/_build.py): it covers each
CUDA source, the headers beside it (csrc/*.cuh) and the flags, so that an
edited header rebuilds every library whose source includes it instead of
loading a stale one.  Each test works on a copy of csrc/ and runs no nvcc.
"""

import shutil

import pytest

from rigl_tpu_torch.ops import _build

LIBRARIES = ('packed_mm', 'flash_attn', 'tap_conv')


@pytest.fixture
def csrc(tmp_path):
  dst = tmp_path / 'csrc'
  shutil.copytree(_build.CSRC, dst)
  return dst


@pytest.mark.parametrize('name', LIBRARIES)
def test_digest_changes_with_an_edited_header(csrc, name):
  before = _build.digest(name, csrc)
  assert before == _build.digest(name) == _build.digest(name, csrc)
  header = csrc / 'hopper.cuh'
  header.write_text(header.read_text() + '\n// edited\n')
  assert _build.digest(name, csrc) != before


def test_digest_changes_with_the_source_and_a_new_header(csrc):
  before = _build.digest('flash_attn', csrc)
  (csrc / 'extra.cuh').write_text('// a header beside the sources\n')
  with_header = _build.digest('flash_attn', csrc)
  assert with_header != before
  src = csrc / 'flash_attn.cu'
  src.write_text(src.read_text() + '\n')
  edited = _build.digest('flash_attn', csrc)
  assert edited != with_header
  # Another source's edit leaves this library's digest alone.
  other = csrc / 'tap_conv.cu'
  other.write_text(other.read_text() + '\n')
  assert _build.digest('flash_attn', csrc) == edited


def test_build_reuses_the_library_of_its_digest_and_rebuilds_after_an_edit(
    csrc, tmp_path, monkeypatch):
  monkeypatch.setattr(_build, 'CSRC', csrc)
  monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
  so = tmp_path / 'build' / f'libflash_attn_{_build.digest("flash_attn")}.so'
  so.parent.mkdir()
  so.write_bytes(b'')
  assert _build.build('flash_attn') == so   # found: nothing compiled

  def no_nvcc():
    raise LookupError('would compile')
  monkeypatch.setattr(_build, '_nvcc', no_nvcc)
  header = csrc / 'hopper.cuh'
  header.write_text(header.read_text() + '\n// edited\n')
  with pytest.raises(LookupError):
    _build.build('flash_attn')
