"""How the port's CUDA kernels are named and found, without ``nvcc``.

A kernel's library is named by a hash of everything its build reads: its
``csrc/*.cu`` source, the shared headers under ``csrc/`` and the compiler
flags. These tests edit a copy of ``csrc/`` and check that the name moves
with each input, so an edited header can never leave a stale library
loaded; and that every quoted include names a file that is there.
"""

import re
import shutil

import pytest

from pddl_tpu_torch.ops import _kernels

FLASH = ("flash_fwd", "flash_bwd")
INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that ``_kernels`` reads instead of the real one."""
    copy = tmp_path / "csrc"
    shutil.copytree(_kernels._CSRC, copy)
    monkeypatch.setattr(_kernels, "_CSRC", copy)
    return copy


def _paths():
    return {name: _kernels._lib_path(name) for name in _kernels.SOURCES}


def _append(path, text="\n// edited\n"):
    path.write_text(path.read_text() + text)


def test_lib_path_is_a_pure_function_of_the_inputs(csrc):
    first = _paths()
    assert first == _paths()
    assert len(set(first.values())) == len(first)
    for name, path in first.items():
        assert path.parent == _kernels.BUILD_DIR
        assert re.fullmatch(rf"lib{name}-[0-9a-f]{{12}}\.so", path.name)


@pytest.mark.parametrize("name", FLASH)
def test_flash_sources_include_the_shared_header(name):
    src = (_kernels._CSRC / _kernels.SOURCES[name]).read_text()
    assert "flash_common.cuh" in INCLUDE.findall(src)


def test_editing_the_shared_header_renames_both_flash_libraries(csrc):
    before = _paths()
    _append(csrc / "flash_common.cuh")
    after = _paths()
    for name in FLASH:
        assert after[name] != before[name], name


@pytest.mark.parametrize("edited", sorted(_kernels.SOURCES))
def test_editing_a_source_renames_only_its_library(csrc, edited):
    before = _paths()
    _append(csrc / _kernels.SOURCES[edited])
    after = _paths()
    for name in _kernels.SOURCES:
        assert (after[name] != before[name]) == (name == edited), name


def test_changing_the_flags_renames_every_library(csrc, monkeypatch):
    before = _paths()
    monkeypatch.setattr(_kernels, "NVCC_FLAGS", _kernels.NVCC_FLAGS + ("-G",))
    after = _paths()
    for name in _kernels.SOURCES:
        assert after[name] != before[name], name


@pytest.mark.parametrize("source", sorted(
    p.name for p in _kernels._CSRC.iterdir() if p.suffix in (".cu", ".cuh")))
def test_every_quoted_include_names_a_file_in_csrc(source):
    text = (_kernels._CSRC / source).read_text()
    for header in INCLUDE.findall(text):
        assert (_kernels._CSRC / header).is_file(), (source, header)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """With no toolkit on PATH or in its default place, a build raises
    with a message that says so, and writes no library."""
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    monkeypatch.setattr(_kernels, "_DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build(["flash_fwd"])
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_log_goes_to_stderr_never_stdout(monkeypatch, tmp_path,
                                               capfd):
    """A fleet worker builds its kernels with stdout carrying its
    protocol: a stand-in ``nvcc`` that chatters and writes the library
    leaves stdout empty, and its log lands on stderr."""
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\n"
                    "echo 'ptxas info : Used 42 registers'\n"
                    "while [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then shift; : > \"$1\"; fi\n"
                    "  shift\n"
                    "done\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", str(nvcc.parent))
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    out = _kernels.build(["paged_decode"])
    assert out["paged_decode"].exists()
    captured = capfd.readouterr()
    assert captured.out == ""
    assert "Used 42 registers" in captured.err
