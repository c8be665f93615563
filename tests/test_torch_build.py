"""The build cache of the port's CUDA kernels (``kernels/_build.py``): a
library is named by a hash of its source, of every header beside it and
of the flags, so an edited header rebuilds the sources that may include
it.  Nothing is compiled here (no nvcc on the CPU): only the names are
computed."""
import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    d = tmp_path / "csrc"
    d.mkdir()
    (d / "a.cu").write_text('#include "tile.cuh"\nint f() { return 1; }\n')
    (d / "tile.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", d)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return d


def test_unchanged_sources_keep_their_library(csrc):
    assert _build.library_path("a") == _build.library_path("a")


@pytest.mark.parametrize("edit", ["header", "new header", "source"])
def test_an_edit_changes_the_library(csrc, edit):
    before = _build.library_path("a")
    if edit == "header":
        (csrc / "tile.cuh").write_text("#pragma once\n// edited\n")
    elif edit == "new header":
        (csrc / "other.cuh").write_text("#pragma once\n")
    else:
        (csrc / "a.cu").write_text('#include "tile.cuh"\n')
    after = _build.library_path("a")
    assert after != before
    assert after.parent == before.parent
    assert after.name.startswith("a-") and after.suffix == ".so"


def test_flags_change_the_library(csrc, monkeypatch):
    before = _build.library_path("a")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("a") != before


def test_the_port_sources_share_a_header():
    """The tensor-core tile is one header included by both attention
    sources, so both are keyed by it."""
    headers = [p.name for p in _build.CSRC.glob("*.cuh")]
    assert "flash_tile.cuh" in headers
    for src in ("residual_attention.cu", "paged_residual_attention.cu"):
        assert '#include "flash_tile.cuh"' in (_build.CSRC / src).read_text()
