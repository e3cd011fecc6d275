"""The build's library names (``mpi4jax_tpu_torch/_build.py``) cover the
``csrc`` headers a source includes, on the CPU: no ``nvcc`` runs.

A library is reused while its name is unchanged, so a name that missed an
included header would load a stale library after that header changed.
"""

import pytest

from mpi4jax_tpu_torch import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A ``csrc`` of four files: ``x.cu`` includes ``a.cuh``, which
    includes ``b.cuh``; ``c.cuh`` is included by nothing."""
    (tmp_path / "x.cu").write_text('#include "a.cuh"\n#include <stdint.h>\n'
                                   "int f() { return 0; }\n")
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "c.cuh").write_text("// c\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


def test_sources_follow_includes(csrc):
    assert [p.name for p in _build._sources("x")] == ["x.cu", "a.cuh",
                                                      "b.cuh"]


@pytest.mark.parametrize("header", ["a.cuh", "b.cuh"])
def test_an_included_header_changes_the_name(csrc, header):
    before = _build._target("x")
    (csrc / header).write_text((csrc / header).read_text() + "// edit\n")
    assert _build._target("x") != before


def test_another_file_leaves_the_name(csrc):
    before = _build._target("x")
    (csrc / "c.cuh").write_text("// c, edited\n")
    (csrc / "y.cu").write_text("int g() { return 1; }\n")
    assert _build._target("x") == before


def test_flash_sources_name_their_headers():
    for name in ("flash_fwd", "flash_bwd"):
        assert [p.name for p in _build._sources(name)] == [
            f"{name}.cu", "flash_tiles.cuh", "hopper.cuh"]
    assert [p.name for p in _build._sources("hop")] == ["hop.cu"]
