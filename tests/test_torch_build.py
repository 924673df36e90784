"""The kernel library's build key (ops/_build.py), without nvcc: the
library's name must change with every source and every header the
sources include, so an edited header never loads a stale build."""

from vectorsearch_rbac_tpu_torch.ops import _build


def test_library_path_follows_sources_and_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "scan.cu").write_text('#include "common.cuh"\n')
    (csrc / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = _build.library_path()
    assert first == _build.library_path()          # deterministic
    assert [p.name for p in _build._sources()] == ["scan.cu"]  # compiled

    (csrc / "common.cuh").write_text("// v2\n")    # the header alone
    second = _build.library_path()
    assert second != first

    (csrc / "scan.cu").write_text('#include "common.cuh"\n// edited\n')
    third = _build.library_path()
    assert third not in (first, second)

    (csrc / "notes.txt").write_text("not a source")  # neither compiled
    assert _build.library_path() == third             # nor hashed
    assert second.parent == _build.BUILD_DIR
