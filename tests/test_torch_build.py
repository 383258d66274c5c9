"""The port's kernel build cache: a library's name carries a hash of its
source, of every shared header and of the flags, so that an edited header
never loads a library built from the old one."""

import pytest

from distributeddeeplearningspark_tpu_torch.ops import _build
from test_torch_deadline import per_test


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "sm90.cuh"\n')
    (tmp_path / "sm90.cuh").write_text("// helpers\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    return tmp_path


@pytest.mark.parametrize("edit", ["k.cu", "sm90.cuh", "new.cuh"])
def test_library_path_changes_with_every_source_it_includes(csrc, edit):
    before = _build.library_path("k")
    with open(csrc / edit, "a") as f:
        f.write("// edited\n")
    after = _build.library_path("k")
    assert after != before and after.parent == before.parent
    assert after.name.startswith("libk-") and after.suffix == ".so"


def test_library_path_is_stable_and_ignores_other_sources(csrc):
    before = _build.library_path("k")
    (csrc / "other.cu").write_text("// another kernel\n")
    assert _build.library_path("k") == before


def test_every_source_is_in_the_package():
    for name in _build.SOURCES:
        assert (_build.CSRC_DIR / f"{name}.cu").is_file()
    assert (_build.CSRC_DIR / "sm90.cuh").is_file()
