"""The port's kernel build cache (``tpu_k8s_device_plugin_torch/build.py``)
on a temporary source tree: a library's name follows its source, every
header beside it and nothing else.  No compiler is needed: nothing is
built."""

import pytest

from tpu_k8s_device_plugin_torch import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "alpha.cu").write_text('#include "shared.cuh"\nint alpha;\n')
    (src / "beta.cu").write_text("int beta;\n")
    (src / "shared.cuh").write_text("// shared\n")
    (src / "plain.h").write_text("// plain\n")
    (src / "notes.txt").write_text("not a source\n")
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    return src


def test_sources_lists_only_cu_files(csrc):
    assert build.sources() == ["alpha", "beta"]


def test_headers_lists_cuh_and_h_files(csrc):
    assert [p.name for p in build.headers()] == ["plain.h", "shared.cuh"]


def test_lib_path_is_stable_on_an_unchanged_tree(csrc, tmp_path):
    first = build.lib_path("alpha")
    assert first == build.lib_path("alpha")
    assert first.parent == tmp_path / "_build"
    assert first.name.startswith("alpha-") and first.suffix == ".so"
    assert first != build.lib_path("beta")


def test_lib_path_follows_the_source(csrc):
    before = build.lib_path("alpha"), build.lib_path("beta")
    (csrc / "alpha.cu").write_text('#include "shared.cuh"\nint alpha2;\n')
    assert build.lib_path("alpha") != before[0]
    assert build.lib_path("beta") == before[1]


@pytest.mark.parametrize("header", ["shared.cuh", "plain.h"])
def test_lib_path_follows_every_header(csrc, header):
    before = build.lib_path("alpha"), build.lib_path("beta")
    (csrc / header).write_text("// edited\n")
    assert build.lib_path("alpha") != before[0]
    assert build.lib_path("beta") != before[1]


def test_lib_path_follows_a_new_or_renamed_header(csrc):
    before = build.lib_path("alpha")
    (csrc / "extra.cuh").write_text("")
    added = build.lib_path("alpha")
    assert added != before
    (csrc / "extra.cuh").rename(csrc / "other.cuh")
    assert build.lib_path("alpha") not in (before, added)


def test_lib_path_ignores_other_files(csrc):
    before = build.lib_path("alpha")
    (csrc / "notes.txt").write_text("edited\n")
    (csrc / "README.md").write_text("new\n")
    assert build.lib_path("alpha") == before


def test_lib_path_follows_the_compiler_flags(csrc, monkeypatch):
    before = build.lib_path("alpha")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-lineinfo"])
    assert build.lib_path("alpha") != before


def test_the_package_sources_share_one_header():
    """The real tree: every source has a library name, and the flash
    sources both include the shared Hopper header."""
    assert "flash_attn_fwd" in build.sources()
    assert "hopper.cuh" in [p.name for p in build.headers()]
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        assert '#include "hopper.cuh"' in (
            build.CSRC / f"{name}.cu").read_text()
    assert len({build.lib_path(n) for n in build.sources()}) == len(
        build.sources())
