"""The port's kernel build (ops/kernels/_build.py): what names a build."""

import shutil

import pytest

from tcresnet_tpu_torch.ops.kernels import _build


@pytest.mark.parametrize("name", ["infer", "mfcc", "frontend", "augment"])
def test_library_path_follows_shared_headers(tmp_path, monkeypatch, name):
    """A change to a csrc/*.cuh header alone gives another library name, so
    a build of the old header is never loaded; an unrelated file does not."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc, ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", csrc / "build")
    before = _build.library_path(name)
    assert before.parent == csrc / "build" and before.name.startswith(f"lib{name}_")
    (csrc / "notes.txt").write_text("not a source")
    assert _build.library_path(name) == before
    for header in sorted(csrc.glob("*.cuh")):
        text = header.read_text()
        header.write_text(text + "\n// edited\n")
        assert _build.library_path(name) != before, header.name
        header.write_text(text)
        assert _build.library_path(name) == before
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path(name) != before


def test_sources_include_the_shared_headers():
    for name, headers in {"infer": ["frontend.cuh"], "mfcc": ["frontend.cuh"],
                          "frontend": ["augment.cuh", "frontend.cuh"],
                          "augment": ["augment.cuh"]}.items():
        text = (_build.CSRC_DIR / f"{name}.cu").read_text()
        for h in headers:
            assert f'#include "{h}"' in text, (name, h)
