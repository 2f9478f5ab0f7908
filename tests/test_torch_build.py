"""The CUDA build helper of the port (``repro_torch.kernels._build``): the
library's file name follows every byte of the source's ``csrc/`` directory,
headers included, so an edited header never loads a stale library. No
``nvcc`` is needed: only the target name is computed, on a temporary copy of
the sources."""
import re
import shutil

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_every_source_exists_with_its_headers(name):
    """Every local header a source includes lies in its own ``csrc/``
    directory, the files the target name is hashed over."""
    src = _build.SOURCES[name]
    assert src.is_file() and src.suffix == ".cu"
    local = re.findall(r'^#include\s+"([^"]+)"', src.read_text(), re.M)
    for hdr in local:
        assert (src.parent / hdr).is_file() and "/" not in hdr, hdr
    if name == "flash_attention":
        assert local == ["hopper.cuh"]
    assert _build._target(name).name.startswith(f"{name}-")


@pytest.mark.parametrize("edit", ["header", "source", "new_header"])
def test_target_name_follows_every_file_of_csrc(tmp_path, monkeypatch, edit):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.SOURCES["flash_attention"].parent, csrc)
    src = csrc / "flash_attention.cu"
    assert (csrc / "hopper.cuh").is_file()
    monkeypatch.setitem(_build.SOURCES, "flash_attention", src)
    before = _build._target("flash_attention")
    assert _build._target("flash_attention") == before   # stable
    if edit == "header":
        hdr = csrc / "hopper.cuh"
        hdr.write_bytes(hdr.read_bytes() + b"\n// edited\n")
    elif edit == "source":
        src.write_bytes(src.read_bytes().replace(b"BN = 128", b"BN = 64"))
    else:
        (csrc / "extra.cuh").write_text("#pragma once\n")
    after = _build._target("flash_attention")
    assert after != before
    assert after.parent == before.parent == _build.BUILD_DIR
