"""PyTorch port: the kernel library's name covers what builds it
(ops/cuda_build.py `library_path`, CPU only: naming a library builds
nothing and needs no nvcc).

* The same source and flags give the same path, every time.
* Changing NVCC_FLAGS gives another path, so a library built with the old
  flags is never loaded for the new ones.
* Changing the source gives another path.
"""
import shutil

import pytest

from go2_rl_gym_tpu_torch.ops import cuda_build
from go2_rl_gym_tpu_torch.ops import terrain_patches as tp


@pytest.fixture(autouse=True)
def no_nvcc(monkeypatch):
    def refuse():
        raise AssertionError("library_path must not look for nvcc")
    monkeypatch.setattr(cuda_build, "find_nvcc", refuse)


def test_path_is_stable_and_in_the_build_dir():
    p = cuda_build.library_path(tp.SOURCE)
    assert p == cuda_build.library_path(tp.SOURCE)
    assert p.parent == cuda_build.BUILD_DIR
    assert p.name.startswith("libextract_patches-") and p.suffix == ".so"


@pytest.mark.parametrize("flags", [
    ("-cudart", "shared"),                  # an added flag
    None,                                   # a flag dropped
    ("-O3",),                               # a flag repeated
], ids=["added", "dropped", "repeated"])
def test_flags_change_the_path(monkeypatch, flags):
    before = cuda_build.library_path(tp.SOURCE)
    new = (cuda_build.NVCC_FLAGS[:-2] if flags is None
           else cuda_build.NVCC_FLAGS + flags)
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", new)
    assert cuda_build.library_path(tp.SOURCE) != before


def test_flags_split_differently_change_the_path(monkeypatch):
    """("-a", "b") and ("-ab",) pass nvcc different arguments."""
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", ("-Xptxas", "-v"))
    a = cuda_build.library_path(tp.SOURCE)
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", ("-Xptxas-v",))
    assert cuda_build.library_path(tp.SOURCE) != a


def test_source_changes_the_path(monkeypatch, tmp_path):
    pkg = tmp_path / "pkg"
    (pkg / "ops" / "csrc").mkdir(parents=True)
    src = pkg / tp.SOURCE
    shutil.copy(cuda_build.PACKAGE_DIR / tp.SOURCE, src)
    monkeypatch.setattr(cuda_build, "PACKAGE_DIR", pkg)
    before = cuda_build.library_path(tp.SOURCE)
    assert before.name == cuda_build.library_path(tp.SOURCE).name
    src.write_text(src.read_text() + "\n// edited\n")
    assert cuda_build.library_path(tp.SOURCE) != before
