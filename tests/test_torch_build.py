"""Where `qldpcsim_torch/ops/_build.py` puts the libraries it builds: the
environment's override, else `build/qldpcsim_torch/` beside the package,
else a per-user cache directory; an OSError when none can be used. No
compiler is needed: only the choice of the directory is tested."""

import pytest

from qldpcsim_torch.ops import _build


@pytest.fixture
def blocked(tmp_path):
    """A path under which no directory can be created (its parent is a
    file; permissions would not stop a privileged user)."""
    f = tmp_path / "file"
    f.write_text("not a directory")
    return f


def test_default_build_dir_is_beside_the_package(monkeypatch, tmp_path):
    root = _build.CSRC.parents[1]
    assert _build.BUILD_DIR == root / "build" / "qldpcsim_torch"
    monkeypatch.delenv(_build.BUILD_DIR_ENV, raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build" / "q")
    assert _build.build_dir() == tmp_path / "build" / "q"
    assert (tmp_path / "build" / "q").is_dir()


def test_environment_overrides_the_build_dir(monkeypatch, tmp_path, blocked):
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path / "mine"))
    monkeypatch.setattr(_build, "BUILD_DIR", blocked / "build")
    assert _build.build_dir() == tmp_path / "mine"
    assert (tmp_path / "mine").is_dir()


def test_unwritable_default_falls_back_to_the_user_cache(monkeypatch,
                                                         tmp_path, blocked):
    monkeypatch.delenv(_build.BUILD_DIR_ENV, raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", blocked / "build")
    # the fallback follows HOME and no other variable
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    cache = tmp_path / "home" / ".cache" / "qldpcsim_torch"
    assert _build.user_cache_dir() == cache
    assert _build.build_dir() == cache and cache.is_dir()
    assert not (tmp_path / "cache").exists()


def test_no_writable_build_dir_raises(monkeypatch, blocked):
    monkeypatch.delenv(_build.BUILD_DIR_ENV, raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", blocked / "build")
    monkeypatch.setenv("HOME", str(blocked / "home"))
    with pytest.raises(OSError, match=_build.BUILD_DIR_ENV):
        _build.build_dir()
    # and so does building a kernel: nothing is loaded from elsewhere
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(OSError):
        _build.load("channel")


def test_unusable_override_raises_without_falling_back(monkeypatch, tmp_path,
                                                       blocked):
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(blocked / "mine"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    with pytest.raises(OSError):
        _build.build_dir()
    assert not (tmp_path / "build").exists()
    assert not (tmp_path / "home").exists()
