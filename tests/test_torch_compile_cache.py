"""The port's kernel cache (nbody_tpu_torch/utils/compile_cache.py and
ops/_build.py's library directory), with tests/test_compile_cache.py's and
tests/test_app.py's cases of nbody_tpu's XLA cache carried over: the
default directory's precedence, the last call winning, the CLI's bare
``--compile-cache`` forms. The libraries themselves need nvcc and a card
(tests/test_torch_kernels.py); here a fake ``nvcc`` shows that its
``--version`` output is part of every library's key."""

import os
import stat

import pytest

from nbody_tpu_torch import app as torch_app
from nbody_tpu_torch.ops import _build
from nbody_tpu_torch.utils import (cache_entries, default_cache_dir,
                                   enable_compile_cache)

RUN = ["run", "--n", "250", "--galaxies", "1", "--steps", "1"]


@pytest.fixture(autouse=True)
def restore_build_dir(monkeypatch):
    """Leave ops/_build's process-global directory as it was."""
    monkeypatch.delenv("NBODY_TPU_TORCH_CACHE_DIR", raising=False)
    yield
    _build.set_build_dir(None)


def _fake_nvcc(home, version):
    """A $CUDA_HOME whose bin/nvcc prints ``version`` for --version."""
    bin_dir = home / "bin"
    bin_dir.mkdir(parents=True, exist_ok=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(f"#!/bin/sh\necho 'Cuda compilation tools, {version}'\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    return str(home)


def test_default_dir_env_then_xdg_then_home(monkeypatch, tmp_path):
    monkeypatch.setenv("NBODY_TPU_TORCH_CACHE_DIR", str(tmp_path / "env"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert default_cache_dir() == str(tmp_path / "env")
    monkeypatch.delenv("NBODY_TPU_TORCH_CACHE_DIR")
    assert default_cache_dir() == str(tmp_path / "xdg" / "nbody_tpu_torch"
                                      / "kernels")
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert default_cache_dir() == str(tmp_path / "home" / ".cache"
                                      / "nbody_tpu_torch" / "kernels")


def test_enable_creates_the_directory_and_the_last_call_wins(tmp_path):
    first, second = tmp_path / "first", tmp_path / "second"
    assert enable_compile_cache(str(first)) == str(first)
    assert first.is_dir() and _build.build_dir() == first
    assert enable_compile_cache(str(second),
                                min_compile_time_secs=0.0) == str(second)
    assert second.is_dir() and _build.build_dir() == second
    assert _build.library_path("direct_forces").parent == second


def test_bare_enable_takes_the_default_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("NBODY_TPU_TORCH_CACHE_DIR", str(tmp_path / "env"))
    assert enable_compile_cache() == str(tmp_path / "env")
    assert _build.build_dir() == tmp_path / "env"


def test_build_dir_resolution_order(monkeypatch, tmp_path):
    """enable_compile_cache's, else the environment's, else build/kernels
    in a source checkout, else the user's cache directory."""
    assert _build.build_dir() == _build.BUILD_DIR
    assert _build.BUILD_DIR.parent.parent == _build.CSRC.parents[1]
    monkeypatch.setenv("NBODY_TPU_TORCH_CACHE_DIR", str(tmp_path / "env"))
    assert _build.build_dir() == tmp_path / "env"
    enable_compile_cache(str(tmp_path / "chosen"))
    assert _build.build_dir() == tmp_path / "chosen"
    _build.set_build_dir(None)
    monkeypatch.delenv("NBODY_TPU_TORCH_CACHE_DIR")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    # an installed package: the package's parent is site-packages
    wheel = tmp_path / "lib" / "site-packages" / "build" / "kernels"
    monkeypatch.setattr(_build, "BUILD_DIR", wheel)
    assert _build.build_dir() == tmp_path / "xdg" / "nbody_tpu_torch" / "kernels"


def test_library_key_follows_nvcc_version(monkeypatch, tmp_path):
    enable_compile_cache(str(tmp_path / "cache"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    assert _build.nvcc_version() == ""
    bare = _build.library_path("direct_forces")
    monkeypatch.setenv("CUDA_HOME", _fake_nvcc(tmp_path / "a", "V12.8.93"))
    a = _build.library_path("direct_forces")
    assert "V12.8.93" in _build.nvcc_version()
    monkeypatch.setenv("CUDA_HOME", _fake_nvcc(tmp_path / "b", "V12.9.41"))
    b = _build.library_path("direct_forces")
    assert len({bare, a, b}) == 3
    assert {p.parent for p in (bare, a, b)} == {tmp_path / "cache"}
    assert all(p.name.startswith("libdirect_forces-") for p in (a, b))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "a"))
    assert _build.library_path("direct_forces") == a


def test_cache_entries_counts_libraries(tmp_path):
    assert cache_entries(str(tmp_path / "absent")) == 0
    enable_compile_cache(str(tmp_path / "c"))
    assert cache_entries() == 0
    (tmp_path / "c" / "libdirect_forces-0123456789abcdef.so").write_bytes(b"")
    (tmp_path / "c" / "libdirect_forces-0123456789abcdef.log").write_text("")
    (tmp_path / "c" / "libp3m_pp-0123456789abcdef.123.tmp").write_bytes(b"")
    assert cache_entries() == cache_entries(str(tmp_path / "c")) == 1


def test_build_all_uses_the_chosen_dir_without_nvcc(monkeypatch, tmp_path):
    """A library found in the chosen directory is loaded as it is: 0 s of
    build, no nvcc compile."""
    enable_compile_cache(str(tmp_path / "c"))
    monkeypatch.setenv("CUDA_HOME", _fake_nvcc(tmp_path / "a", "V12.8.93"))
    path = _build.library_path("direct_forces")
    path.write_bytes(b"")
    built = dict(_build.BUILT)
    assert _build.build_all(["direct_forces"]) == {"direct_forces": (path, 0.0)}
    assert _build.BUILT == built


def test_cli_flag_sets_the_cache(tmp_path, capsys):
    cache = str(tmp_path / "cli")
    torch_app.main(["--compile-cache", cache, "--platform", "cpu", *RUN])
    assert _build.build_dir() == tmp_path / "cli" and os.path.isdir(cache)
    assert f"compile cache {cache}: 0 libraries; built in this process: " \
           "none" in capsys.readouterr().err


def test_cli_bare_flag_before_subcommand(monkeypatch, tmp_path):
    monkeypatch.setenv("NBODY_TPU_TORCH_CACHE_DIR", str(tmp_path / "bare"))
    state = str(tmp_path / "s.npz")
    torch_app.main(["--compile-cache", "--platform", "cpu", *RUN,
                    "--save", state])
    assert _build.build_dir() == tmp_path / "bare"
    assert (tmp_path / "bare").is_dir() and os.path.exists(state)


def test_platform_flag_composes_with_bare_compile_cache(monkeypatch, tmp_path):
    """--platform's value must not read as the subcommand (tests/
    test_app.py:300)."""
    monkeypatch.setenv("NBODY_TPU_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    state = str(tmp_path / "s.npz")
    torch_app.main(["--platform", "cpu", "--compile-cache", *RUN,
                    "--save", state])
    assert os.path.exists(state)
    assert (tmp_path / "cache").is_dir()


def test_compile_cache_equals_form_keeps_subcommand_named_dir(tmp_path,
                                                              monkeypatch):
    monkeypatch.chdir(tmp_path)
    state = str(tmp_path / "s.npz")
    torch_app.main(["--compile-cache=run", "--platform", "cpu", *RUN,
                    "--save", state])
    assert (tmp_path / "run").is_dir() and os.path.exists(state)
    assert _build.build_dir().name == "run"


@pytest.mark.parametrize("argv,want", [
    (["--compile-cache", "run", "--n", "3"],
     ["--compile-cache", "", "run", "--n", "3"]),
    (["--platform", "cpu", "--compile-cache", "run"],
     ["--platform", "cpu", "--compile-cache", "", "run"]),
    (["--compile-cache", "--platform", "cpu", "run"],
     ["--compile-cache", "", "--platform", "cpu", "run"]),
    (["--compile-cache", "D", "run"], ["--compile-cache", "D", "run"]),
    (["--compile-cache=run", "run"], ["--compile-cache=run", "run"]),
    (["--compile-cache"], ["--compile-cache", ""]),
    (["run", "--compile-cache"], ["run", "--compile-cache"]),
])
def test_bare_flag_preprocessor_matches_nbody_tpus(argv, want):
    from nbody_tpu.app import _fix_bare_compile_cache

    assert torch_app._fix_bare_compile_cache(argv) == want
    assert _fix_bare_compile_cache(argv) == want
