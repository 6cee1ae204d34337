"""The port's kernel-library cache switch (kubetpu_torch/utils/
compilation.py) against the JAX package's persistent-XLA-cache switch
(kubetpu/utils/compilation.py): idempotence, the environment override,
an explicit directory beating the environment, and the first caller
winning; the same call sequence through both modules gives the same
precedence.  And ops/_build.py builds into the directory chosen."""
import os

import pytest

from kubetpu.utils import compilation as jcomp
from kubetpu_torch.ops import _build
from kubetpu_torch.utils import compilation as tcomp
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)

JAX_ENV = "KUBETPU_XLA_CACHE_DIR"


@pytest.fixture
def fresh(monkeypatch):
    """Both modules' latches reset, and JAX's cache directory detached,
    for the test; restored afterwards."""
    import jax
    prev_dir = getattr(jax.config, "jax_compilation_cache_dir", None)
    monkeypatch.setattr(jcomp, "_enabled", None)
    monkeypatch.setattr(tcomp, "_enabled", None)
    monkeypatch.delenv(JAX_ENV, raising=False)
    monkeypatch.delenv(tcomp.ENV, raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    yield
    jax.config.update("jax_compilation_cache_dir", prev_dir)


def both(tmp_path, calls, env=None, monkeypatch=None):
    """Run one call sequence through both modules, each under its own
    environment variable and directory root; returns the directories
    each call returned, relative to its root."""
    out = {}
    for name, mod, var in (("jax", jcomp, JAX_ENV),
                           ("torch", tcomp, tcomp.ENV)):
        root = tmp_path / name
        if env is not None:
            monkeypatch.setenv(var, str(root / env))
        got = []
        for arg in calls:
            d = mod.enable_persistent_cache(
                None if arg is None else str(root / arg))
            got.append(os.path.relpath(d, root))
        out[name] = got
    return out


def test_enable_is_idempotent(tmp_path, fresh):
    got = both(tmp_path, ["one", "two"])
    assert got["torch"] == got["jax"] == ["one", "one"]
    assert os.path.isdir(tmp_path / "torch" / "one")
    assert not os.path.exists(tmp_path / "torch" / "two")
    assert tcomp.cache_dir() == str(tmp_path / "torch" / "one")


def test_env_override_wins_over_default(tmp_path, fresh, monkeypatch):
    got = both(tmp_path, [None], env="from-env", monkeypatch=monkeypatch)
    assert got["torch"] == got["jax"] == ["from-env"]
    assert os.path.isdir(tmp_path / "torch" / "from-env")


def test_explicit_dir_beats_env(tmp_path, fresh, monkeypatch):
    got = both(tmp_path, ["explicit"], env="env", monkeypatch=monkeypatch)
    assert got["torch"] == got["jax"] == ["explicit"]


def test_first_caller_wins(tmp_path, fresh, monkeypatch):
    """The embedding application's directory (its first call, the twin
    of a jax_compilation_cache_dir it set) survives the Scheduler's
    later enable and the environment."""
    import jax
    theirs = str(tmp_path / "jax" / "theirs")
    jax.config.update("jax_compilation_cache_dir", theirs)
    assert jcomp.enable_persistent_cache(str(tmp_path / "jax" / "ours")) \
        == theirs
    tcomp.enable_persistent_cache(str(tmp_path / "torch" / "theirs"))
    monkeypatch.setenv(tcomp.ENV, str(tmp_path / "torch" / "env"))
    assert tcomp.enable_persistent_cache(str(tmp_path / "torch" / "ours")) \
        == str(tmp_path / "torch" / "theirs")
    assert tcomp.enable_persistent_cache() == \
        str(tmp_path / "torch" / "theirs")
    assert not os.path.exists(tmp_path / "torch" / "ours")
    assert not os.path.exists(tmp_path / "torch" / "env")


def test_default_is_the_package_build_dir(fresh):
    assert tcomp.DEFAULT_CACHE_DIR == os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(
            _build.__file__))), "_build")
    assert tcomp.cache_dir() == tcomp.DEFAULT_CACHE_DIR


def test_build_lands_in_the_chosen_dir(tmp_path, fresh, monkeypatch):
    """ops/_build.build compiles into the cache directory and finds it
    there the next time (nvcc injected: the CPU tests run without it)."""
    calls = []

    def fake_compile(name, out):
        calls.append(out)
        with open(out, "wb") as fh:
            fh.write(b"lib")
        return 0.5

    monkeypatch.setattr(_build, "_compile", fake_compile)
    monkeypatch.setattr(_build, "build_seconds", {})
    monkeypatch.setattr(_build, "library_source", {})
    monkeypatch.setenv(tcomp.ENV, str(tmp_path / "kernels"))
    path = _build.build("propose")
    assert path == str(tmp_path / "kernels" / _build.lib_name("propose"))
    assert _build.library_source["propose"] == "nvcc"
    assert _build.build("propose") == path
    assert _build.library_source["propose"] == "cached"
    assert calls == [path]
