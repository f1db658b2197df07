"""Where the compilation and export caches live (epidemicsimulator_tpu/utils).

With ``JAX_COMPILATION_CACHE_DIR`` set, both caches go under it and the
program sets no other directory; unset, both go to a fixed directory inside
the checkout that git ignores.  ``jax.config.update`` is recorded, not
applied, so the test process never turns a persistent cache on.
"""

import os
import pathlib

import jax
import jax.numpy as jnp
import pytest

from epidemicsimulator_tpu import utils


@pytest.fixture
def config_calls(monkeypatch):
    calls = {}
    monkeypatch.setattr(
        jax.config, "update", lambda k, v: calls.__setitem__(k, v)
    )
    return calls


def test_cache_dir_from_environment(monkeypatch, tmp_path, config_calls):
    env_dir = str(tmp_path / "jaxcache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    assert utils.cache_root() == env_dir
    assert utils.enable_compilation_cache() == env_dir
    assert os.path.isdir(env_dir)
    assert "jax_compilation_cache_dir" not in config_calls


def test_cache_dir_in_checkout(monkeypatch, tmp_path, config_calls):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = tmp_path / "checkout"
    monkeypatch.setattr(utils, "CHECKOUT_ROOT", str(root))
    want = str(root / ".cache" / "xla")
    assert utils.enable_compilation_cache() == want
    assert config_calls["jax_compilation_cache_dir"] == want
    assert utils.cache_root() == str(root / ".cache")
    # the real checkout's cache directory is ignored by git
    gitignore = pathlib.Path(__file__).resolve().parent.parent / ".gitignore"
    assert "/.cache/" in gitignore.read_text().split()


def test_export_cache_follows_the_cache_root(monkeypatch, tmp_path):
    from epidemicsimulator_tpu.world import device_build

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    out = device_build._call_exported_cached(
        "probe", (), lambda: jax.jit(lambda x: x + 1), (jnp.arange(4),)
    )
    assert out.tolist() == [1, 2, 3, 4]
    files = os.listdir(tmp_path / "esucd_export")
    assert len(files) == 1 and files[0].startswith("probe-")
