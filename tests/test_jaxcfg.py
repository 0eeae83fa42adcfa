"""Compile-cache rule (utils/jaxcfg.py): JAX_COMPILATION_CACHE_DIR when
set, else the checkout's own .jax_cache; off under PARAGRAPH_TPU_NO_CACHE."""
import os

import pytest

from paragraph_tpu.utils import jaxcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env,want", [
    ({}, os.path.join(REPO, ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": "/some/cache"}, "/some/cache"),
    ({"JAX_COMPILATION_CACHE_DIR": "/some/cache",
      "PARAGRAPH_TPU_NO_CACHE": "1"}, ""),
], ids=["default_in_checkout", "env_var_honoured", "disabled"])
def test_cache_dir_rule(monkeypatch, env, want):
    for k in ("JAX_COMPILATION_CACHE_DIR", "PARAGRAPH_TPU_NO_CACHE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert jaxcfg.cache_dir() == want


def test_configure_sets_only_the_checkout_cache(monkeypatch):
    """With the env var unset, configure() points JAX at <repo>/.jax_cache
    and nowhere else; with it set, configure() sets nothing."""
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    for k in ("JAX_COMPILATION_CACHE_DIR", "PARAGRAPH_TPU_NO_CACHE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(jaxcfg, "_configured", False)
    jaxcfg.configure()
    dirs = [v for k, v in calls if k == "jax_compilation_cache_dir"]
    assert dirs == [os.path.join(REPO, ".jax_cache")]

    calls.clear()
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    monkeypatch.setattr(jaxcfg, "_configured", False)
    jaxcfg.configure()
    assert calls == []
