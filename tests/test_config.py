"""The route function, the compile-cache location and the pytree-dataclass
helper."""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracercore import config
from raytracercore.core.pytree import PyTreeNode, field
from raytracercore.scene import loader
from raytracercore.scene.types import freeze_scene


@pytest.fixture(scope="module")
def arrays(request):
    return freeze_scene(loader.parse(request.getfixturevalue("bounce_txt")))


@pytest.mark.parametrize("backend,dtype,want", [
    ("gpu", jnp.float32, "triton"),
    ("gpu", jnp.float16, "xla"),
    ("cpu", jnp.float32, "xla"),
    ("cpu", jnp.float64, "xla"),
    ("gpu", jnp.bfloat16, "xla"),
])
def test_trace_route_by_backend(arrays, monkeypatch, backend, dtype, want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert config.trace_route(arrays, dtype) == want


@pytest.mark.parametrize("case", ["debug_geom", "float64"])
def test_trace_route_gpu_fallback_logged_once(arrays, monkeypatch, caplog,
                                              case):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    config._log_fallback.cache_clear()
    scene = arrays.replace(debug_geom=True) if case == "debug_geom" \
        else arrays
    dtype = jnp.float64 if case == "float64" else jnp.float32
    with caplog.at_level(logging.WARNING, logger=config.__name__):
        for _ in range(3):
            assert config.trace_route(scene, dtype) == "xla"
    assert len(caplog.records) == 1
    assert "megakernel not used" in caplog.records[0].getMessage()


def test_renderer_takes_kernel_on_gpu_route(monkeypatch, bounce_txt):
    from raytracercore.render import fused
    from raytracercore.render.renderer import Renderer

    scene = loader.parse(bounce_txt)
    scene.width = scene.height = 8
    monkeypatch.setattr(config, "trace_route",
                        lambda s, dtype: "triton")
    assert Renderer(scene).trace_fn is fused.trace_fused
    monkeypatch.setattr(config, "trace_route", lambda s, dtype: "xla")
    assert Renderer(scene).trace_fn is None
    # Past the threshold the BVH takes over, whatever the route.
    assert Renderer(scene, accelerator="bvh").trace_fn is None


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_wins(monkeypatch, tmp_path, restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.enable_compile_cache() == str(tmp_path)
    # The code sets no directory of its own; JAX reads the variable.
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_default_in_repo(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = config.enable_compile_cache()
    assert path == str(config.REPO_ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert config.enable_compile_cache() == path  # fixed, not per call


class _Node(PyTreeNode):
    a: jnp.ndarray
    b: jnp.ndarray
    n: int = field(static=True, default=3)


def test_pytree_fields_and_static_metadata():
    x = _Node(a=jnp.ones(2), b=jnp.zeros(3), n=5)
    leaves, treedef = jax.tree.flatten(x)
    assert len(leaves) == 2  # the static field is not a leaf
    y = jax.tree.unflatten(treedef, leaves)
    assert y.n == 5 and isinstance(y, _Node)
    assert _Node(a=jnp.ones(2), b=jnp.zeros(3)).n == 3
    # Static fields are part of the structure: a different value is a
    # different tree.
    assert treedef != jax.tree.structure(x.replace(n=6))


def test_pytree_replace_and_frozen():
    x = _Node(a=jnp.ones(2), b=jnp.zeros(3))
    y = x.replace(a=jnp.full(2, 7.0))
    assert float(y.a[0]) == 7.0 and float(x.a[0]) == 1.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        x.a = jnp.zeros(2)


def test_pytree_under_jit_and_grad():
    @jax.jit
    def f(node):
        return jnp.sum(node.a * node.n) + jnp.sum(node.b)

    x = _Node(a=jnp.arange(3.0), b=jnp.ones(2), n=2)
    assert float(f(x)) == pytest.approx(8.0)
    g = jax.grad(f)(x)
    np.testing.assert_allclose(np.asarray(g.a), [2.0, 2.0, 2.0])
    assert g.n == 2
    # tree.map keeps the static field and maps only the leaves.
    z = jax.tree.map(lambda v: v * 0, x)
    assert z.n == 2 and float(jnp.sum(z.a)) == 0
