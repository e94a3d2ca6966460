"""The platform policy (policy.py), the compile-cache location
(utils/compile_cache.py) and chip_smoke.py's refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

import pathtracer_tpu as pt
from pathtracer_tpu import meshes, policy
from pathtracer_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scenes():
    _, small = pt.cornell_box(res=(8, 8))
    _, sb = meshes.sphere_in_box(16, 32)  # 1036 triangles > BRUTE_MAX
    return {"small": small, "large": sb.build()}


@pytest.mark.parametrize("plat,size,differentiable,expected", [
    ("gpu", "small", False, "pallas"),
    ("gpu", "large", False, policy.GPU_LARGE_SCENE),
    ("gpu", "small", True, "brute"),
    ("gpu", "large", True, policy.GPU_LARGE_SCENE),
    ("cpu", "small", False, "brute"),
    ("cpu", "large", False, "bvh"),
    ("cpu", "small", True, "brute"),
    ("cpu", "large", True, "bvh"),
])
def test_policy_table(scenes, plat, size, differentiable, expected):
    assert policy.choose_backend(scenes[size], differentiable=differentiable,
                                 platform_name=plat) == expected


@pytest.mark.parametrize("plat", ["rocm", "METAL", "interpreter"])
def test_policy_unknown_platform_is_an_error(scenes, plat):
    with pytest.raises(ValueError, match="no backend policy"):
        policy.choose_backend(scenes["small"], platform_name=plat)


def test_policy_default_platform_is_first_device(scenes):
    assert policy.platform() == jax.devices()[0].platform == "cpu"
    assert policy.choose_backend(scenes["small"]) == "brute"
    assert policy.choose_backend(scenes["large"]) == "bvh"


def test_resolve_explicit_and_unknown(scenes):
    for name in ("brute", "bvh", "bvh-gather", "pallas"):
        assert policy.resolve(name, scenes["small"]) == name
    with pytest.raises(ValueError, match="unknown backend"):
        policy.resolve("beam", scenes["small"])
    with pytest.raises(ValueError, match="unknown backend"):
        policy.resolve("cluster", scenes["large"])
    # the megakernel has no gradient
    with pytest.raises(ValueError, match="unknown backend"):
        policy.resolve("pallas", scenes["small"], differentiable=True)


def test_check_kernel_platform():
    policy.check_kernel_platform(True)  # interpret: anywhere
    with pytest.raises(ValueError, match="interpret=True"):
        policy.check_kernel_platform(False)
    with pytest.raises(ValueError, match="interpret=True"):
        policy.check_kernel_platform(False, jax.devices("cpu")[:2])


def test_render_film_auto_follows_policy(scenes, monkeypatch):
    """render_film resolves 'auto' through the policy: on the CPU the
    dense path (same film as backend='brute'); a pretend-GPU platform
    routes small scenes to the megakernel, which then refuses to compile
    for the CPU devices without interpret=True."""
    cam, scene = pt.corner_scene(res=(8, 8))
    auto = pt.render_film(cam, scene, 2, 2)
    brute = pt.render_film(cam, scene, 2, 2, backend="brute")
    assert (auto.data == brute.data).all()
    monkeypatch.setattr(policy, "platform", lambda: "gpu")
    with pytest.raises(ValueError, match="interpret=True"):
        pt.render_film(cam, scene, 2, 2)


def test_compile_cache_dir_env_set(tmp_path):
    env = {compile_cache.ENV_VAR: str(tmp_path / "cc")}
    assert compile_cache.cache_dir(env) == str(tmp_path / "cc")


def test_compile_cache_dir_env_unset():
    assert compile_cache.cache_dir({}) == compile_cache.DEFAULT_DIR
    assert compile_cache.cache_dir({compile_cache.ENV_VAR: ""}) == \
        compile_cache.DEFAULT_DIR
    # one fixed path inside the checkout, ignored by git
    assert compile_cache.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_configure(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        assert compile_cache.configure() == compile_cache.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == \
            compile_cache.DEFAULT_DIR
        # with the variable set, the code sets no cache of its own
        jax.config.update("jax_compilation_cache_dir", "sentinel")
        monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
        assert compile_cache.configure() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == "sentinel"
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_lands_in_env_dir(tmp_path):
    """A fresh process with JAX_COMPILATION_CACHE_DIR set writes its cache
    entries there."""
    code = ("import pathtracer_tpu as pt, jax, jax.numpy as jnp\n"
            "jax.config.update('jax_persistent_cache_min_compile_time_secs',"
            " 0)\n"
            "jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(7)).block_until_ready()"
            "\nprint(jax.config.jax_compilation_cache_dir)\n")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           compile_cache.ENV_VAR: str(tmp_path / "cc")}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == str(tmp_path / "cc")
    assert os.listdir(tmp_path / "cc")


def _run_smoke(script, cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_without_gpu():
    out = _run_smoke(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stdout + out.stderr


def test_chip_smoke_refuses_alone(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    script fails instead of reporting a result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_smoke(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
