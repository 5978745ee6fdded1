"""CLI device selection and the compilation-cache setup."""
import os
import subprocess
import sys

import jax
import pytest

import conftest  # noqa: F401
from paml_tpu import __main__ as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def platform_updates(monkeypatch):
    """Record jax_platforms updates instead of applying them."""
    seen = []
    real = jax.config.update

    def update(name, value):
        if name == "jax_platforms":
            seen.append(value)
        else:
            real(name, value)
    monkeypatch.setattr(jax.config, "update", update)
    return seen


def test_init_backend_raises_when_the_device_fails(monkeypatch,
                                                   platform_updates):
    """A GPU that fails to start is an error, not a switch to the CPU."""
    def broken():
        raise RuntimeError("Unable to initialize backend 'cuda'")
    monkeypatch.setattr(jax, "devices", broken)
    monkeypatch.delenv("PAML_TPU_CLI_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli._init_jax_backend(want_accel=True)
    assert platform_updates == []


@pytest.mark.parametrize("env,want_accel,pinned", [
    (None, True, []),              # fit programs: JAX's default device
    (None, False, ["cpu"]),        # host-loop programs pin to the CPU
    ("cpu", True, ["cpu"]),        # explicit CPU choice
])
def test_init_backend_device_choice(monkeypatch, platform_updates, env,
                                    want_accel, pinned):
    if env is None:
        monkeypatch.delenv("PAML_TPU_CLI_DEVICE", raising=False)
    else:
        monkeypatch.setenv("PAML_TPU_CLI_DEVICE", env)
    cli._init_jax_backend(want_accel=want_accel)
    assert platform_updates == pinned


def test_init_backend_rejects_unknown_device(monkeypatch, platform_updates):
    monkeypatch.setenv("PAML_TPU_CLI_DEVICE", "tpu")
    with pytest.raises(ValueError, match="auto or cpu"):
        cli._init_jax_backend(want_accel=True)


@pytest.mark.parametrize("preset", [True, False])
def test_compilation_cache_dir(tmp_path, preset):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache is
    <checkout>/.jax_cache.  f32 products default to HIGHEST either way."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    if preset:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    out = subprocess.run(
        [sys.executable, "-c",
         "import paml_tpu, jax; print(jax.config.jax_compilation_cache_dir);"
         " print(jax.config.jax_default_matmul_precision)"],
        cwd=tmp_path, env=env, capture_output=True, text=True, check=True,
        timeout=120).stdout.split()
    expect = (str(tmp_path / "cache") if preset
              else os.path.join(REPO, ".jax_cache"))
    assert out == [expect, "highest"]
