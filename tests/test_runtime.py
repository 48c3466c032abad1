"""Entry-point runtime settings: the persistent compile cache's location,
and the smoke test's refusal to run anywhere but on a GPU."""

import os

import jax
import pytest

import chip_smoke
from radiativetransfer_tpu import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, from_env):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits at
    a fixed, git-ignored path inside the checkout."""
    if from_env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
        with open(os.path.join(REPO, ".gitignore")) as fh:
            assert ".jax_cache/" in fh.read().split()
    assert runtime.compile_cache_dir() == want
    before = jax.config.jax_compilation_cache_dir
    try:
        assert runtime.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_smoke_refuses_cpu_backend():
    """chip_smoke never carries on without a GPU; only its toy-size
    rehearsal accepts the CPU."""
    devices = jax.devices("cpu")
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.require_gpu(devices)
    chip_smoke.require_gpu(devices, allow_cpu=True)


def test_smoke_four_selects_only_the_four_card_phase():
    assert chip_smoke.select_phases(four=True) == ("four_card",)
    default = chip_smoke.select_phases(four=False)
    assert "four_card" not in default
    assert default == ("sweep", "tracer", "uniform_cli", "sparse_cli")
    assert set(default + ("four_card",)) == set(chip_smoke.PHASE_FUNCS)
