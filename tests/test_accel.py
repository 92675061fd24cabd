"""The platform switch, the compile-cache placement and chip_smoke.py's
refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ffmpeg_ffv2_tpu import accel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_stage_plan_gpu_jits_and_takes_kernels():
    plan = accel.stage_plan("gpu")
    assert plan.jit
    assert all(plan.impl(s) == "kernel" for s in accel.KERNEL_STAGES)


def test_stage_plan_cpu_runs_references_eagerly():
    plan = accel.stage_plan("cpu")
    assert not plan.jit
    assert all(plan.impl(s) == "xla" for s in accel.KERNEL_STAGES)
    assert accel.stage_plan() == plan          # the tests run on the CPU
    with pytest.raises(KeyError):
        plan.impl("render")


def test_encoder_takes_its_plan_from_the_platform():
    from ffmpeg_ffv2_tpu.ffv1.device_coder import DeviceFFV1Encoder
    from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config
    dev = DeviceFFV1Encoder(32, 16, "yuv420p", FFV1Config(level=3,
                                                          slices=4))
    assert dev.plan == accel.stage_plan("cpu")


def _coder_call(interpret):
    from ffmpeg_ffv2_tpu.ffv1.pallas_coder import rac_pallas_packed
    return rac_pallas_packed(jnp.zeros((8, 32), jnp.int32),
                             interpret=interpret)


def _adapt_call(interpret):
    from ffmpeg_ffv2_tpu.ffv1.adapt_pallas import adapt_pallas
    z = jnp.zeros((2,), jnp.int32)
    return adapt_pallas(jnp.zeros((8, 128), jnp.int32), z, z, z - 1,
                        jnp.zeros((2, 33, 128), jnp.int32),
                        jnp.zeros((128,), jnp.int32), 2, 8,
                        interpret=interpret)


def _vlc_call(interpret):
    from ffmpeg_ffv2_tpu.ffv1.device_rice import vlc_adapt_pallas
    z = jnp.zeros((2,), jnp.int32)
    return vlc_adapt_pallas(jnp.zeros((8, 128), jnp.int32), z, z, z - 1,
                            jnp.zeros((2, 5, 128), jnp.int32), 2, 8, 8,
                            interpret=interpret)


@pytest.mark.parametrize("call", [_coder_call, _adapt_call, _vlc_call],
                         ids=["coder", "adapt", "vlc"])
def test_kernel_without_interpret_raises_on_cpu(call):
    with pytest.raises(RuntimeError, match="needs a GPU"):
        call(False)
    out = call(True)                       # interpret mode still runs
    assert all(np.all(np.isfinite(np.asarray(o))) for o in out)


def test_compile_cache_from_environment(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert accel.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = accel.setup_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _run_smoke(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_without_gpu():
    r = _run_smoke(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
