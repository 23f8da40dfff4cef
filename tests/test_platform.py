"""Platform-dependent choices: which implementation runs where, where
the compilation cache goes, and that the chip check refuses the CPU."""
import os
import subprocess
import sys

import pytest

from ptudes_tpu.ops import backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_EXPECTED = {
    "gpu": {"gn_loop": "triton", "ekf_predict": "triton"},
    "cpu": {"gn_loop": "xla", "ekf_predict": "assoc"},
    "metal": {"gn_loop": "xla", "ekf_predict": "assoc"},
    "rocm": {"gn_loop": "xla", "ekf_predict": "assoc"},
}


@pytest.mark.parametrize("platform", sorted(_EXPECTED))
def test_backend_choice_by_platform(platform):
    """Kernels only where they are compiled for the device and won their
    A/B (the GPU); the plain XLA forms everywhere else."""
    for stage, form in _EXPECTED[platform].items():
        assert backend.choose(stage, platform) == form
        assert backend.resolve(stage, "auto", platform) == form
        assert backend.resolve(stage, "unroll", platform) == "unroll"


def test_backend_default_platform_is_jax_default():
    assert backend.choose("gn_loop") == "xla"   # tests pin the CPU
    with pytest.raises(ValueError):
        backend.choose("no_such_stage")


def test_interpret_only_in_tests():
    """No library or launch code passes interpret=True: off the card the
    plain XLA forms run instead of an interpreted kernel."""
    out = subprocess.run(
        ["git", "grep", "-n", "interpret=True", "--", "ptudes_tpu",
         "bench.py", "bench_long.py", "chip_smoke.py"],
        cwd=REPO, capture_output=True, text=True)
    if out.returncode not in (0, 1):
        pytest.skip("not a git checkout")
    assert out.stdout == ""


def _cache_dir(env_extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "JAX_PLATFORMS")}
    env.update(env_extra)
    code = ("import jax, ptudes_tpu\n"
            "print('DIR=%s' % jax.config.jax_compilation_cache_dir)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return r.stdout.strip().split("DIR=")[-1]


def test_cache_respects_jax_compilation_cache_dir(tmp_path):
    d = str(tmp_path / "cc")
    assert _cache_dir({"JAX_COMPILATION_CACHE_DIR": d,
                       "JAX_PLATFORMS": "cuda"}) == d


def test_cache_defaults_to_fixed_path_in_checkout():
    got = _cache_dir({"JAX_PLATFORMS": "cuda"})
    assert got == os.path.join(REPO, ".jax_cache")
    ignored = subprocess.run(
        ["git", "check-ignore", "-q", os.path.join(got, "entry")], cwd=REPO)
    assert ignored.returncode in (0, 128)   # 128: not a git checkout


def test_cache_off_when_pinned_to_cpu():
    assert _cache_dir({"JAX_PLATFORMS": "cpu"}) == "None"


def test_chip_smoke_refuses_the_cpu():
    """Without a GPU the chip check exits non-zero and prints no ok line."""
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True,
        text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not a GPU" in r.stderr
