"""What the package needs from its environment: imports, the compile
cache's location, and a smoke script that refuses to run without a GPU."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_path_imports_without_optional_packages():
    """The CLI, trainer, app runner and batched datagen import with
    flax, orbax, PIL and tqdm hidden: the machine that runs them may
    have none of them."""
    code = (
        "import sys\n"
        "for name in ('flax', 'orbax', 'orbax.checkpoint', 'PIL', 'tqdm'):\n"
        "    sys.modules[name] = None\n"
        "import fea_tpu.cli, fea_tpu.train.trainer, fea_tpu.apps.runner\n"
        "import fea_tpu.datagen.batched, fea_tpu.metrics.accuracy\n"
        "from fea_tpu.utils.progress import progress\n"
        "list(progress(range(3), desc='x'))\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compilation_cache_dir(monkeypatch, tmp_path, env_dir):
    from fea_tpu.utils.device import compilation_cache_dir

    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert compilation_cache_dir() == os.path.join(ROOT, ".jax_cache")
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
        assert compilation_cache_dir() == want


def test_enable_compilation_cache_uses_the_env_dir(monkeypatch, tmp_path):
    import jax

    from fea_tpu.utils.device import enable_compilation_cache

    before = jax.config.jax_compilation_cache_dir
    want = str(tmp_path / "jaxcache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    try:
        assert enable_compilation_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
        assert os.path.isdir(want)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_fails_without_gpu(tmp_path):
    """On a CPU-only JAX the device phase fails: non-zero exit and no
    result line."""
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
         "--out", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "FAILED in phase 0" in out.stdout


def test_fem_device_products_pin_precision():
    """Every jnp/lax matrix product in fea_tpu/fem names its precision,
    so no reduced-precision (TF32) pass enters a solve."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    assert chip_smoke.unpinned_fem_products() == []
    device, pinned, host = chip_smoke.device_products(
        os.path.join(ROOT, "fea_tpu", "fem", "solver.py")
    )
    assert device == pinned > 0


def test_chip_smoke_dp_step_comparison(tmp_path, monkeypatch):
    """The 4-card check of chip_smoke.py at a tiny width on virtual CPU
    devices: one step on a 4-device ('dp',) mesh matches one device within
    the script's bounds, and a gradient taken from one device's rows only
    is refused."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.pop(0)
    sz = cs.Sizes(train_image=32, input_dim=8)
    l1, m1 = cs.dp_step(1, sz, tmp_path)
    l4, m4 = cs.dp_step(4, sz, tmp_path)
    assert abs(l4 - l1) / abs(l1) <= cs.DP_LOSS_BOUND
    total, worst, _, leaves = cs.moment_difference(m1, m4)
    assert worst <= cs.DP_MOMENT_BOUND and leaves > 0.9 * len(m1)

    rows = cs.RandomDataset

    class OneDeviceRows(rows):
        def __getitem__(self, i):
            return rows.__getitem__(self, i % (sz.batch // 4))

    monkeypatch.setattr(cs, "RandomDataset", OneDeviceRows)
    _, mq = cs.dp_step(1, sz, tmp_path / "rows")
    assert cs.moment_difference(m1, mq)[1] > 100 * cs.DP_MOMENT_BOUND
