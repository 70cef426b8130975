"""Nothing the benchmark loads is JAX or the JAX package."""

import subprocess
import sys

from obbench import guard, harness


def test_top_level_names_compared_whole():
    mods = {"oceanbase_tpu_torch": 1, "oceanbase_tpu_torch.sql.session": 1,
            "jax": 1, "jax.numpy": 1, "jaxlib.xla": 1, "flax": 1,
            "oceanbase_tpu": 1, "oceanbase_tpu.sql": 1, "jaxtyping": 1,
            "numpy": 1}
    assert guard.forbidden_loaded(mods) == [
        "flax", "jax", "jax.numpy", "jaxlib.xla", "oceanbase_tpu",
        "oceanbase_tpu.sql"]


def test_a_run_loads_no_jax():
    # a whole tiny run in a fresh process, then its modules
    code = f"""
import sys
sys.path.insert(0, {str(harness.CHECKOUT)!r})
from obbench import guard, harness
orig = harness.load_config
def small(name):
    cfg = orig(name)
    cfg.update(rows=5000, queries=20, scale_factor=0.005)
    return cfg
harness.load_config = small
spec = harness.load_spec()
for cell in ("tpch_sf1.q1", "bigann10m.knn"):
    out = harness.run_cell(spec, harness.find_cell(spec, cell), 9, 0.2,
                           True, device="cpu")
    assert out["correct"], out
print(",".join(guard.forbidden_loaded()) or "none")
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=harness.CHECKOUT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "none"


def test_caches_pinned_inside_the_checkout(monkeypatch, tmp_path):
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
                "CUDA_CACHE_PATH"):
        monkeypatch.delenv(var, raising=False)
    guard.pin_caches(tmp_path)
    import os

    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
                "CUDA_CACHE_PATH"):
        assert os.environ[var].startswith(str(tmp_path / ".obbench_cache"))
