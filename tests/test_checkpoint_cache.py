"""The .npz checkpoint, the compile-cache location, and the main path's
imports."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from terastructure_tpu.config import SVIConfig
from terastructure_tpu.data import GenotypeData, simulate_psd
from terastructure_tpu.io import checkpoint as ckpt
from terastructure_tpu.svi import engine
from terastructure_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fit_state(steps=3, seed=5):
    n, l, k = 24, 64, 2
    _, _, x = simulate_psd(n, l, k, seed=seed)
    data = GenotypeData.from_dense(x, validation_frac=0, heldout_frac=0,
                                   seed=seed)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=8, seed=seed,
                    lambda_mode="stored")
    packed = jnp.asarray(data.packed)
    run = engine.make_run_chunk(cfg, steps)
    return cfg, packed, run, run(engine.init_state(cfg), packed)


@pytest.mark.parametrize("typed_key", [False, True])
def test_npz_roundtrip_and_bitwise_resume(tmp_path, typed_key):
    """Every field survives the .npz (raw and typed keys alike), and a
    resumed run continues bit-for-bit like an uninterrupted one."""
    cfg, packed, run, state = _fit_state()
    if typed_key:
        state = state._replace(key=jax.random.wrap_key_data(state.key))
    ckpt.save_checkpoint(str(tmp_path / "ck"), state, cfg)
    assert sorted(os.listdir(tmp_path / "ck")) == ["config.json",
                                                   "state.npz"]
    back, cfg2 = ckpt.restore_checkpoint(str(tmp_path / "ck"))
    assert cfg2 == cfg and int(back.t) == int(state.t) == 3
    assert jax.dtypes.issubdtype(back.key.dtype,
                                 jax.dtypes.prng_key) == typed_key
    np.testing.assert_array_equal(np.asarray(back.gamma),
                                  np.asarray(state.gamma))
    np.testing.assert_array_equal(np.asarray(back.lamb),
                                  np.asarray(state.lamb))
    straight = run(state, packed)
    resumed = run(engine.SVIState(jnp.asarray(back.gamma),
                                  jnp.asarray(back.lamb),
                                  jnp.int32(back.t), back.key), packed)
    np.testing.assert_array_equal(np.asarray(resumed.gamma),
                                  np.asarray(straight.gamma))


def test_background_save_and_sharding_fn(tmp_path):
    """block=False writes on a thread after copying to the host (the
    caller may keep stepping and even delete the state); restore waits
    for it and places arrays through sharding_fn."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from terastructure_tpu.parallel import mesh as meshlib

    cfg, packed, run, state = _fit_state(seed=6)
    want = np.asarray(state.gamma).copy()
    ckpt.save_checkpoint(str(tmp_path / "ck"), state, cfg, block=False)
    state = run(state, packed)              # donates the saved buffers
    mesh = meshlib.make_mesh(meshlib.MeshSpec(ind=8, snp=1))
    placed = {}

    def put(name, arr):
        spec = meshlib.GAMMA_SPEC if name == "gamma" else P()
        placed[name] = jax.device_put(arr, NamedSharding(mesh, spec))
        return placed[name]

    back, _ = ckpt.restore_checkpoint(str(tmp_path / "ck"), sharding_fn=put)
    assert set(placed) == {"gamma", "lamb"}
    assert len(back.gamma.sharding.device_set) == 8
    np.testing.assert_array_equal(np.asarray(back.gamma), want)


def test_background_save_error_surfaces(tmp_path):
    cfg, _, _, state = _fit_state(steps=1)
    (tmp_path / "blocker").write_text("a file where the directory goes")
    with pytest.raises(OSError):
        ckpt.save_checkpoint(str(tmp_path / "blocker" / "ck"), state, cfg,
                             block=False)
        ckpt.wait_until_finished()


def test_compile_cache_follows_env(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own reading of it wins
    and the helper sets nothing."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    assert compile_cache.enable_compile_cache() == "/some/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    """Unset, the cache lands at a fixed path in the checkout — the same
    path in every process, so a second run finds the first's programs."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = compile_cache.enable_compile_cache()
        assert got == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
        assert compile_cache.enable_compile_cache() == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


def test_main_path_imports_only_installed_packages():
    """Importing the CLI and everything `fit` reaches pulls in nothing
    beyond the standard library, numpy, scipy and JAX's own modules
    (what those load themselves is theirs, imported first)."""
    code = """
import sys
import jax, jax.numpy, jax.experimental.pallas
import numpy, scipy.optimize, scipy.special
before = set(sys.modules)
import terastructure_tpu.cli
import terastructure_tpu.svi.driver, terastructure_tpu.io.checkpoint
import terastructure_tpu.io.export, terastructure_tpu.parallel.fit
import terastructure_tpu.svi.stream, terastructure_tpu.utils.compile_cache
new = {m.split('.')[0] for m in set(sys.modules) - before}
print(' '.join(sorted(new)))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    new = set(out.stdout.split())
    allowed = {"terastructure_tpu", "numpy", "scipy", "jax", "jaxlib"}
    extra = {m for m in new - allowed
             if m not in sys.stdlib_module_names and not m.startswith("_")}
    assert not extra, extra
