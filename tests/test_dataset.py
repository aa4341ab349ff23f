import numpy as np

from terastructure_tpu.data import GenotypeData, simulate_psd
from terastructure_tpu.models.psd import MISSING


def test_heldout_sets_excluded_from_training():
    _, _, x = simulate_psd(40, 60, 3, seed=1)
    data = GenotypeData.from_dense(x, validation_frac=0.02, heldout_frac=0.02, seed=1)
    dense = data.dense()
    for es in (data.validation, data.heldout):
        assert len(es) > 0
        # Entries recoded MISSING in the training matrix...
        assert (dense[es.ind_idx, es.snp_idx] == MISSING).all()
        # ...but their true values stored in the set match the source.
        np.testing.assert_array_equal(es.x, x[es.ind_idx, es.snp_idx])
    # Non-heldout entries unchanged.
    mask = np.ones_like(x, dtype=bool)
    for es in (data.validation, data.heldout):
        mask[es.ind_idx, es.snp_idx] = False
    np.testing.assert_array_equal(dense[mask], x[mask])


def test_validation_heldout_disjoint():
    _, _, x = simulate_psd(30, 50, 2, seed=2)
    data = GenotypeData.from_dense(x, validation_frac=0.05, heldout_frac=0.05, seed=2)
    a = set(zip(data.validation.ind_idx.tolist(), data.validation.snp_idx.tolist()))
    b = set(zip(data.heldout.ind_idx.tolist(), data.heldout.snp_idx.tolist()))
    assert not (a & b)


def test_pad_snps():
    _, _, x = simulate_psd(10, 13, 2, seed=3)
    data = GenotypeData.from_dense(x, validation_frac=0, heldout_frac=0, seed=3)
    padded = data.pad_snps(8)
    assert padded.packed.shape[0] == 16
    assert (padded.packed[13:] == 0xFF).all()


def test_simulate_respects_missing_frac():
    _, _, x = simulate_psd(50, 80, 3, missing_frac=0.1, seed=4)
    frac = (x == MISSING).mean()
    assert 0.05 < frac < 0.15


def test_from_bed_is_packed_native(tmp_path, monkeypatch):
    """from_bed must never densify (biobank RSS requirement): the
    carve works on the 2-bit matrix directly."""
    import terastructure_tpu.data.dataset as ds
    from terastructure_tpu.data import GenotypeData, simulate_psd
    from terastructure_tpu.data.bed import write_bed, write_bim, write_fam
    from terastructure_tpu.data.pack import pack2bit

    n, l, k = 52, 80, 3
    _, _, x = simulate_psd(n, l, k, seed=5, missing_frac=0.03)
    stem = str(tmp_path / "g")
    write_bed(stem + ".bed", pack2bit(np.ascontiguousarray(x.T)), n)
    write_fam(stem + ".fam", [f"i{i}" for i in range(n)])
    write_bim(stem + ".bim", [f"s{j}" for j in range(l)])

    def boom(*a, **kw):
        raise AssertionError("from_bed densified the matrix")

    monkeypatch.setattr(ds, "unpack2bit", boom)
    data = GenotypeData.from_bed(stem + ".bed", seed=5)
    assert data.n == n and data.l == l
    assert data.packed.shape == (l, (n + 3) // 4)
    assert len(data.validation) > 0 and len(data.heldout) > 0
    # eval entries were recoded MISSING in training, values preserved
    v = data.validation
    assert set(np.unique(v.x)) <= {0, 1, 2}
    from terastructure_tpu.data.dataset import _lookup_packed
    assert (_lookup_packed(data.packed, v.ind_idx, v.snp_idx) == 3).all()
    # and they match the original dense matrix
    np.testing.assert_array_equal(v.x, x[v.ind_idx, v.snp_idx])


def test_simulate_packed_device_moments():
    """Device-side simulator: genotype mean ~ 2 theta.beta per entry,
    missing fraction honored, packing convention matches pack2bit."""
    from terastructure_tpu.data.pack import unpack2bit
    from terastructure_tpu.data.simulate import simulate_packed_device
    from terastructure_tpu.models.psd import MISSING as M

    n, l, k = 512, 512, 3
    packed, theta = simulate_packed_device(n, l, k, seed=3,
                                           missing_frac=0.1, chunk=128)
    assert packed.shape == (l, n // 4) and packed.dtype == np.uint8
    x = unpack2bit(packed, n)                  # (l, n)
    miss = x == M
    assert abs(miss.mean() - 0.1) < 0.01
    # theta rows on the simplex
    np.testing.assert_allclose(theta.sum(1), 1.0, rtol=1e-5)
    # marginal genotype mean: E[x_ij] = 2 theta_i . beta_j with
    # beta ~ U(0,1)  =>  E over SNPs = sum_k theta_ik = 1
    per_ind = np.where(miss, np.nan, x.astype(float))
    m = np.nanmean(per_ind, axis=0)            # (n,) mean over SNPs
    assert abs(np.nanmean(m) - 1.0) < 0.02
    # structured theta should vary individual genotype means with the
    # dominant component (not all ~equal): check spread is non-trivial
    assert np.nanstd(m) > 0.01


def test_simulate_packed_device_resident_parity():
    """Device-resident simulator reproduces the host-spill variant's
    stream bit-for-bit when l % chunk == 0 (same rng/key folding)."""
    import jax

    from terastructure_tpu.data.simulate import (
        simulate_packed_device, simulate_packed_device_resident)

    n, l, k = 64, 128, 3
    pk_host, th_host = simulate_packed_device(
        n, l, k, seed=7, chunk=32, missing_frac=0.05)
    pk_dev, th_dev = simulate_packed_device_resident(
        n, l, k, seed=7, chunk=32, missing_frac=0.05)
    assert isinstance(pk_dev, jax.Array)
    np.testing.assert_array_equal(np.asarray(pk_dev), pk_host)
    np.testing.assert_array_equal(th_dev, th_host)


def test_simulate_packed_device_resident_tail():
    """l not a multiple of chunk: the clamped tail write still leaves
    every row a valid PSD draw (codes 0/1/2, no stray MISSING)."""
    from terastructure_tpu.data.pack import unpack2bit
    from terastructure_tpu.data.simulate import (
        simulate_packed_device_resident)

    n, l, k = 64, 100, 3
    pk_dev, theta = simulate_packed_device_resident(n, l, k, seed=1,
                                                    chunk=32)
    pk = np.asarray(pk_dev)
    assert pk.shape == (l, n // 4)
    x = unpack2bit(pk, n)
    assert set(np.unique(x)) <= {0, 1, 2}
    np.testing.assert_allclose(theta.sum(1), 1.0, rtol=1e-5)


def test_carve_eval_device_semantics():
    """Device eval carve: entries come from the pool, original values
    preserved, training copies recoded MISSING, eval_rows match the
    post-carve matrix."""
    from terastructure_tpu.data.dataset import (
        GenotypeData, carve_eval_device)
    from terastructure_tpu.data.pack import unpack2bit
    from terastructure_tpu.data.simulate import (
        simulate_packed_device_resident)
    from terastructure_tpu.models.psd import MISSING as M

    n, l = 256, 512
    pk_dev, _ = simulate_packed_device_resident(n, l, 3, seed=5,
                                                missing_frac=0.05)
    before = np.asarray(pk_dev)                # host copy pre-carve
    pk_dev, val, held, pool, rows = carve_eval_device(
        pk_dev, n, validation_frac=0.01, heldout_frac=0.01, seed=5,
        eval_snp_pool=64)
    assert len(pool) == 64 and (np.diff(pool) > 0).all()
    after = np.asarray(pk_dev)
    x_before = unpack2bit(before, n)           # (l, n)
    x_after = unpack2bit(after, n)
    seen = set()
    for es in (val, held):
        assert es is not None and len(es) > 0
        assert np.isin(es.snp_idx, pool).all()
        assert set(np.unique(es.x)) <= {0, 1, 2}
        np.testing.assert_array_equal(es.x, x_before[es.snp_idx,
                                                     es.ind_idx])
        assert (x_after[es.snp_idx, es.ind_idx] == M).all()
        pairs = set(zip(es.ind_idx.tolist(), es.snp_idx.tolist()))
        assert not (pairs & seen), "validation/heldout overlap"
        seen |= pairs
    # untouched entries identical
    mask = np.ones((l, n), bool)
    for es in (val, held):
        mask[es.snp_idx, es.ind_idx] = False
    np.testing.assert_array_equal(x_before[mask], x_after[mask])
    # eval rows are the post-carve pool rows
    np.testing.assert_array_equal(np.asarray(rows), after[pool])


def test_fit_device_resident():
    """End-to-end fit on a device-resident GenotypeData (packed and
    eval rows are jax.Arrays; no host densification anywhere)."""
    from terastructure_tpu.config import SVIConfig
    from terastructure_tpu.data.dataset import (
        GenotypeData, carve_eval_device)
    from terastructure_tpu.data.simulate import (
        simulate_packed_device_resident)
    from terastructure_tpu.svi import fit

    n, l, k = 512, 256, 3                      # width 128 -> kernel-aligned
    pk_dev, _ = simulate_packed_device_resident(n, l, k, seed=0)
    pk_dev, val, held, pool, rows = carve_eval_device(
        pk_dev, n, seed=0, eval_snp_pool=64)
    data = GenotypeData(n=n, l=l, packed=pk_dev, validation=val,
                        heldout=held, eval_row_snps=pool,
                        eval_rows_full=rows)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=32, rfreq=25, max_steps=50,
                    lambda_mode="local")
    res = fit(cfg, data, packed=pk_dev)
    assert np.isfinite(res.validation_ll)
    assert res.heldout_ll is None or np.isfinite(res.heldout_ll)
