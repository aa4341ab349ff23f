"""End-to-end CLI + IO tests: bed round-trip, fit run-dir, compute-beta,
checkpoint resume."""

import json
import os

import numpy as np
import pytest

from terastructure_tpu.cli import main as cli_main
from terastructure_tpu.data.bed import (
    read_bed, read_text_genotypes, write_bed, write_bim, write_fam,
)
from terastructure_tpu.data.pack import pack2bit, unpack2bit
from terastructure_tpu.data.simulate import simulate_psd
from terastructure_tpu.io.export import load_matrix
from terastructure_tpu.models.psd import MISSING


def test_bed_roundtrip(tmp_path, rng):
    n, l = 13, 29                                   # ragged on purpose
    x = rng.integers(0, 4, size=(l, n)).astype(np.int8)
    packed = pack2bit(x)
    stem = str(tmp_path / "toy")
    write_bed(stem + ".bed", packed, n)
    write_fam(stem + ".fam", [f"i{i}" for i in range(n)])
    write_bim(stem + ".bim", [f"s{j}" for j in range(l)])
    got, ind_ids, snp_ids = read_bed(stem + ".bed")
    assert len(ind_ids) == n and len(snp_ids) == l
    np.testing.assert_array_equal(unpack2bit(got, n), x)


def test_bed_rejects_garbage(tmp_path):
    p = tmp_path / "bad.bed"
    p.write_bytes(b"\x00\x00\x01" + b"\x00" * 10)
    with pytest.raises(ValueError, match="bad magic"):
        read_bed(str(p), n=4, l=10)


def test_bed_padding_is_missing(tmp_path, rng):
    n, l = 5, 3                                     # n%4 != 0
    x = rng.integers(0, 3, size=(l, n)).astype(np.int8)
    stem = str(tmp_path / "pad")
    write_bed(stem + ".bed", pack2bit(x), n)
    got, _, _ = read_bed(stem + ".bed", n=n, l=l)
    full = unpack2bit(got, 8)
    assert (full[:, n:] == MISSING).all()


def test_text_reader(tmp_path):
    p = tmp_path / "g.txt"
    p.write_text("0 1 2\n2 9 0\n")                  # 2 SNPs x 3 ind, 9=missing
    x = read_text_genotypes(str(p))                 # -> (N=3, L=2)
    assert x.shape == (3, 2)
    assert x[1, 1] == MISSING


def test_cli_simulate_fit_computebeta_roundtrip(tmp_path):
    os.chdir(tmp_path)
    stem = str(tmp_path / "sim" / "toy")
    cli_main(["simulate", "-n", "48", "-l", "120", "-k", "2",
              "--seed", "3", "-o", stem])
    assert os.path.exists(stem + ".bed")

    cli_main([
        "fit", "--bed", stem + ".bed", "-k", "2",
        "--batch-size", "32", "--rfreq", "50", "--max-steps", "400",
        "--label", "t", "--out-base", str(tmp_path), "--seed", "3",
        "--force-cpu",
    ])
    run_dir = tmp_path / "n48-k2-l120-t"
    assert run_dir.is_dir()
    for f in ("theta.txt", "gamma.txt", "beta.txt", "lambda.txt",
              "metrics.jsonl", "infer.log", "config.json", "result.json"):
        assert (run_dir / f).exists(), f
    theta = load_matrix(run_dir / "theta.txt")
    assert theta.shape == (48, 2)
    np.testing.assert_allclose(theta.sum(1), 1.0, rtol=1e-4)
    res = json.loads((run_dir / "result.json").read_text())
    assert np.isfinite(res["validation_ll"])

    # compute-beta over the checkpoint reproduces a (L, K) simplex-free matrix
    cli_main(["compute-beta", "--run-dir", str(run_dir),
              "--bed", stem + ".bed", "--force-cpu"])
    beta = load_matrix(run_dir / "beta.txt")
    assert beta.shape == (120, 2)
    assert ((beta > 0) & (beta < 1)).all()


def test_cli_replicates(tmp_path):
    stem = str(tmp_path / "toy2")
    cli_main(["simulate", "-n", "24", "-l", "60", "-k", "2",
              "--seed", "5", "-o", stem])
    cli_main([
        "fit", "--bed", stem + ".bed", "-k", "2", "--replicates", "2",
        "--batch-size", "16", "--rfreq", "50", "--max-steps", "150",
        "--label", "reps", "--out-base", str(tmp_path), "--seed", "7",
        "--force-cpu",
    ])
    run_dir = tmp_path / "n24-k2-l60-reps"
    best = json.loads((run_dir / "best.json").read_text())
    assert best["dir"] in ("replicate-s7", "replicate-s8")
    for s in (7, 8):
        assert (run_dir / f"replicate-s{s}" / "theta.txt").exists()


def test_checkpoint_roundtrip(tmp_path):
    from terastructure_tpu.config import SVIConfig
    from terastructure_tpu.data import GenotypeData
    from terastructure_tpu.io.checkpoint import restore_checkpoint, save_checkpoint
    from terastructure_tpu.svi import engine

    _, _, x = simulate_psd(16, 32, 2, seed=9)
    data = GenotypeData.from_dense(x, validation_frac=0, heldout_frac=0, seed=9)
    cfg = SVIConfig(n=16, l=32, k=2, batch_size=8, seed=9)
    import jax.numpy as jnp

    state = engine.init_state(cfg)
    step = engine.make_step(cfg)
    state = step(state, jnp.asarray(data.packed))

    save_checkpoint(str(tmp_path / "ck"), state, cfg)
    state2, cfg2 = restore_checkpoint(str(tmp_path / "ck"))
    assert cfg2 == cfg
    assert int(state2.t) == int(state.t) == 1
    np.testing.assert_array_equal(np.asarray(state2.gamma), np.asarray(state.gamma))

    # resuming continues identically to an uninterrupted run
    s_resumed = step(state2, jnp.asarray(data.packed))
    s_straight = step(state, jnp.asarray(data.packed))
    np.testing.assert_allclose(
        np.asarray(s_resumed.gamma), np.asarray(s_straight.gamma), rtol=1e-6)


def test_cli_resume_continues(tmp_path):
    stem = str(tmp_path / "toy3")
    cli_main(["simulate", "-n", "32", "-l", "96", "-k", "2",
              "--seed", "6", "-o", stem])
    common = ["fit", "--bed", stem + ".bed", "-k", "2",
              "--batch-size", "16", "--rfreq", "40",
              "--label", "rz", "--out-base", str(tmp_path), "--seed", "6",
              "--force-cpu"]
    cli_main(common + ["--max-steps", "80"])
    run_dir = tmp_path / "n32-k2-l96-rz"
    import json as _json
    r1 = _json.loads((run_dir / "result.json").read_text())
    assert r1["steps"] == 80
    # resume continues from the checkpoint to the new cap
    cli_main(common + ["--max-steps", "160", "--resume"])
    r2 = _json.loads((run_dir / "result.json").read_text())
    assert r2["steps"] == 160
    # validation trace file exists with both phases
    lines = (run_dir / "validation.txt").read_text().strip().splitlines()
    steps = [int(s.split("\t")[0]) for s in lines]
    assert 80 in steps and 160 in steps


def test_legacy_flag_translation(tmp_path):
    """Reference-binary command lines keep working."""
    stem = str(tmp_path / "lg")
    cli_main(["simulate", "-n", "24", "-l", "64", "-k", "2",
              "--seed", "8", "-o", stem])
    os.chdir(tmp_path)
    cli_main(["-file", stem + ".bed", "-k", "2", "-label", "legacy",
              "-rfreq", "40", "-seed", "8"])
    # uses defaults for max_steps -> cap it by checking the dir exists
    assert (tmp_path / "n24-k2-l64-legacy").is_dir()


def test_bed_byte_cols_slice(tmp_path, rng):
    """Multi-host ingest: column-sliced read matches the full read."""
    n, l = 32, 50
    x = rng.integers(0, 4, size=(l, n)).astype(np.int8)
    stem = str(tmp_path / "cols")
    write_bed(stem + ".bed", pack2bit(x), n)
    full, _, _ = read_bed(stem + ".bed", n=n, l=l)
    part, _, _ = read_bed(stem + ".bed", n=n, l=l, byte_cols=(2, 6))
    np.testing.assert_array_equal(part, full[:, 2:6])


def test_idfile_overrides_output_labels(tmp_path):
    """Reference -idfile parity (SNP::read_idfile): IDs from the file
    label every exported row instead of the .fam IDs, via both the
    subcommand flag and the legacy-flag translation."""
    from terastructure_tpu import cli

    base = tmp_path / "toy"
    cli.main(["simulate", "-n", "12", "-l", "40", "-k", "2",
              "-o", str(base)])
    ids = tmp_path / "ids.txt"
    ids.write_text("".join(f"SAMPLE{i}\n" for i in range(12)))
    cli.main(["fit", "--bed", str(base) + ".bed", "-k", "2",
              "--idfile", str(ids), "--force-cpu", "--max-steps", "100",
              "--rfreq", "50", "--out-base", str(tmp_path)])
    theta = (tmp_path / "n12-k2-l40-run" / "theta.txt").read_text()
    assert "SAMPLE0" in theta and "SAMPLE11" in theta

    out = cli._translate_legacy(
        ["-file", "g.bed", "-k", "3", "-idfile", "x.ids"])
    assert out is not None and "--idfile" in out


def test_cli_fast_preset_maps_to_config():
    """--kernel maps to the config; defaults are accel7; an explicit
    --local-iters runs the plain schedule unless paired with --accel
    (no silent accel16); --no-accel alone means plain16."""
    import terastructure_tpu.cli as c

    ns = _parse_cli(["fit", "--simulate", "-n", "64", "-l", "128",
                     "-k", "2", "--kernel", "triton"])
    cfg = c._cfg_from_args(ns, 64, 128)
    assert cfg.local_iters == 7 and cfg.kernel == "triton"
    assert cfg.local_accel

    ns2 = _parse_cli(["fit", "--simulate", "-n", "64", "-l", "128",
                      "-k", "2"])
    cfg2 = c._cfg_from_args(ns2, 64, 128)
    assert cfg2.local_iters == 7 and cfg2.local_accel
    assert cfg2.kernel == "auto"

    # explicit iters WITHOUT --accel: plain schedule (pre-round-4
    # invocations like --local-iters 16 keep their meaning)
    ns3 = _parse_cli(["fit", "--simulate", "-n", "64", "-l", "128",
                      "-k", "2", "--local-iters", "12"])
    cfg3 = c._cfg_from_args(ns3, 64, 128)
    assert cfg3.local_iters == 12
    assert not cfg3.local_accel

    ns3b = _parse_cli(["fit", "--simulate", "-n", "64", "-l", "128",
                       "-k", "2", "--local-iters", "12", "--accel"])
    cfg3b = c._cfg_from_args(ns3b, 64, 128)
    assert cfg3b.local_iters == 12 and cfg3b.local_accel

    ns4 = _parse_cli(["fit", "--simulate", "-n", "64", "-l", "128",
                      "-k", "2", "--no-accel", "--local-iters", "16"])
    cfg4 = c._cfg_from_args(ns4, 64, 128)
    assert cfg4.local_iters == 16 and not cfg4.local_accel

    # --no-accel alone: the reference plain schedule at 16 passes
    ns4b = _parse_cli(["fit", "--simulate", "-n", "64", "-l", "128",
                       "-k", "2", "--no-accel"])
    cfg4b = c._cfg_from_args(ns4b, 64, 128)
    assert cfg4b.local_iters == 16 and not cfg4b.local_accel

    # accel needs three iterates — degenerate iteration counts fall back
    ns5 = _parse_cli(["fit", "--simulate", "-n", "64", "-l", "128",
                      "-k", "2", "--local-iters", "2", "--accel"])
    cfg5 = c._cfg_from_args(ns5, 64, 128)
    assert not cfg5.local_accel


def _parse_cli(argv):
    """Parse argv with the real CLI parser without executing the command."""
    import unittest.mock as mock

    import terastructure_tpu.cli as c

    captured = {}
    with mock.patch.object(c, "cmd_fit", lambda args: captured.update(a=args)):
        c.main(argv)
    return captured["a"]


def test_gamma_psum_dtype_flag_wiring():
    """--gamma-psum-dtype reaches SVIConfig (and defaults to exact f32)."""
    import argparse

    from terastructure_tpu import cli

    p = argparse.ArgumentParser()
    cli._add_model_args(p)
    cli._add_svi_args(p)
    args = p.parse_args(["-k", "3"])
    cfg = cli._cfg_from_args(args, n=64, l=128)
    assert cfg.gamma_psum_dtype == "f32"
    args = p.parse_args(["-k", "3", "--gamma-psum-dtype", "bf16"])
    cfg = cli._cfg_from_args(args, n=64, l=128)
    assert cfg.gamma_psum_dtype == "bf16"
