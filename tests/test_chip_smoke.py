"""chip_smoke.py at tiny sizes on the CPU: its phases run and check, and its
entry point refuses to run without a GPU."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


@pytest.fixture
def lines():
    out = []
    yield out, lambda phase, msg: out.append((phase, msg))


def test_main_exits_nonzero_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    assert chip_smoke.main(["--gpus", "4"]) != 0
    assert capsys.readouterr().out == ""


def test_parity_phase_runs_and_checks_at_tiny_size(lines):
    out, log = lines
    chip_smoke.phase_parity(log, L_dense=4, L_fold=4, L_ssh=4, beta=1.0,
                            fold_threshold=0)
    text = "\n".join(m for _, m in out)
    assert all(p == "a" for p, _ in out)
    for name in ("dense mulMTM HIGHEST", "mulMTM high=BF16_BF16_F32_X3",
                 "XLA fold ckb_inverse_mul", "SSH 4x4", "KPM-CG iters",
                 "_fft_axis n=20 inverse DFT matmul",
                 "num_primitive_operations = 3"):
        assert name in text, name
    assert "FAIL" not in text


def test_parity_reference_matches_dense_fermion_matrix():
    """The slice-wise float64 reference equals the explicit dense M of
    tests/dense_reference.py."""
    import jax

    from dense_reference import dense_M, flatten_field
    from elphdynamics_tpu.dynamics.init_phonons import init_phonons_half_filled

    spec, params, ops = chip_smoke.holstein(2, beta=0.5)
    x = init_phonons_half_filled(ops, params, jax.random.PRNGKey(0))[0]
    K, d = chip_smoke.holstein_reference(spec, params, x)
    M = dense_M([K * d[None, :, t] for t in range(spec.Ltau)])
    v = np.random.default_rng(0).standard_normal((spec.Nsites, spec.Ltau))
    np.testing.assert_allclose(flatten_field(chip_smoke.ref_M(K, d, v)),
                               M @ flatten_field(v), atol=1e-12)
    np.testing.assert_allclose(flatten_field(chip_smoke.ref_MT(K, d, v)),
                               M.T @ flatten_field(v), atol=1e-12)


def test_fold_timing_phase_reports_each_strategy(lines):
    out, log = lines
    times = chip_smoke.phase_fold_timing(log, L=4, chains=2, beta=0.4,
                                         inner=2, reps=1)
    assert set(times) == {"XLA group fold", "dense matmul HIGHEST",
                          "dense matmul DEFAULT"}
    assert all(t > 0 for t in times.values())
    assert len(out) == 3 and all(p == "b" for p, _ in out)


@pytest.mark.gpu
def test_parity_phase_at_production_width_on_gpu(gpu, lines):
    out, log = lines
    chip_smoke.phase_parity(log)
    assert out and not any("FAIL" in m for _, m in out)


def test_run_simulation_checks_a_driver_run(lines, tmp_path):
    out, log = lines
    cfg = chip_smoke.example_config(
        "holstein_hmc_square.toml", 2, 0.4, tmp_path, burnin_updates=1,
        simulation_updates=2, meas_freq=1)
    cfg["measurements"]["num_random_vectors"] = 2
    stats = chip_smoke.run_simulation(log, "tiny", cfg, n_chains=2)
    assert stats["acceptance_rate"] > 0 and stats["run_seconds"] > 0
    assert "compile" in out[0][1] and "peak device bytes" in out[0][1]
    acc, H = chip_smoke._first_update(tmp_path / "holstein_hmc_square-1")
    assert acc.shape == H.shape == (2,)
    g = chip_smoke._globals(tmp_path / "holstein_hmc_square-1", 1)
    assert "density" in g and np.isfinite(g["density"])
