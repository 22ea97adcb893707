"""PyTorch port: the engine-vs-MuJoCo parity tool
(go2_rl_gym_tpu_torch/tools/dynamics_parity.py) on the CPU.

* The JAX test's thresholds (tests/test_dynamics_parity.py:24-36) for the
  stand and walk scenarios at 100 steps.
* The port's `run_parity` against the JAX tool's on the same scenario: the
  MuJoCo figures identical (the same numpy code on the same model), the
  engine's within 1e-3 (final height, errors at 0.5 s, ground forces
  relative to the 147 N weight).
* `--report` writes under build/ and refuses any other path.
"""
import os
import sys

import pytest

pytest.importorskip("mujoco")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from go2_rl_gym_tpu_torch.tools import dynamics_parity as tdp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
STEPS = 100
ENGINE_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU problems gain nothing from torch's intra-op threads,
    and the test run's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene_available():
    from go2_rl_gym_tpu_torch.deploy import mujoco_eval
    try:
        mujoco_eval.find_scene("flat")
    except FileNotFoundError:
        pytest.skip("go2 MJCF scenes not available")


@pytest.fixture(scope="module")
def results(scene_available):
    from tools.dynamics_parity import run_parity as jax_run_parity
    return {sc: (tdp.run_parity(STEPS, sc, device="cpu"),
                 jax_run_parity(STEPS, sc))
            for sc in ("stand", "walk")}


def test_standing_parity(results):
    r = results["stand"][0]
    assert r["err_at_0.5s"]["pos"] < 0.03, r
    assert r["err_at_0.5s"]["ang"] < 0.1, r
    assert r["err_at_0.5s"]["joint"] < 0.15, r
    assert abs(r["final_z_mujoco"] - r["final_z_ours"]) < 0.03, r


def test_walking_excitation_parity(results):
    r = results["walk"][0]
    assert r["err_at_0.5s"]["pos"] < 0.05, r
    assert r["err_at_0.5s"]["joint"] < 0.25, r


@pytest.mark.parametrize("scenario", ["stand", "walk"])
def test_matches_the_jax_tool(results, scenario):
    ours, jax_ = results[scenario]
    assert sorted(ours) == sorted(jax_)
    assert ours["final_z_mujoco"] == jax_["final_z_mujoco"]
    for k in ("peak_fz_mujoco", "settled_mean_fz_mujoco"):
        assert ours["grf"][k] == jax_["grf"][k], k
    assert abs(ours["final_z_ours"] - jax_["final_z_ours"]) < ENGINE_TOL
    for k in ("pos", "ang", "joint"):
        assert abs(ours["err_at_0.5s"][k] - jax_["err_at_0.5s"][k]) \
            < ENGINE_TOL, k
    # ground forces in units of the robot's weight
    for k in ("peak_fz_ours", "settled_mean_fz_ours", "settled_mean_abs_diff"):
        assert abs(ours["grf"][k] - jax_["grf"][k]) / 147.3 < ENGINE_TOL, k
    np.testing.assert_allclose(ours["max_pos_err"], jax_["max_pos_err"],
                               atol=ENGINE_TOL)


def test_report_stays_under_build(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(tdp, "run_parity",
                        lambda steps, sc, device: calls.append(sc) or {})
    evidence = os.path.join(ROOT, "doc", "evidence", "parity.json")
    for bad in (evidence, str(tmp_path / "parity.json")):
        with pytest.raises(ValueError, match="build"):
            tdp.write_report(bad, device="cpu")
    assert calls == []
    monkeypatch.setattr(tdp, "BUILD", str(tmp_path))
    out = tdp.write_report(str(tmp_path / "r.json"), steps=10, device="cpu")
    assert calls == list(tdp.SCENARIOS)
    assert out["horizon_s"] == 10 * 0.005
    assert os.path.exists(tmp_path / "r.json")
