"""PyTorch port, deployment (go2_rl_gym_tpu_torch/deploy/{mujoco_eval,
viewer,real_runner}.py) and the evaluate, sim2sim and play CLIs, against
the JAX package's deploy modules on the CPU.

* `run_episode` on one exported TorchScript policy (flat, 1 s) gives
  exactly the JAX package's metrics; `ModelPolicy` (the port model's
  student path) matches `JaxPolicy` on a fixed obs sequence within 2e-5.
* The pure helpers equal the JAX package's on seeded inputs:
  `gravity_orientation`, `quat_rotate_inverse_wxyz`, `build_observation`,
  `action_to_motor_targets`, `gravity_from_quat_wxyz`,
  `RemoteController.set`, `arrow_pose`, `velocity_arrows`.
* The evaluate CLI writes its YAML; sim2sim runs 0.5 s on flat; play's
  checkpoint mode exports a checkpoint's policy (jit, onnx, pkl for CTS;
  pkl for PPO) and rolls it; it refuses recurrent PPO.
"""
import os
import struct

import numpy as np
import pytest
import torch
import yaml

from go2_rl_gym_tpu.deploy import mujoco_eval as jme
from go2_rl_gym_tpu.deploy import real_runner as jrr
from go2_rl_gym_tpu.deploy import viewer as jvw
from go2_rl_gym_tpu.env import config as jconfig
from go2_rl_gym_tpu.export import exporter as jexp
from go2_rl_gym_tpu_torch.deploy import mujoco_eval as tme
from go2_rl_gym_tpu_torch.deploy import real_runner as trr
from go2_rl_gym_tpu_torch.deploy import viewer as tvw
from go2_rl_gym_tpu_torch.export import exporter as texp
from go2_rl_gym_tpu_torch.export import importer as timp
from go2_rl_gym_tpu_torch.scripts import evaluate as evaluate_cli
from go2_rl_gym_tpu_torch.scripts import play as play_cli
from go2_rl_gym_tpu_torch.scripts import sim2sim as sim2sim_cli
from go2_rl_gym_tpu_torch.utils import registry
from test_torch_export import SMALL, assert_trees_equal, cts_pair, obs_seq

mujoco = pytest.importorskip("mujoco")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU problems gain nothing from torch's intra-op threads,
    and the test run's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def moe_export(tmp_path_factory):
    """(tree, port model, exported TorchScript path) of a small moe_cts."""
    tree, model = cts_pair("moe_cts")
    d = str(tmp_path_factory.mktemp("export"))
    return tree, model, texp.export_model(model, "jit", "moe_cts", d)


def test_run_episode_equals_jax(moe_export):
    _, _, path = moe_export
    got = tme.run_episode(tme.TorchPolicy(path), "flat", (0.5, 0.3, 0.0),
                          duration_s=1.0)
    want = jme.run_episode(jme.TorchPolicy(path), "flat", (0.5, 0.3, 0.0),
                           duration_s=1.0)
    assert got == want


def test_torch_policy_records_moe(moe_export):
    _, _, path = moe_export
    pol = tme.TorchPolicy(path, record_moe=True)
    seq = obs_seq()
    acts = [pol(o) for o in seq]
    assert np.asarray(acts).shape == (len(seq), 12)
    assert np.asarray(pol.moe_weights).shape == (len(seq), 8)
    np.testing.assert_allclose(np.asarray(pol.moe_weights).sum(-1), 1.0,
                               atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(pol.moe_latents, axis=-1), 1.0,
                               atol=1e-5)


def test_model_policy_matches_jax_policy(moe_export):
    tree, model, _ = moe_export
    jp = jme.JaxPolicy(tree, "moe_cts", jconfig.PolicyCfg(**SMALL))
    tp = tme.ModelPolicy(model, device="cpu")
    seq = obs_seq(4)
    got = np.stack([tp(o) for o in seq])
    want = np.stack([jp(o) for o in seq])
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    tp.reset()
    np.testing.assert_array_equal(tp(seq[0]), got[0])
    # a device named with its index is the model's device (on the card:
    # "cuda" for a model on "cuda:0")
    assert tme.ModelPolicy(model, device="cpu:0").device == torch.device(
        "cpu")
    with pytest.raises(ValueError, match="lives on cpu"):
        tme.ModelPolicy(model, device="meta")


def test_scene_helpers_equal_jax():
    assert os.path.realpath(tme.find_scene("flat")) == os.path.realpath(
        jme.find_scene("flat"))
    with pytest.raises(FileNotFoundError):
        tme.find_scene("no_such_scene")
    m, jm = tme.load_scene_model("flat"), jme.load_scene_model("flat")
    assert (m.nq, m.nv, m.nu, m.ngeom) == (jm.nq, jm.nv, jm.nu, jm.ngeom)
    assert tme.BASE_COMMANDS == jme.BASE_COMMANDS
    assert tme.EXTENDED_COMMANDS == jme.EXTENDED_COMMANDS
    np.testing.assert_array_equal(tme.DEFAULT_ANGLES, jme.DEFAULT_ANGLES)
    rng = np.random.default_rng(0)
    for _ in range(5):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        v = rng.standard_normal(3)
        np.testing.assert_array_equal(tme.gravity_orientation(q),
                                      jme.gravity_orientation(q))
        np.testing.assert_array_equal(tme.quat_rotate_inverse_wxyz(q, v),
                                      jme.quat_rotate_inverse_wxyz(q, v))


def test_real_runner_helpers_equal_jax():
    rng = np.random.default_rng(1)
    tcfg, jcfg = trr.RealDeployConfig(), jrr.RealDeployConfig()
    assert trr.JOINT2MOTOR == jrr.JOINT2MOTOR
    for _ in range(3):
        gyro, grav, cmd = (rng.standard_normal(3).astype(np.float32)
                           for _ in range(3))
        q, dq, act = (rng.standard_normal(12).astype(np.float32)
                      for _ in range(3))
        np.testing.assert_array_equal(
            trr.build_observation(tcfg, gyro, grav, cmd, q, dq, act),
            jrr.build_observation(jcfg, gyro, grav, cmd, q, dq, act))
        np.testing.assert_array_equal(
            trr.action_to_motor_targets(tcfg, act),
            jrr.action_to_motor_targets(jcfg, act))
        quat = rng.standard_normal(4).astype(np.float32)
        np.testing.assert_array_equal(trr.gravity_from_quat_wxyz(quat),
                                      jrr.gravity_from_quat_wxyz(quat))
        blob = (bytes(2) + struct.pack("H", int(rng.integers(0, 65536)))
                + struct.pack("4f", *rng.standard_normal(4))
                + struct.pack("f", rng.standard_normal())
                + bytes(16))
        t, j = trr.RemoteController(), jrr.RemoteController()
        t.set(blob)
        j.set(blob)
        assert (t.button, t.lx, t.ly, t.rx, t.ry) == (j.button, j.lx, j.ly,
                                                      j.rx, j.ry)
    assert trr.RemoteController.BTN == jrr.RemoteController.BTN


def test_viewer_helpers_equal_jax():
    rng = np.random.default_rng(2)
    for scale in (0.05, 1.0, 3.0):
        start, vec = rng.standard_normal(3), rng.standard_normal(3) * scale
        got, want = tvw.arrow_pose(start, vec), jvw.arrow_pose(start, vec)
        assert (got is None) == (want is None)
        if got is not None:
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    for v in ([0.0, 0.0, -1.0], [0.0, 0.0, 2.0]):
        for a, b in zip(tvw.arrow_pose(np.zeros(3), np.array(v)),
                        jvw.arrow_pose(np.zeros(3), np.array(v))):
            np.testing.assert_array_equal(a, b)
    for _ in range(3):
        qpos, qvel = rng.standard_normal(19), rng.standard_normal(18)
        qpos[3:7] /= np.linalg.norm(qpos[3:7])
        cmd = rng.standard_normal(2)
        got = tvw.velocity_arrows(qpos, qvel, cmd)
        want = jvw.velocity_arrows(qpos, qvel, cmd)
        assert len(got) == len(want)
        for ga, wa in zip(got, want):
            for a, b in zip(ga, wa):
                np.testing.assert_array_equal(a, b)


def test_viewer_draws_into_an_mjv_scene():
    # Teleop and MoEHud open pygame's display and are left to a machine
    # with one: a display opened in a test process made a later import of
    # TensorFlow (torch's SummaryWriter) crash in the same process
    m = tme.load_scene_model("flat")
    scene = mujoco.MjvScene(m, maxgeom=100)
    qpos = np.zeros(m.nq)
    qpos[3] = 1.0
    qvel = np.zeros(m.nv)
    qvel[1] = 1.0
    tvw.draw_arrows_into_scene(scene, qpos, qvel, (0.8, 0.2))
    assert scene.ngeom == 2
    assert scene.geoms[0].type == mujoco.mjtGeom.mjGEOM_ARROW


def test_evaluate_cli_writes_yaml(moe_export, tmp_path):
    _, _, path = moe_export
    out = str(tmp_path / "res" / "scores.yaml")
    scores = evaluate_cli.main(["--policy", path, "--duration", "0.5",
                                "--out", out])
    with open(out) as f:
        assert yaml.safe_load(f) == scores
    assert scores["episodes"] == 4
    for k in ("tracking", "safety", "quality", "overall", "flat/overall"):
        assert 0.0 <= scores[k] <= 1.0, k


def test_sim2sim_cli_runs_on_flat(moe_export, tmp_path):
    _, _, path = moe_export
    assert sim2sim_cli.DEFAULT_CONFIG.endswith(os.path.join(
        "go2_rl_gym_tpu_torch", "deploy", "configs", "go2.yaml"))
    with open(sim2sim_cli.DEFAULT_CONFIG) as f:
        cfg = yaml.safe_load(f)
    assert cfg["simulation_dt"] == 0.002 and cfg["control_decimation"] == 10
    moe = str(tmp_path / "moe.npz")
    res = sim2sim_cli.main(["--policy", path, "--scene", "flat",
                            "--duration", "0.5", "--record-moe", moe])
    assert res["survived_s"] == pytest.approx(0.5)
    assert np.load(moe)["weights"].shape == (25, 8)


def _checkpoint(task, log_root, num_envs=4):
    """A saved checkpoint of `task`'s runner (random weights) under
    <log_root>/<experiment>/run; returns the runner."""
    env_cfg, tc = registry.get_cfgs(task)
    env_cfg.terrain.mesh_type = "plane"
    env_cfg.terrain.measure_heights = False
    env = registry.make_env(task, env_cfg, num_envs=num_envs, device="cpu")
    runner = registry.make_runner(task, env, tc, device="cpu")
    rs = runner.init_runner_state(3)
    d = os.path.join(log_root, tc.runner.experiment_name, "run")
    os.makedirs(d)
    runner.save(rs, os.path.join(d, "model_0.pt"))
    return runner


def test_play_checkpoint_overrides_are_the_jax_plays():
    """scripts/play.py:43-50 of the JAX package, on the task's configs."""
    env_cfg, tc = play_cli.play_checkpoint_cfgs("go2_moe_cts")
    base, _ = registry.get_cfgs("go2_moe_cts")
    assert env_cfg.env.num_envs == min(base.env.num_envs, 16) == 16
    assert (env_cfg.terrain.num_rows, env_cfg.terrain.num_cols) == (5, 5)
    assert not (env_cfg.terrain.curriculum or env_cfg.noise.add_noise
                or env_cfg.domain_rand.randomize_friction
                or env_cfg.domain_rand.push_robots
                or env_cfg.domain_rand.randomize_action_delay)
    assert env_cfg.terrain.mesh_type == base.terrain.mesh_type
    assert play_cli.play_checkpoint_cfgs("go2", 8)[0].env.num_envs == 8


def test_play_checkpoint_mode_exports_and_rolls(tmp_path):
    runner = _checkpoint("go2_moe_cts", str(tmp_path))
    res = play_cli.main(["--task", "go2_moe_cts", "--log_root",
                         str(tmp_path), "--steps", "3", "--device", "cpu"])
    assert res["checkpoint"].endswith(os.path.join("run", "model_0.pt"))
    out = os.path.join(os.path.dirname(res["checkpoint"]), "exported",
                       "policies")
    assert res["exported"] == {
        "jit": os.path.join(out, "policy_jit.pt"),
        "onnx": os.path.join(out, "policy.onnx"),
        "pkl": os.path.join(out, "policy.pkl")}
    assert res["finite"] and len(res["mean_reward"]) == 3
    tree = timp.tree_from_named(runner.alg.model.named_parameters())
    params, meta = jexp.load_policy_params(res["exported"]["pkl"])
    assert meta == {"task": "go2_moe_cts", "algorithm": "MoECTS"}
    assert_trees_equal(params, tree)
    # the same TorchScript the JAX exporter writes from those weights
    want = torch.jit.load(jexp.export_policy_as_jit(tree, "moe_cts",
                                                    str(tmp_path / "j")))
    got = torch.jit.load(res["exported"]["jit"])
    with torch.no_grad():
        for o in obs_seq(5, 3):
            a, b = got(torch.as_tensor(o)[None]), want(torch.as_tensor(o)[None])
            assert torch.equal(a[0], b[0])


def test_play_checkpoint_mode_ppo_and_recurrent(tmp_path):
    _checkpoint("go2", str(tmp_path))
    res = play_cli.play_checkpoint("go2", log_root=str(tmp_path), steps=2,
                                   device="cpu")
    assert sorted(res["exported"]) == ["pkl"] and res["finite"]
    with pytest.raises(ValueError, match="RecurrentPPO"):
        play_cli.play_checkpoint("go2_lstm", log_root=str(tmp_path),
                                 device="cpu")
