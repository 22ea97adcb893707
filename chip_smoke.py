"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Print the card's name and power limit (nvidia-smi).
2. Build every hand-written CUDA kernel from the sources in this checkout
   (each module in `kernel_modules` names its source).
3. Hold each kernel against its plain PyTorch version on the main path's
   inputs (bit-exact for the terrain-patch copy), and time the kernel, the
   plain version and one PyTorch library call computing the same function:
   with CUDA events around 50 launches, and with the same 50 launches
   captured in one CUDA graph (no host cost per launch in the reading; the
   kernels line reports the event readings as `ms`, `plain_ms` and
   `library_ms`, the graph readings as `graph_ms`, `plain_graph_ms` and
   `library_graph_ms`).
4. Check the card against the port's CPU path
   (go2_rl_gym_tpu_torch.tools.card_check): a small rough-terrain env
   stepped from the same state on both devices must agree, and so must one
   full-width update (5 x 4 minibatches) from the same weights, Adam states
   and permutations: go2_moe_cts's CTS.update, go2's PPO.update and
   go2_lstm's RecurrentPPO.update with its LSTM and with a GRU.
5. Main path, play: the committed 75k policy's deterministic student rolls
   24 steps on the full flagship terrain at 4096 envs
   (go2_rl_gym_tpu_torch.scripts.play.play), env.step as one CUDA graph
   (utils/graphs.py EnvStep): 3 patch launches (the init step, the eager
   warm-up, the capture; replays launch nothing from the host) and 1
   capture. Then VecEnvAdapter on the same terrain and env count: 3 steps
   through its captured env.step, against eager env.steps from the same
   state and actions: the obs must be equal (a replay runs the eager
   step's kernels on the same inputs and the same random stream).
6. Main path, rollout: OnPolicyRunner.rollout (24 steps, seeded init) at
   4096 envs, once untimed and once timed.
7. Main path, train: the go2_moe_cts task built through the registry at
   4096 envs (init at random episode lengths), one untimed train iteration
   (OnPolicyRunner.train_step: 24-step rollout, GAE, PPO + distillation
   update), then one timed, with rollout / GAE / update ms (each ending in
   a synchronize) and train-iteration env-steps/s. Losses must be finite,
   every parameter group must have moved, the learning rate must lie in
   [1e-5, 1e-2].
8. The same for the go2 task (PPO) and the go2_lstm task (recurrent PPO,
   LSTM of 256; its carried memory must be non-zero after the iterations),
   both on the flagship rough terrain, and one iteration of the
   go2_fast_flat_move task on the plane, at 4096 envs and full width.
9. Main path, train ddp (go2_rl_gym_tpu_torch.distributed): (a) the
   go2_moe_cts task at 4096 global envs on the flagship terrain, trained
   2 iterations by torch.cuda.device_count() NCCL ranks under
   torch.distributed.run (the check worker builds it through the registry
   on a mesh), with each rank's and the total env-steps/s and each rank's
   patch launches (24 per iteration); the ranks' parameters must be equal,
   the losses finite, and a checkpoint saved by the ranks must load back
   equal on every rank; the GAE, update and metrics of one more iteration
   under torch.profiler (its window opened at the rollout's end after a
   lead-in; 0 launches whose kernel the trace lacks, on every rank) give
   the collectives' calls, host time and NCCL kernel time. (b) Two
   gloo ranks on the one card, 2048 envs each, take one train iteration
   from a seeded state with randomness off, warm Adam moments and
   injected noise and permutations; one process on the same card takes
   the same iteration: parameters within 1e-5 of it
   and bitwise equal across the ranks. The iteration is cut to 6 policy
   steps: from step 9 on, robots spawned on the rough terrain start to fall
   and reset, and a reset draws from each rank's own generator.
10. Main path, export + eval (export/, train/eval_hook.py, deploy/): the
   go2_moe_cts task through the registry at 4096 envs, `runner.learn(rs,
   2)` with a log_dir under build/ and eval_interval 1, graphed: train_step
   runs twice (the eager warm-up and the capture, 24 patch launches each),
   1 capture, iteration 1 a replay; jit_models/policy_jit_{0,1,2}.pt (the
   JAX cadence) and
   one evaluator process per export (CUDA_VISIBLE_DEVICES="", its stderr
   kept under build/ for this phase). Then, from the trained weights: the
   TorchScript export on the CPU and, loaded onto the card, on the card,
   fed the first 7 envs' last obs as a sequence, against the card model's
   student `mu` (deploy.mujoco_eval.ModelPolicy) within 2e-5 + 1e-4 rel
   (TF32 off), with reset() giving the first action back; the ONNX export
   through the port's OnnxPolicy against build_torch_policy_stacked within
   1e-5; build/native/libgo2_infer.so built with g++ (no skip), the .g2p
   and the ONNX files through NativePolicy against the TorchScript within
   1e-5 + 1e-4 rel; the pkl loading back equal to the parameters. Where
   `import mujoco` works, every evaluator must have written its
   results_<it>.yaml with tracking, safety, quality and overall in [0, 1];
   where it does not, the phase says so (the scoring is held on the CPU by
   tests/test_torch_eval_hook.py) and prints each evaluator's exit code and
   last stderr line. Prints the export ms of each kind, learn's env-steps/s
   of the two iterations and the evaluators' wall times.
11. Main path, train script: the commands a user types, each a process
   of its own with a timeout, under build/train_script/. (a) `python -m
   go2_rl_gym_tpu_torch.scripts.train --task go2_moe_cts --num_envs 4096
   --max_iterations 14 --profile_dir ... --log_root ...` with no
   launcher: on one card it trains in its process, on W cards it starts
   W ranks itself (the `data-parallel over W ranks` line); it must print
   `learn: graph (...)`, write model_14.pt, and trace iterations 10-12
   (its window opened after a lead-in) into one trace per rank with
   kernel launches above 0 and 0 launches whose kernel the trace lacks.
   (b) The same with `--resume --max_iterations 1`: it must print
   `resuming from .../model_14.pt` and write model_15.pt with finite
   parameters. Each rank of (a) and (b) prints its patch launches, which
   must be 49 (the init step, learn's warm-up and its capture; none from
   learn's replays). (c) `python -m go2_rl_gym_tpu_torch.scripts.play
   --log_root ...` with no --task: the latest checkpoint (model_15.pt)
   exported as policy_jit.pt, policy.onnx and policy.pkl, 250 finite
   steps through the captured env.step, 3 patch launches (the init step,
   the warm-up, the capture) counted in its process and printed. Prints
   the seconds of each command and learn's logged env-steps/s by
   iteration.
   Train graph (utils/graphs.py, OnPolicyRunner.compiled_step), after 8:
   for go2_moe_cts, go2, go2_lstm and go2_fast_flat_move at 4096 envs, from
   one state at random episode lengths, with deterministic algorithms on
   (warn_only: each op that has no deterministic version is named), K = 3
   eager train_steps and K = 3 graphed (the eager warm-up under the sync
   debug mode "error", the capture, 2 replays). The graphed run's
   parameters, Adam states, learning rates, RunnerState and stacked
   metrics must equal the eager run's bit for bit (0.0, printed), and so
   must every generator's state; 1 capture per runner; 24 patch launches
   in the warm-up and 24 captured on rough terrain, 0 on the plane, none
   from the replays. A save after the replays, loaded into an eager
   runner, gives the next iteration equal to the graphed one's. Then, on
   a runner of its own with deterministic algorithms off, as learn runs
   it: the warm-up and the capture (1 capture, capture + instantiate s,
   the graph pool's bytes), then graphed iterations, none of whose replays
   may launch the patch kernel from the host: for go2_moe_cts
   (GRAPH_TIMED_TASKS) 2 eager and graphed iterations alternating, for
   the other tasks one replay; host ms and env-steps/s per iteration, the
   device ms of each replay (CUDA events) and the host ms of the replay
   call.
   Bench (go2_rl_gym_tpu_torch/bench.py, the twin of bench.py), after
   train graph: `bench.run` at 4096 envs, 2 iterations per dispatch, 1
   timed dispatch; its JSON line printed; every key, value = iters x 24 x
   N / median_dispatch_s; the guard held (1 capture, no patch launch from
   the host in any replay: 49 launches in the run, 1 in the init step's
   env.step and 24 each in the warm-up and the capture); deterministic
   algorithms off.
   Train ddp graph (the compiled step under a mesh, after 9:
   mesh.make_sharded_train_step, OnPolicyRunner.compiled_step under
   NCCL): torch.cuda.device_count() NCCL ranks under torch.distributed.run
   run the check worker's "graph" job. (a) go2_moe_cts at 4096 global envs
   on the flagship terrain from random episode lengths: K = 3 eager
   train_steps and K = 3 of the compiled step (warm-up, capture, 2
   replays), deterministic algorithms on, must be equal bit for bit (0.0)
   on every rank in parameters, both Adam states, learning rates, the
   RunnerState with its generators and the stacked metrics; the mode must
   be "graph", 1 capture per rank, 24 patch launches at warm-up, 24 at
   capture, 0 in the replays, and every rank's parameters must equal rank
   0's. Then 2 eager (deterministic algorithms off) / graphed (the graph
   as captured, with them on) pairs alternating: per-rank and total
   env-steps/s (host clock ending in a synchronize) and the device ms of each replay (CUDA
   events); capture s and pool bytes; the update's all_gather alone (its
   bytes, device ms by CUDA events); the NCCL kernels and memcpy nodes of
   one replay under torch.profiler (its window opened after one more
   replay as its lead-in: 0 launches whose kernel the trace lacks, on
   every rank); then learn(rs, 3) on the same runner
   under the mesh (with saves under build/) must print "learn: graph (...)"
   and log finite metrics on rank 0. (b) go2_lstm at 1024 global envs, 2
   iterations each way: the same checks (the recurrent shares). (c) The
   reference for the mesh's cost: go2_moe_cts at 4096 envs in one
   process's runner (no mesh) on each rank's card, 1 iteration each way
   (the same checks), then one eager / graphed pair and one profiled
   replay (0 lost launches), printed beside (a)'s.
   For 5 to 11 every launch count is set to 0 just before each run and
   read just after (in the ranks' processes for 9, in play's for 11); each
   eager
   rough-terrain policy step launches the patch kernel once (24 per eager
   train iteration), a capture records it once, a replay launches nothing
   from the host, and the plane none; obs and rewards must be finite.
   Every spawned process has a timeout and is killed with its process
   group on failure.
12. Engine (sim/engine.py, the N-major reference engine; no hand-written
   kernel on its path: it reads the global heightfield, not the patches):
   the flagship terrain's TerrainData (the global 1345 x 2195 heightfield)
   at 4096 envs, with the env's spawn states (init_state, DR on) and the
   states 20 zero-action env steps later (landed, in contact). (a) 4 card
   substeps of make_batched_substep from the landed states against the
   port's CPU engine on the first 16 envs, at the single-substep
   tolerances of tests/test_torch_physics.py. (b) One decimated step of
   the card's tengine.make_physics_step (solver_iters=30, the direct
   heightfield path) against 4 card substeps of the N-major engine: from
   the spawn states every env within the cross-parity tolerances of
   tests/test_tengine.py:68-82; from the landed states the share of envs
   beyond them is printed (the JAX package's two engines differ there as
   much: tests/test_torch_engine.py), and the card's difference between
   the engines is held against the CPU's on the first 16 envs at the
   single-substep tolerances. Prints ms per substep (host clock with a
   synchronize), kernel launches and device-busy ms per substep
   (torch.profiler), and the same for tengine's production physics step.
13. Profile (go2_rl_gym_tpu_torch/tools/profile_rollout.py, the twins of
   tools/profile_physics.py and tools/bench_decompose.py), at 4096 envs on
   the flagship terrain. First one profiled replay of the go2_moe_cts train
   graph, captured with deterministic algorithms on, in this process
   (tools/trace_window.py's `capture` and `profile_replay`, its window
   opened after one more replay; its kernels are printed beside the
   launches whose kernel its trace lacks, which must be 0): after
   such replays a profiler window opened at once lost the kernels
   launched in its first milliseconds, the patch kernel among them (the
   graph is kept until the tables are made). Then the op tables of the
   modes physics (tengine's physics step), substep (one N-major
   substep) and env (env.step), 3 traced calls each, top 10 rows printed
   (a table whose trace lacks the kernel of a launch raises); then the
   stage decomposition
   physics / env / rollout / train (10 timed calls each for physics and
   env, 2 for rollout and train). Each table's total self device time must
   lie within 1% of the profiler's kernel sum in the same trace; in physics
   and env at least 90% of it must carry a source line of the port, and
   the extract_patches row must show 1 launch per call; substep must
   launch the patch kernel 0 times; every stage time must be finite and
   positive. The phase's patch launches are counted (reset before the
   phase, read after it).
14. Graft (go2_rl_gym_tpu_torch/graft_entry.py): entry()'s forward (the
   go2_moe_cts student at batch 256) on the card against the CPU on the
   same weights and seeded inputs within 1e-5; dryrun_multichip over
   torch.cuda.device_count() NCCL ranks (world 1 on one card), through the
   compiled step, which must be a CUDA graph on every rank: finite
   metrics, 8 patch launches per rank (one per policy step in the warm-up
   and in the capture, none in the replay).
15. Print one JSON line listing every kernel, then the device line.

"""
from __future__ import annotations

import gc
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
NUM_ENVS = 4096
STEPS = 24
H100_BYTES_PER_S = 3.35e12      # published HBM3 rate, H100 SXM
DDP_DIR = os.path.join(ROOT, "build", "ddp")
DDP_PARITY_STEPS = 6
RANK_TIMEOUT_S = 400            # for any spawned process
EXPORT_DIR = os.path.join(ROOT, "build", "export_eval")
EVAL_TIMEOUT_S = 240            # for the evaluator processes of the hook
EXPORT_SEQ = 7                  # obs fed through the exported policies
TRAIN_SCRIPT_DIR = os.path.join(ROOT, "build", "train_script")
TRAIN_SCRIPT_ITERS = 14         # iterations of phase train script's (a)
ENGINE_SETTLE_STEPS = 20        # zero-action env steps from spawn to landed
ENGINE_CPU_ENVS = 16            # envs the card engine is held against the CPU
# single-substep tolerances (tests/test_torch_physics.py)
SUBSTEP_TOL = dict(base_pos=1e-5, base_quat=1e-5, q=1e-5, base_lin_vel=1e-4,
                   base_ang_vel=1e-4, qd=1e-4)
# tengine vs the N-major engine (tests/test_tengine.py:68-82)
CROSS_TOL = dict(base_pos=2e-4, q=2e-3, qd=0.1, base_quat=2e-4)
PROFILE_ITERS = 3               # traced calls per op table
PROFILE_TOP = 10                # rows printed per op table
DECOMPOSE_ITERS = {"rollout": 2, "train": 2}    # physics and env: 10


def fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, iters=50, warmup=5):
    """Mean device time of one call of fn, by CUDA events around `iters`
    back-to-back calls after `warmup` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches=50, replays=5):
    """Device time of one call of fn with no host in the reading: `launches`
    calls captured in one CUDA graph, the graph replayed `replays` times
    (CUDA events around each replay); the median replay over `launches`."""
    import torch
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()                      # the first replay uploads the graph
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph
    return sorted(times)[len(times) // 2]


def phase_patch_kernel(results):
    """Kernel vs plain version at the flagship shapes, plus timings."""
    import torch
    from go2_rl_gym_tpu_torch.env.config import Go2Cfg
    from go2_rl_gym_tpu_torch.ops import terrain_patches as tp
    from go2_rl_gym_tpu_torch.terrain import generator

    cfg = Go2Cfg().terrain
    grid = generator.build_terrain(cfg, seed=0)
    channels = torch.as_tensor(
        tp.build_channels(grid.heights_m, grid.horizontal_scale),
        device="cuda")
    C, R = channels.shape[1:]
    print(f"flagship channels {tuple(channels.shape)} "
          f"{channels.numel() * 4 / 1e6:.1f} MB")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    ox = torch.randint(0, R - tp.PATCH + 1, (NUM_ENVS,), generator=g,
                       device="cuda", dtype=torch.int32)
    oy = torch.randint(0, C - tp.PATCH + 1, (NUM_ENVS,), generator=g,
                       device="cuda", dtype=torch.int32)
    origins = torch.stack([ox, oy], 1).contiguous()
    edge = torch.tensor([[0, 0], [R - 32, C - 32], [0, C - 32], [R - 32, 0],
                         [-5, -7], [R + 100, C + 3], [-1, C], [R, -40]],
                        dtype=torch.int32, device="cuda")
    check = torch.cat([origins, edge]).contiguous()
    out_k = tp.extract_patches_cuda(channels, check)
    out_p = tp.extract_patches_plain(channels, check)
    torch.cuda.synchronize()
    exact = bool(torch.equal(out_k, out_p))
    max_err = float((out_k - out_p).abs().max())
    print(f"extract_patches: kernel vs plain at {tuple(check.shape)} origins "
          f"(4096 random + 4 corners + 4 out of range): bit_exact={exact} "
          f"max_abs_err={max_err}")
    if not exact:
        raise AssertionError("extract_patches kernel disagrees with plain")

    # one PyTorch library call computing the same function: torch.take with
    # precomputed flat indices (not used anywhere in the port)
    ar = torch.arange(tp.PATCH, device="cuda")
    oxl = origins[:, 0].long().clamp(0, R - 32)
    oyl = origins[:, 1].long().clamp(0, C - 32)
    idx = (torch.arange(3, device="cuda")[None, :, None, None] * (C * R)
           + (oyl[:, None, None, None] + ar[None, None, :, None]) * R
           + (oxl[:, None, None, None] + ar[None, None, None, :]))
    idx = idx.reshape(NUM_ENVS, 3, tp.PATCH * tp.PATCH).contiguous()
    lib_out = torch.take(channels, idx)
    if not torch.equal(lib_out, tp.extract_patches_cuda(channels, origins)):
        raise AssertionError("library yardstick disagrees with the kernel")

    kernel_ms = cuda_ms(lambda: tp.extract_patches_cuda(channels, origins))
    plain_ms = cuda_ms(lambda: tp.extract_patches_plain(channels, origins))
    library_ms = cuda_ms(lambda: torch.take(channels, idx))
    # the same 50 launches inside one captured graph: no host cost per launch
    kernel_g = graph_ms(lambda: tp.extract_patches_cuda(channels, origins))
    plain_g = graph_ms(lambda: tp.extract_patches_plain(channels, origins))
    library_g = graph_ms(lambda: torch.take(channels, idx))
    graphed = tp.extract_patches_cuda(channels, check)
    if not torch.equal(graphed, out_p):
        raise AssertionError("extract_patches disagrees after the capture")

    # least bytes: each output written once, each input read once; the
    # channel cells read are the union of this run's windows
    cover = torch.zeros(C * R, dtype=torch.bool, device="cuda")
    cells = ((oyl[:, None, None] + ar[None, :, None]) * R
             + (oxl[:, None, None] + ar[None, None, :])).reshape(-1)
    cover[cells] = True
    n_cells = int(cover.sum())
    out_bytes = NUM_ENVS * 3 * tp.PATCH * tp.PATCH * 4
    in_bytes = 3 * n_cells * 4 + origins.numel() * 4
    bound_ms = (out_bytes + in_bytes) / H100_BYTES_PER_S * 1e3
    print(f"extract_patches at N={NUM_ENVS}, CUDA events around 50 "
          f"launches: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.take {library_ms:.4f} ms; the 50 launches in one CUDA "
          f"graph (median of 5 replays): kernel {kernel_g:.4f} ms "
          f"({bound_ms / kernel_g:.1%} of the bound), plain {plain_g:.4f} "
          f"ms, torch.take {library_g:.4f} ms; bound {bound_ms:.4f} ms "
          f"({out_bytes / 1e6:.1f} MB out + {in_bytes / 1e6:.1f} MB in, "
          f"union of windows {n_cells} cells)")
    results["extract_patches"] = dict(
        name="extract_patches", route="cuda",
        source="go2_rl_gym_tpu_torch/ops/csrc/extract_patches.cu",
        replaces="go2_rl_gym_tpu/ops/terrain_patches.py:137",
        bit_exact=exact, max_abs_err=max_err,
        ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes", library_ms=library_ms, graph_ms=kernel_g,
        plain_graph_ms=plain_g, library_graph_ms=library_g)
    del channels, out_k, out_p, lib_out, idx, cover


def phase_cpu_agreement():
    """The card against the port's CPU path (held against the JAX package
    by the tests): 4 rough-terrain steps from one state, and one CTS
    update from one state."""
    from go2_rl_gym_tpu_torch.tools import card_check
    worst = card_check.env_card_vs_cpu(steps=4)
    print(f"card vs CPU path, 8 envs x 4 rough steps: max_abs_err {worst}")
    checks = [("go2_moe_cts CTS.update", card_check.update_card_vs_cpu),
              ("go2 PPO.update", card_check.ppo_update_card_vs_cpu)]
    checks += [(f"go2_lstm RecurrentPPO.update ({t})",
                lambda t=t: card_check.recurrent_update_card_vs_cpu(
                    rnn_type=t)) for t in ("lstm", "gru")]
    for name, check in checks:
        worst = check()
        print(f"card vs CPU path, {name} (64 envs x 4 steps, 5 x 4 "
              f"minibatches): max_abs_err {worst} (atol "
              f"{card_check.UPDATE_ATOL}, learning rates equal)")


def kernel_modules():
    """The port's modules that own a hand-written kernel; each names its
    source (SOURCE) and counts its launches (LAUNCHES)."""
    from go2_rl_gym_tpu_torch.ops import terrain_patches
    return [terrain_patches]


def launch_counts():
    return {k: v for m in kernel_modules() for k, v in m.LAUNCHES.items()}


def reset_launch_counts():
    for m in kernel_modules():
        for k in m.LAUNCHES:
            m.LAUNCHES[k] = 0


def phase_play():
    import torch
    from go2_rl_gym_tpu_torch.scripts.play import play
    from go2_rl_gym_tpu_torch.utils import graphs

    reset_launch_counts()
    caps = graphs.CAPTURES["env_step"]
    res = play(num_envs=NUM_ENVS, steps=STEPS, device="cuda")
    torch.cuda.synchronize()
    counts = launch_counts()
    caps = graphs.CAPTURES["env_step"] - caps
    # one zero-action step in init_runner_state, then env.step as a graph:
    # the eager warm-up and the capture launch the kernel, replays do not
    want = 3
    print(f"play: 75k policy, {NUM_ENVS} envs, {STEPS} steps: mean reward per "
          f"step {[round(r, 5) for r in res['mean_reward']]}")
    print(f"play: done share per step {[round(d, 5) for d in res['done_share']]}")
    print(f"play: {res['env_steps_per_s']:.1f} env-steps/s; launches {counts} "
          f"(init step, warm-up, capture); env.step captures {caps}")
    if not res["finite"]:
        raise AssertionError("play produced non-finite obs or rewards")
    if counts["extract_patches"] != want or caps != 1:
        raise AssertionError(f"extract_patches launched "
                             f"{counts['extract_patches']} times, want {want};"
                             f" {caps} captures, want 1")
    return dict(counts, **{"extract_patches": counts["extract_patches"]
                           + phase_vec_env()["extract_patches"]})


def phase_vec_env(steps=3):
    """VecEnvAdapter on the flagship terrain at 4096 envs: `steps` steps
    through its captured env.step, against eager env.steps from the same
    state and actions."""
    import torch
    from go2_rl_gym_tpu_torch.env.config import Go2Cfg
    from go2_rl_gym_tpu_torch.env.go2_env import Go2Env
    from go2_rl_gym_tpu_torch.env.vec_env import VecEnvAdapter
    from go2_rl_gym_tpu_torch.utils import graphs

    cfg = Go2Cfg()
    cfg.env.num_envs = NUM_ENVS
    env = Go2Env(cfg)
    reset_launch_counts()
    caps = graphs.CAPTURES["env_step"]
    vec = VecEnvAdapter(env, seed=0)
    state = graphs.copy_tree(vec._state)
    g = torch.Generator(device="cuda").manual_seed(0)
    acts = [0.3 * torch.randn((NUM_ENVS, 12), generator=g, device="cuda")
            for _ in range(steps)]
    obs = [vec.step(a)[0] for a in acts]
    torch.cuda.synchronize()
    counts = launch_counts()
    caps = graphs.CAPTURES["env_step"] - caps
    err = 0.0
    with torch.no_grad():
        for a, o in zip(acts, obs):
            state, out = env.step(state, a)
            err = max(err, float((out.obs - o).abs().max()))
    length = vec.episode_length_buf
    print(f"vec env: {steps} steps of VecEnvAdapter at {NUM_ENVS} envs "
          f"through a captured env.step: obs max abs difference to eager "
          f"env.steps {err:.3e}; launches {counts} (reset, warm-up, "
          f"capture); captures {caps}")
    if caps != 1 or counts["extract_patches"] != 3:
        raise AssertionError(f"vec env: {caps} captures, launches {counts}")
    if err != 0.0:
        raise AssertionError(f"vec env: the captured step's obs differ from "
                             f"eager env.steps by {err:.3e}")
    if not (all(bool(torch.isfinite(o).all()) for o in obs)
            and bool((length == state.episode_length).all())):
        raise AssertionError("vec env: non-finite obs or episode lengths "
                             "differ from the eager steps'")
    return counts


def phase_rollout():
    import torch
    from go2_rl_gym_tpu_torch.env.config import Go2Cfg, go2_moe_cts_train_cfg
    from go2_rl_gym_tpu_torch.env.go2_env import Go2Env
    from go2_rl_gym_tpu_torch.train.runner import OnPolicyRunner

    cfg = Go2Cfg()
    cfg.env.num_envs = NUM_ENVS
    tc = go2_moe_cts_train_cfg()
    env = Go2Env(cfg, num_steps_per_env=tc.runner.num_steps_per_env)
    runner = OnPolicyRunner(env, tc)
    rs = runner.init_runner_state(seed=0)
    # init_runner_state never runs the policy: a first, untimed rollout
    # takes the one-time costs of its first calls out of the timed one
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        rs, ro = runner.rollout(rs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = launch_counts()
    traj = ro.traj
    finite = all(bool(torch.isfinite(x).all()) for x in
                 (traj.obs, traj.critic_obs, traj.rewards, traj.actions,
                  ro.last_values, rs.obs))
    shape_ok = (tuple(traj.obs.shape) == (STEPS, NUM_ENVS, 45)
                and tuple(traj.critic_obs.shape) == (STEPS, NUM_ENVS, 263)
                and tuple(traj.history.shape) == (STEPS, NUM_ENVS, 225))
    dt = times[1]
    print(f"rollout: first (untimed) {STEPS} steps in {times[0]:.3f} s; timed "
          f"{STEPS} steps x {NUM_ENVS} envs in {dt:.3f} s = "
          f"{STEPS * NUM_ENVS / dt:.1f} env-steps/s; mean reward "
          f"{float(traj.rewards.mean()):.5f}; done share "
          f"{float(traj.dones.float().mean()):.5f}; launches {counts}")
    if not (finite and shape_ok):
        raise AssertionError(f"rollout output finite={finite} shapes={shape_ok}")
    if counts["extract_patches"] != STEPS:
        raise AssertionError(f"extract_patches launched "
                             f"{counts['extract_patches']} times, want {STEPS}")
    return counts


def phase_train(task="go2_moe_cts", iterations=2):
    """`iterations` train iterations of `task` built through the registry at
    4096 envs: the first untimed, the others timed (see the module
    docstring). Returns the launch counts of the last iteration."""
    import torch
    from go2_rl_gym_tpu_torch.utils import registry, spans

    env_cfg, tc = registry.get_cfgs(task)
    env = registry.make_env(task, env_cfg, num_envs=NUM_ENVS,
                            num_steps_per_env=tc.runner.num_steps_per_env)
    runner = registry.make_runner(task, env, tc)
    rs = runner.init_runner_state(tc.seed, init_at_random_ep_len=True)
    groups = (runner.alg.param_groups() if runner.is_cts
              else [list(runner.alg.model.parameters())])
    groups0 = [[p.detach().clone() for p in g] for g in groups]
    steps = tc.runner.num_steps_per_env
    want = 0 if env_cfg.terrain.mesh_type == "plane" else steps
    runs = []
    # init_runner_state never runs the policy or the update: a first,
    # untimed iteration takes their one-time costs out of the timed one
    for _ in range(iterations):
        timings, clock = {}, []

        def mark(phase, kind):
            if kind != spans.END or phase not in ("rollout", "gae",
                                                  "update"):
                return
            torch.cuda.synchronize()
            clock.append(time.perf_counter())
            timings[phase] = (clock[-1] - clock[-2]) * 1e3
        torch.cuda.synchronize()
        reset_launch_counts()
        clock.append(time.perf_counter())
        with spans.recording(runner.device), spans.listen(mark):
            rs, m = runner.train_step(rs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - clock[0]
        runs.append((dt, timings, launch_counts(), m))
    for i, (dt, timings, counts, m) in enumerate(runs):
        print(f"train {task} iteration {i} ({'timed' if i else 'untimed'}): "
              f"{dt * 1e3:.1f} ms = rollout {timings['rollout']:.1f} + "
              f"GAE {timings['gae']:.2f} + update "
              f"{timings['update']:.1f} ms (host clock, each ending in a "
              f"synchronize); {steps * NUM_ENVS / dt:.1f} env-steps/s; "
              f"launches {counts}")
        if counts["extract_patches"] != want:
            raise AssertionError(f"{task} iteration {i}: extract_patches "
                                 f"launched {counts['extract_patches']} "
                                 f"times, want {want}")
    m = {k: v.detach().cpu() for k, v in runs[-1][3].items()}
    print(f"train {task} metrics: " + json.dumps(
        {k: (v.tolist() if v.dim() else float(v)) for k, v in sorted(m.items())
         if not k.startswith("rew_")}))
    losses = [k for k in m if k.endswith("loss") or k == "entropy"]
    bad = [k for k in losses if not bool(torch.isfinite(m[k]))]
    if bad or "value_loss" not in losses:
        raise AssertionError(f"{task}: non-finite or missing losses {bad}")
    lr = float(m["learning_rate"])
    # the adaptive LR's floor and cap, as fp32 holds them
    lo, hi = (float(torch.tensor(x)) for x in (1e-5, 1e-2))
    if not lo <= lr <= hi:
        raise AssertionError(f"{task}: learning rate {lr} outside "
                             f"[1e-5, 1e-2]")
    for i, (before, after) in enumerate(zip(groups0, groups)):
        moved = max(float((a.detach() - b).abs().max())
                    for a, b in zip(after, before))
        print(f"{task} parameter group {i + 1}: largest move {moved:.3e}")
        if not moved > 0:
            raise AssertionError(f"{task}: parameter group {i + 1} did not "
                                 f"move")
    if not bool(torch.isfinite(rs.obs).all()):
        raise AssertionError(f"{task}: non-finite obs after the iterations")
    if runner.is_recurrent:
        h = float(rs.memory.a.h.abs().max())
        print(f"{task} actor memory after the iterations: max |h| {h:.4f}")
        if not h > 0:
            raise AssertionError(f"{task}: the carried memory is zero")
    return runs[-1][2]


GRAPH_TASKS = ("go2_moe_cts", "go2", "go2_lstm", "go2_fast_flat_move")
GRAPH_K = 3                     # iterations per run of phase train graph
GRAPH_TIMED = 2                 # alternating eager / graphed timed pairs
GRAPH_TIMED_TASKS = ("go2_moe_cts",)    # tasks with timed eager pairs


def _spread(a, b):
    """Max |a - b| per category of two `distributed.check.end_state`s
    (generators: 0.0 if every state is equal, else inf)."""
    out = {}
    for cat in a:
        if cat == "generators":
            out[cat] = 0.0 if all(bool((a[cat][k] == b[cat][k]).all())
                                  for k in a[cat]) else float("inf")
            continue
        errs = [float((a[cat][k].double() - b[cat][k].double()).abs().max())
                if a[cat][k].numel() else 0.0 for k in a[cat]]
        out[cat] = max(errs) if errs else 0.0
    return out


def phase_train_graph():
    """The compiled train step (utils/graphs.py) against eager train_steps
    for each of GRAPH_TASKS at 4096 envs (see the module docstring).
    Returns the patch launches captured in the graphs."""
    import torch
    import warnings
    from go2_rl_gym_tpu_torch.distributed import check
    from go2_rl_gym_tpu_torch.utils import graphs
    from go2_rl_gym_tpu_torch.utils import registry

    captured_total = 0
    bad = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for task in GRAPH_TASKS:
            env_cfg, tc = registry.get_cfgs(task)
            env = registry.make_env(
                task, env_cfg, num_envs=NUM_ENVS,
                num_steps_per_env=tc.runner.num_steps_per_env)
            runner = registry.make_runner(task, env, tc)
            rs0 = graphs.copy_tree(runner.init_runner_state(
                tc.seed, init_at_random_ep_len=True))
            alg = runner.alg
            params0 = {k: p.detach().clone()
                       for k, p in alg.model.named_parameters()}
            owned0 = {n: graphs.copy_tree(getattr(alg, n))
                      for n in check.TRAIN_STATE if hasattr(alg, n)}
            plane = env_cfg.terrain.mesh_type == "plane"
            steps = tc.runner.num_steps_per_env

            def restore():
                with torch.no_grad():
                    for k, p in alg.model.named_parameters():
                        p.copy_(params0[k])
                for n, v in owned0.items():
                    graphs.assign(getattr(alg, n), v)
                return graphs.copy_tree(rs0)

            def flat(m):
                keys, _ = graphs.metric_layout(m)
                return graphs.flat_metrics(keys)(m)

            def eager_run():
                rs, rows = restore(), []
                for _ in range(GRAPH_K):
                    rs, m = runner.train_step(rs)
                    rows.append(flat(m))
                torch.cuda.synchronize()
                return check.end_state(runner, rs, rows)

            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                e1 = eager_run()
            nondet = sorted({str(w.message).split(" does not have")[0]
                             for w in caught
                             if "deterministic" in str(w.message)})

            # graphed: the eager warm-up (under the sync debug mode
            # "error"), the capture, then GRAPH_K - 1 replays
            rs = restore()
            if runner.train_mode()[0] != "graph":
                raise AssertionError(f"{task}: learn's mode is "
                                     f"{runner.train_mode()}")
            step = runner.compiled_step(rs)
            caps0 = graphs.CAPTURES["train_step"]
            reset_launch_counts()
            rows = [step._warm_up().clone()]
            warm = launch_counts()["extract_patches"]
            reset_launch_counts()
            step._capture()
            captured = launch_counts()["extract_patches"]
            for _ in range(GRAPH_K - 1):
                rows.append(step().clone())
            torch.cuda.synchronize()
            replayed = launch_counts()["extract_patches"] - captured
            g = check.end_state(runner, step.state, rows)
            captured_total += captured

            err = _spread(g, e1)
            print(f"train graph {task}: {GRAPH_K} iterations at {NUM_ENVS} "
                  f"envs; max abs difference graphed vs eager: "
                  + json.dumps(err))
            print(f"train graph {task}: ops without a deterministic "
                  f"implementation (torch.use_deterministic_algorithms "
                  f"warnings): {nondet}")
            over = [k for k in err if err[k] != 0.0]
            if over:
                bad.append(f"{task}: graphed differs from eager in {over}")
            if err["generators"] != 0.0:
                bad.append(f"{task}: generator states differ")
            want = 0 if plane else steps
            print(f"train graph {task}: patch launches: warm-up {warm}, "
                  f"captured {captured}, in {GRAPH_K - 1} replays "
                  f"{replayed}; captures "
                  f"{graphs.CAPTURES['train_step'] - caps0} (runner "
                  f"{step.captures}); capture + instantiate "
                  f"{step.capture_s:.2f} s; graph pool "
                  f"{step.pool_bytes} bytes ({step.pool_bytes / 2**30:.2f} "
                  f"GiB)")
            if (warm, captured, replayed) != (want, want, 0):
                bad.append(f"{task}: patch launches {warm}, {captured}, "
                           f"{replayed}, want {want}, {want}, 0")

            # save after the replays; an eager runner loads it and takes
            # the next iteration, which must equal the graphed one's
            path = os.path.join(ROOT, "build", f"graph_{task}.pt")
            runner.current_iteration = GRAPH_K
            runner.save(step.state, path)
            rows.append(step().clone())
            g4 = check.end_state(runner, step.state, rows[-1:])
            other = registry.make_runner(task, env, tc)
            rs_o = other.load(other.init_runner_state(1), path)
            rs_o, m = other.train_step(rs_o)
            e4 = check.end_state(other, rs_o, [flat(m)])
            os.remove(path)
            rt = _spread(g4, e4)
            print(f"train graph {task}: save after the replays, loaded into "
                  f"an eager runner, one more iteration: max abs difference "
                  f"to the graphed one's " + json.dumps(rt))
            if any(rt[k] != 0.0 for k in rt):
                bad.append(f"{task}: save/load round trip {rt}")
            if step.captures != 1 or graphs.CAPTURES["train_step"] - caps0 != 1:
                bad.append(f"{task}: {step.captures} captures")

            del other
            # as learn runs: a runner of its own, deterministic algorithms
            # off, its graph captured after its warm-up; eager pairs for
            # GRAPH_TIMED_TASKS, one replay for the others
            torch.use_deterministic_algorithms(False)
            timed = registry.make_runner(task, env, tc)
            rs_e = timed.init_runner_state(tc.seed,
                                           init_at_random_ep_len=True)
            step_t = timed.compiled_step(rs_e)
            step_t()
            times = {"eager": [], "graphed": [], "replay_call": [],
                     "replay_device": []}
            replay_launches = 0
            pairs = task in GRAPH_TIMED_TASKS
            for _ in range(GRAPH_TIMED if pairs else 1):
                if pairs:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    rs_e, _ = timed.train_step(rs_e)
                    torch.cuda.synchronize()
                    times["eager"].append((time.perf_counter() - t) * 1e3)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                n0 = launch_counts()["extract_patches"]
                t = time.perf_counter()
                start.record()
                step_t()
                end.record()
                times["replay_call"].append((time.perf_counter() - t) * 1e3)
                torch.cuda.synchronize()
                times["graphed"].append((time.perf_counter() - t) * 1e3)
                times["replay_device"].append(start.elapsed_time(end))
                replay_launches += launch_counts()["extract_patches"] - n0
            torch.use_deterministic_algorithms(True, warn_only=True)
            rate = {k: [round(steps * NUM_ENVS / (v / 1e3), 1)
                        for v in times[k]] for k in ("eager", "graphed")}
            print(f"train graph {task}, as learn runs (deterministic "
                  f"algorithms off; captures {step_t.captures}, capture + "
                  f"instantiate {step_t.capture_s:.2f} s, graph pool "
                  f"{step_t.pool_bytes} bytes; patch launches in "
                  f"{len(times['graphed'])} replays {replay_launches}): "
                  f"host ms per iteration (ending in a synchronize)"
                  + (", eager / graphed alternating: eager "
                     f"{[round(v, 3) for v in times['eager']]}," if pairs
                     else ":")
                  + f" graphed {[round(v, 3) for v in times['graphed']]}; "
                  f"env-steps/s"
                  + (f" eager {rate['eager']}," if pairs else "")
                  + f" graphed {rate['graphed']}; "
                  f"device ms of one replay (CUDA events) "
                  f"{[round(v, 3) for v in times['replay_device']]}; host "
                  f"ms of the replay call "
                  f"{[round(v, 3) for v in times['replay_call']]}")
            if step_t.captures != 1 or replay_launches:
                bad.append(f"{task}: the timed runner captured "
                           f"{step_t.captures} times, its replays launched "
                           f"the patch kernel {replay_launches} times")
            del runner, step, env, timed, step_t
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    if bad:
        raise AssertionError(f"train graph: {bad}")
    return {"extract_patches": captured_total}


BENCH_ITERS = 2                 # iterations per dispatch of phase bench
BENCH_REPS = 1                  # timed dispatches of phase bench
BENCH_KEYS = {"metric", "value", "unit", "median_dispatch_s",
              "all_dispatch_s", "first_dispatch_s", "iters_per_dispatch",
              "num_envs", "task", "capture_s", "name", "power_limit",
              "guard"}


def phase_bench():
    """go2_rl_gym_tpu_torch.bench.run, short (see the module docstring).
    Returns the run's patch launches (the init step's, the warm-up's and
    the capture's)."""
    import torch
    from go2_rl_gym_tpu_torch import bench
    from go2_rl_gym_tpu_torch.utils import graphs

    reset_launch_counts()
    caps0 = graphs.CAPTURES["train_step"]
    deterministic = torch.are_deterministic_algorithms_enabled()
    res = bench.run(NUM_ENVS, iters=BENCH_ITERS, reps=BENCH_REPS)
    print("bench: " + json.dumps(res))
    launches = launch_counts()["extract_patches"]
    caps = graphs.CAPTURES["train_step"] - caps0
    print(f"bench: {caps} capture, {launches} patch launches in the run "
          f"(want {1 + 2 * STEPS}: the init step 1, the warm-up and the "
          f"capture {STEPS} each, the replays 0), deterministic algorithms "
          f"{'on' if deterministic else 'off'}")
    bad = []
    if set(res) != BENCH_KEYS:
        bad.append(f"keys {sorted(set(res) ^ BENCH_KEYS)}")
    if caps != 1 or launches != 1 + 2 * STEPS or deterministic:
        bad.append(f"{caps} captures, {launches} patch launches, "
                   f"deterministic {deterministic}")
    want = BENCH_ITERS * STEPS * NUM_ENVS / res["median_dispatch_s"]
    if not (math.isfinite(res["value"]) and res["value"] > 0
            and abs(res["value"] - want) <= 1e-9 * want):
        bad.append(f"value {res['value']}, want {want}")
    if bad:
        raise AssertionError(f"bench: {bad}")
    return launch_counts()


def run_ranks(cmds, tag="cmd"):
    """Run the commands at once, each in its own session with its output
    in a file under DDP_DIR (<tag><i>.log; no pipe for a surviving child to
    hold), and wait; after a failure or RANK_TIMEOUT_S every session gets
    SIGTERM (torch.distributed.run, which scripts.train becomes for W
    ranks, then stops its workers, which run in sessions of their own),
    and SIGKILL 30 s later.
    Returns the outputs; raises, with each one's tail, if any command
    failed or timed out."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    os.makedirs(DDP_DIR, exist_ok=True)
    logs = [os.path.join(DDP_DIR, f"{tag}{i}.log") for i in range(len(cmds))]
    procs = []
    for c, log in zip(cmds, logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(c, cwd=ROOT, env=env, stdout=f,
                                          stderr=subprocess.STDOUT,
                                          start_new_session=True))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    timed_out = False
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
            if p.returncode:
                break
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        live = [p for p in procs if p.poll() is None]
        for p in live:
            os.killpg(p.pid, signal.SIGTERM)
        for p in live:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    outs = []
    for log in logs:
        with open(log) as f:
            outs.append(f.read())
    bad = [(p.returncode, out[-3000:]) for p, out in zip(procs, outs)
           if p.returncode]
    if bad or timed_out:
        why = "timed out" if timed_out else "failed"
        raise AssertionError(f"a rank {why}: {bad}")
    return outs


def worker(job_path, out, backend, device):
    return ["-m", "go2_rl_gym_tpu_torch.distributed.check", "--job",
            job_path, "--out", out, "--backend", backend, "--device", device,
            "--timeout", "120"]


def phase_train_ddp():
    """(a) NCCL ranks training go2_moe_cts, (b) two gloo ranks against one
    process on the card (see the module docstring). Returns the launch
    counts of the ranks' last iteration, summed over the ranks."""
    import torch
    from go2_rl_gym_tpu_torch.distributed import check
    from go2_rl_gym_tpu_torch.distributed import mesh as mesh_lib

    os.makedirs(DDP_DIR, exist_ok=True)
    world = torch.cuda.device_count()
    job_path = os.path.join(DDP_DIR, "train_job.pt")
    torch.save({"jobs": [dict(kind="train", task="go2_moe_cts",
                              num_envs=NUM_ENVS, iterations=2,
                              checkpoint=os.path.join(DDP_DIR, "model.pt"),
                              profile=True)]}, job_path)
    out = os.path.join(DDP_DIR, "train")
    run_ranks([[sys.executable, "-m", "torch.distributed.run",
                "--standalone", f"--nproc_per_node={world}"]
               + worker(job_path, out, "nccl", "cuda")])
    res = [torch.load(f"{out}.rank{r}", weights_only=True)[0]
           for r in range(world)]
    local = NUM_ENVS // world
    for i in range(2):
        dt = max(r["times"][i] for r in res)
        print(f"train ddp (a): nccl, world {world}, {local} envs per rank, "
              f"iteration {i} ({'timed' if i else 'untimed'}): rank "
              f"env-steps/s {[round(r['rank_env_steps_per_s'][i], 1) for r in res]}"
              f", total {STEPS * NUM_ENVS / dt:.1f} env-steps/s "
              f"({dt * 1e3:.1f} ms, host clock ending in a synchronize); "
              f"patch launches per rank "
              f"{[r['launches'][i]['extract_patches'] for r in res]}")
    for r, rr in enumerate(res):
        if [c["extract_patches"] for c in rr["launches"]] != [STEPS] * 2:
            raise AssertionError(f"rank {r} launched {rr['launches']}")
        bad = [k for k, v in rr["metrics"].items()
               if not bool(torch.isfinite(v).all())]
        if bad or not rr["obs_finite"]:
            raise AssertionError(f"rank {r}: non-finite {bad} or obs")
        if not rr["checkpoint_roundtrip"]:
            raise AssertionError(f"rank {r}: the checkpoint did not load "
                                 f"back equal")
        for k, v in rr["params"].items():
            if not torch.equal(v, res[0]["params"][k]):
                raise AssertionError(f"rank {r} parameter {k} differs")
    print(f"train ddp (a): checkpoint gathered by rank 0 and loaded back "
          f"by every rank: equal")
    lost = [rr["profile"]["lost_launches"] for rr in res]
    for r, rr in enumerate(res):
        prof = rr["profile"]
        print(f"train ddp (a) rank {r}, one more iteration, GAE + update + "
              f"metrics under torch.profiler (its window opened at the "
              f"rollout's end after a lead-in): {prof['wall_ms']:.1f} ms "
              f"wall, "
              f"device busy "
              f"{prof['device_busy_ms']:.1f} ms in {prof['launches']} "
              f"launches ({prof['lost_launches']} launches whose kernel "
              f"the trace lacks), NCCL kernels "
              f"{prof['nccl_device_ms']:.3f} ms in "
              f"{prof['nccl_launches']}; collective calls [count, host ms]: "
              f"{json.dumps(prof['collective_calls_host_ms'])}")
    if any(lost):
        raise AssertionError(f"train ddp (a): the ranks' traces lost "
                             f"{lost} launches")
    m = res[0]["metrics"]
    print("train ddp (a) metrics: " + json.dumps(
        {k: round(float(m[k]), 6) for k in ("value_loss", "surrogate_loss",
                                            "latent_loss", "learning_rate",
                                            "done_count")}))

    # (b) two gloo ranks on this card against one process
    job = check.parity_job("go2_moe_cts", NUM_ENVS, DDP_PARITY_STEPS, "cuda")
    job_path = os.path.join(DDP_DIR, "parity_job.pt")
    torch.save({"jobs": [job]}, job_path)
    out = os.path.join(DDP_DIR, "parity")
    port = mesh_lib.free_port()
    cmds = [[sys.executable] + worker(job_path, out, "gloo", "cuda:0")
            + ["--coordinator", f"localhost:{port}", "--world", "2",
               "--rank", str(r)] for r in range(2)]
    t = time.perf_counter()
    run_ranks(cmds)
    ranks_s = time.perf_counter() - t
    ref = check.run_step(job, "cuda")
    r0, r1 = (torch.load(f"{out}.rank{r}", weights_only=True)[0]
              for r in range(2))
    if bool(ref["dones"].any()):
        raise AssertionError(f"{int(ref['dones'].sum())} resets in the "
                             f"parity window")
    same = all(torch.equal(r0["params"][k], r1["params"][k])
               for k in r0["params"])
    err = max(float((r0["params"][k] - v).abs().max())
              for k, v in ref["params"].items())
    moved = max(float((v - job["train_state"]["model"][k]).abs().max())
                for k, v in ref["params"].items())
    ret = max(float((torch.cat([r0[k], r1[k]], 1) - ref[k]).abs().max())
              for k in ("returns", "advantages"))
    metric_rel = max(float(((r0["metrics"][k] - v).abs()
                            / v.abs().clamp(min=1e-6)).max())
                     for k, v in ref["metrics"].items())
    print(f"train ddp (b): 2 gloo ranks x {NUM_ENVS // 2} envs on one card "
          f"vs one process, one iteration of {DDP_PARITY_STEPS} steps "
          f"(ranks {ranks_s:.1f} s with start-up): params max_abs_err "
          f"{err:.3e} (tol 1e-5; largest move {moved:.3e}), bitwise equal "
          f"across ranks {same}, returns/advantages max_abs_err {ret:.3e}, "
          f"metrics max rel err {metric_rel:.3e}, learning rates "
          f"{float(r0['lr'])} / {float(ref['lr'])}")
    if not (same and err <= 1e-5 and moved > 1e-4
            and float(r0["lr"]) == float(ref["lr"])):
        raise AssertionError("two ranks disagree with one process")
    return {"extract_patches": sum(r["launches"][-1]["extract_patches"]
                                   for r in res)}


DDP_GRAPH_TIMED = 2             # eager / graphed pairs of train ddp graph
DDP_GRAPH_LEARN = 3             # iterations of learn under the mesh
DDP_GRAPH_LSTM_ENVS = 1024


def phase_train_ddp_graph():
    """The compiled train step under a mesh (see the module docstring):
    torch.cuda.device_count() NCCL ranks of the check worker's "graph"
    job. Returns the patch launches recorded in the ranks' captures."""
    import torch

    os.makedirs(DDP_DIR, exist_ok=True)
    world = torch.cuda.device_count()
    jobs = [dict(kind="graph", task="go2_moe_cts", num_envs=NUM_ENVS,
                 iterations=GRAPH_K, timed=DDP_GRAPH_TIMED,
                 learn=DDP_GRAPH_LEARN,
                 log_root=os.path.join(DDP_DIR, "logs")),
            dict(kind="graph", task="go2_lstm",
                 num_envs=DDP_GRAPH_LSTM_ENVS, iterations=2),
            # the reference for the mesh's cost: one process's graph of the
            # same iteration on each rank's card, no collectives
            dict(kind="graph", task="go2_moe_cts", num_envs=NUM_ENVS,
                 iterations=1, timed=1, no_mesh=True)]
    job_path = os.path.join(DDP_DIR, "graph_job.pt")
    torch.save({"jobs": jobs}, job_path)
    out = os.path.join(DDP_DIR, "graph")
    [log] = run_ranks([[sys.executable, "-m", "torch.distributed.run",
                        "--standalone", f"--nproc_per_node={world}"]
                       + worker(job_path, out, "nccl", "cuda")])
    res = [torch.load(f"{out}.rank{r}", weights_only=True)
           for r in range(world)]
    bad, captured = [], 0
    for i, job in enumerate(jobs):
        task = job["task"]
        for r in range(world):
            rr = res[r][i]
            err = _spread(rr["compiled"], rr["eager"])
            launches = rr["launches"]
            print(f"train ddp graph {task} rank {r}/{world} (nccl, "
                  f"{rr['local_envs']} of {job['num_envs']} envs): mode "
                  f"{rr['mode']}; {job['iterations']} iterations, max abs "
                  f"difference graphed vs eager (deterministic algorithms "
                  f"on): " + json.dumps(err) + f"; captures "
                  f"{rr['captures']}, patch launches warm-up "
                  f"{launches['warm_up']}, captured {launches['capture']}, "
                  f"in {job['iterations'] - 1} replays "
                  f"{launches['replays']}; capture + instantiate "
                  f"{rr['capture_s']:.2f} s; graph pool {rr['pool_bytes']} "
                  f"bytes; seconds " + json.dumps(
                      {k: round(v, 1) for k, v in rr["seconds"].items()}))
            if rr["mode"][0] != "graph" or not rr["graphed"]:
                bad.append(f"{task} rank {r}: mode {rr['mode']}")
            if any(v != 0.0 for v in err.values()):
                bad.append(f"{task} rank {r}: graphed != eager {err}")
            if rr["captures"] != 1:
                bad.append(f"{task} rank {r}: {rr['captures']} captures")
            steps = rr["steps"]
            if (launches["warm_up"], launches["capture"],
                    launches["replays"]) != (steps, steps, 0):
                bad.append(f"{task} rank {r}: patch launches {launches}")
            captured += launches["capture"]
            # data-parallel: every rank holds rank 0's parameters
            other = [k for k, v in rr["compiled"]["params"].items()
                     if not torch.equal(v, res[0][i]["compiled"]["params"][k])]
            if other:
                bad.append(f"{task} rank {r}: parameters {other[:3]} differ "
                           f"from rank 0's")
    moe = [res[r][0] for r in range(world)]
    steps, local = moe[0]["steps"], moe[0]["local_envs"]
    for name, key in (("eager", "eager_ms"), ("graphed", "compiled_ms")):
        per_rank = [[round(steps * local / (ms / 1e3), 1)
                     for ms in rr["times"][key]] for rr in moe]
        total = [round(steps * NUM_ENVS / (max(rr["times"][key][j]
                                                for rr in moe) / 1e3), 1)
                 for j in range(DDP_GRAPH_TIMED)]
        print(f"train ddp graph go2_moe_cts {name}, alternating pairs (host "
              f"ms ending in a synchronize; eager with deterministic "
              f"algorithms off, the graph as captured with them on): "
              f"ms per rank {[[round(v, 3) for v in rr['times'][key]] for rr in moe]}; "
              f"env-steps/s per rank {per_rank}, total {total}")
    for r, rr in enumerate(moe):
        prof = rr["profiled"]
        if prof["lost_launches"]:
            bad.append(f"rank {r}: the profiled replay lost "
                       f"{prof['lost_launches']} launches")
        print(f"train ddp graph go2_moe_cts rank {r}: device ms of a replay "
              f"(CUDA events) "
              f"{[round(v, 3) for v in rr['times']['compiled_device_ms']]}; "
              f"the update's gathers (one all_gather each, CUDA events over "
              f"5): " + json.dumps(rr["gathers"]) + f"; one replay under "
              f"torch.profiler: {prof['launches']} kernel launches "
              f"({prof['lost_launches']} launches whose kernel the trace "
              f"lacks), {prof['device_ms']:.3f} device ms, NCCL kernels "
              f"and memcpy rows [name, count, ms]: " + json.dumps(
                  prof["nccl_or_memcpy"]))
    one = res[0][2]
    if one["profiled"]["lost_launches"]:
        bad.append(f"the profiled replay without a mesh lost "
                   f"{one['profiled']['lost_launches']} launches")
    print(f"train ddp graph go2_moe_cts without a mesh ({NUM_ENVS} envs in "
          f"one process on rank 0's card): host ms of a graphed iteration "
          f"{[round(v, 3) for v in one['times']['compiled_ms']]}, device ms "
          f"{[round(v, 3) for v in one['times']['compiled_device_ms']]}; one "
          f"replay under torch.profiler: {one['profiled']['launches']} kernel "
          f"launches ({one['profiled']['lost_launches']} launches whose "
          f"kernel the trace lacks), {one['profiled']['device_ms']:.3f} "
          f"device ms")
    logged = moe[0]["learn"]
    finite = bool(logged) and all(math.isfinite(v) for t in logged.values()
                                  for v in t.values())
    mode_line = [ln for ln in log.splitlines() if ln.startswith("learn: ")]
    print(f"train ddp graph go2_moe_cts: learn(rs, {DDP_GRAPH_LEARN}) under "
          f"the mesh printed {mode_line}; rank 0 logged {len(logged)} tags, "
          f"all finite {finite}: " + json.dumps(
              {k: logged[k] for k in ("Loss/value", "Loss/surrogate",
                                      "Loss/latent")
               if k in logged}))
    if not mode_line or not mode_line[0].startswith("learn: graph ("):
        bad.append(f"learn's mode line {mode_line}")
    if not finite:
        bad.append("learn under the mesh logged non-finite metrics")
    if bad:
        raise AssertionError(f"train ddp graph: {bad}")
    return {"extract_patches": captured}


def smoke_evaluator(log_dir):
    """The eval hook's AsyncEvaluator on the flat scene for 1 s, with each
    evaluator process in its own process group, its stderr in a file under
    `log_dir`, its start and end times recorded, and a wait of at most
    EVAL_TIMEOUT_S after which its group is killed."""
    from go2_rl_gym_tpu_torch.train.eval_hook import AsyncEvaluator

    class SmokeEvaluator(AsyncEvaluator):
        def __init__(self):
            super().__init__(log_dir, scenes=("flat",), duration_s=1.0)
            self.submitted, self.spawned = [], []

        def submit(self, policy_path, iteration):
            self.submitted.append(iteration)
            super().submit(policy_path, iteration)

        def _spawn(self, cmd, env):
            err = os.path.join(log_dir, f"evaluator_{len(self.spawned)}.err")
            with open(err, "w") as f:
                proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                        stderr=f, env=env,
                                        start_new_session=True)
            rec = dict(cmd=cmd, env=env, stderr=err, proc=proc,
                       start=time.perf_counter(), end=None)

            def reap():
                proc.wait()
                rec["end"] = time.perf_counter()
            threading.Thread(target=reap, daemon=True).start()
            self.spawned.append(rec)
            return proc

        def wait_all(self, timeout=None):
            deadline = time.monotonic() + EVAL_TIMEOUT_S
            for _, proc, _ in self._jobs:
                try:
                    proc.wait(timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
            return self.poll()

        def kill_all(self):
            for rec in self.spawned:
                if rec["proc"].poll() is None:
                    os.killpg(rec["proc"].pid, signal.SIGKILL)
                    rec["proc"].wait()

    return SmokeEvaluator()


def within(got, want, atol, rtol=0.0):
    """max |got - want| and whether every entry is within atol + rtol|want|."""
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    return float(err.max()), bool((err <= atol + rtol * np.abs(want)).all())


def stacked_by_term(frames, term_dims=(3, 3, 3, 12, 12, 12)):
    """(L, 45) frames -> the ONNX interface's (1, L*45) input, stacked by
    term (reference exporter.py:238-262)."""
    import numpy as np
    off = np.cumsum((0,) + tuple(term_dims))
    return np.concatenate([frames[None, :, off[t]:off[t + 1]].reshape(1, -1)
                           for t in range(len(term_dims))], axis=1)


def phase_export_eval(num_envs=NUM_ENVS, device="cuda"):
    """Train with the eval hook, then check every export of the trained
    weights (see the module docstring). Returns the launch counts of the
    two iterations."""
    import numpy as np
    import torch
    import yaml
    from go2_rl_gym_tpu_torch.deploy.mujoco_eval import ModelPolicy
    from go2_rl_gym_tpu_torch.export import exporter, native, onnx_native
    from go2_rl_gym_tpu_torch.export.importer import tree_from_named
    from go2_rl_gym_tpu_torch.utils import graphs
    from go2_rl_gym_tpu_torch.utils import registry

    task, iters = "go2_moe_cts", 2
    log_root = os.path.join(EXPORT_DIR, "logs")
    env_cfg, tc = registry.get_cfgs(task)
    env = registry.make_env(task, env_cfg, num_envs=num_envs,
                            num_steps_per_env=tc.runner.num_steps_per_env,
                            device=device)
    runner = registry.make_runner(task, env, tc, log_root=log_root,
                                  device=device, eval_interval=1)
    ev = runner.evaluator = smoke_evaluator(runner.log_dir)
    rs = runner.init_runner_state(tc.seed, init_at_random_ep_len=True)
    calls = []
    train_step = runner.train_step

    def counted(*args, **kwargs):
        out = train_step(*args, **kwargs)
        calls.append(launch_counts()["extract_patches"])
        return out
    runner.train_step = counted
    caps = graphs.CAPTURES["train_step"]
    try:
        reset_launch_counts()
        t = time.perf_counter()
        rs = runner.learn(rs, iters, log_every=1, print_every=1)
        learn_s = time.perf_counter() - t
        counts = launch_counts()
    finally:
        ev.kill_all()
    caps = graphs.CAPTURES["train_step"] - caps
    calls = [b - a for a, b in zip([0] + calls[:-1], calls)]
    steps = tc.runner.num_steps_per_env
    print(f"export + eval: learn({iters}) with eval_interval 1 in "
          f"{learn_s:.1f} s (waits for the evaluators included), mode "
          f"{runner.train_mode()[0]}: train_step ran {len(calls)} times "
          f"(the eager warm-up and the capture), patch launches per call "
          f"{calls}, {caps} capture; the other iterations replayed")
    if (runner.train_mode()[0] != "graph" or caps != 1
            or calls != [steps] * 2):
        raise AssertionError(f"learn ran {runner.train_mode()}, patch "
                             f"launches per train_step call {calls}, want "
                             f"{[steps] * 2}, {caps} captures")
    rows = [json.loads(line) for line in
            open(os.path.join(runner.log_dir, "metrics.jsonl"))]
    fps = [r["value"] for r in rows if r["tag"] == "Perf/total_fps"]
    print(f"export + eval: learn's env-steps/s per iteration {fps} (iteration "
          f"0 with its first calls; saves and exports left out)")
    jit_dir = os.path.join(runner.log_dir, "jit_models")
    want = [f"policy_jit_{i}.pt" for i in range(iters + 1)]
    if sorted(os.listdir(jit_dir)) != want:
        raise AssertionError(f"jit_models holds {sorted(os.listdir(jit_dir))}"
                             f", want {want}")
    if ev.submitted != list(range(iters + 1)):
        raise AssertionError(f"submitted {ev.submitted}")
    if len(ev.spawned) != len(ev.submitted):
        raise AssertionError(f"{len(ev.spawned)} evaluator processes for "
                             f"{len(ev.submitted)} exports")
    if any(r["env"]["CUDA_VISIBLE_DEVICES"] != "" for r in ev.spawned):
        raise AssertionError("an evaluator process could see the card")

    # TorchScript on the CPU and on the card against the card model
    model = runner.alg.model
    obs_seq = rs.obs[:EXPORT_SEQ].detach().cpu().numpy()
    student = ModelPolicy(model, device=device)
    want_mu = np.stack([student(o) for o in obs_seq])
    jit_path = os.path.join(jit_dir, want[-1])
    outs = {}
    for where in ("cpu", device):
        pol = torch.jit.load(jit_path, map_location=where)
        with torch.no_grad():
            seq = []
            for o in obs_seq:
                a = pol(torch.as_tensor(o, device=where)[None])
                seq.append((a[0] if isinstance(a, tuple) else a)[0])
            pol.reset()
            a = pol(torch.as_tensor(obs_seq[0], device=where)[None])
            first = (a[0] if isinstance(a, tuple) else a)[0]
        outs[where] = torch.stack(seq).cpu().numpy()
        err, ok = within(outs[where], want_mu, 2e-5, 1e-4)
        again = bool(torch.equal(first.cpu(), seq[0].cpu()))
        print(f"export + eval: policy_jit_{iters}.pt on {where}, "
              f"{EXPORT_SEQ} obs, vs the card model's student mu: "
              f"max_abs_err {err:.3e} (tol 2e-5 + 1e-4 rel); reset() gives "
              f"the first action back: {again}")
        if not (ok and again):
            raise AssertionError(f"TorchScript on {where} disagrees")
    ref = outs["cpu"]

    # every artifact of the same weights, each export timed
    art = os.path.join(EXPORT_DIR, "artifacts")
    paths, export_ms = {}, {}
    for kind in ("jit", "onnx", "g2p", "pkl"):
        t = time.perf_counter()
        paths[kind] = exporter.export_model(
            model, kind, "moe_cts", art,
            meta={"task": task, "algorithm": "MoECTS"})
        export_ms[kind] = (time.perf_counter() - t) * 1e3
    print(f"export + eval: export ms {json.dumps(export_ms)}")
    params = tree_from_named(model.named_parameters())
    frames = obs_seq[-5:]
    x = stacked_by_term(frames)
    got = onnx_native.OnnxPolicy(paths["onnx"])(x)
    stacked = exporter.build_torch_policy_stacked(params, "moe_cts")
    with torch.no_grad():
        exp = stacked(torch.as_tensor(x))
    exp = [exp[0]] + list(exp[1])
    err = max(within(g, e.numpy(), 1e-5)[0] for g, e in zip(got, exp))
    print(f"export + eval: policy.onnx in OnnxPolicy vs "
          f"build_torch_policy_stacked (actions, weights, latent): "
          f"max_abs_err {err:.3e} (tol 1e-5)")
    if not err <= 1e-5:
        raise AssertionError("ONNX export disagrees")

    t = time.perf_counter()
    lib = native.build_library(force=True)
    print(f"export + eval: g++ built {os.path.relpath(lib, ROOT)} in "
          f"{time.perf_counter() - t:.1f} s")
    for kind in ("g2p", "onnx"):
        pol = native.NativePolicy(paths[kind], lib)
        got = np.stack([pol(o) for o in obs_seq])
        pol.close()
        err, ok = within(got, ref, 1e-5, 1e-4)
        print(f"export + eval: policy.{kind} in NativePolicy vs the "
              f"TorchScript: max_abs_err {err:.3e} (tol 1e-5 + 1e-4 rel)")
        if not ok:
            raise AssertionError(f"NativePolicy on .{kind} disagrees")

    loaded, meta = exporter.load_policy_params(paths["pkl"])

    def flat(tree, pre=()):
        for k, v in tree.items():
            yield from (flat(v, pre + (k,)) if isinstance(v, dict)
                        else [(pre + (k,), v)])
    a, b = dict(flat(loaded)), dict(flat(params))
    same = sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    print(f"export + eval: policy.pkl loads back equal to the parameters: "
          f"{same} ({len(a)} arrays, meta {meta})")
    if not same:
        raise AssertionError("the pkl does not load back equal")

    # the scoring: MuJoCo in the evaluator processes, where it exists
    for i, rec in enumerate(ev.spawned):
        tail = open(rec["stderr"]).read().strip().splitlines()
        wall = (rec["end"] or time.perf_counter()) - rec["start"]
        print(f"export + eval: evaluator {i} (policy_jit_{ev.submitted[i]}): "
              f"exit code {rec['proc'].returncode}, wall {wall:.2f} s, last "
              f"stderr line: {tail[-1] if tail else ''!r}")
    try:
        import mujoco  # noqa: F401
    except ImportError:
        print("export + eval: MuJoCo is absent on this machine, so the "
              "evaluators cannot score; the scoring is held on the CPU by "
              "tests/test_torch_eval_hook.py")
        return counts
    for it in ev.submitted:
        out = os.path.join(runner.log_dir, "eval_results",
                           f"results_{it}.yaml")
        with open(out) as f:
            scores = yaml.safe_load(f)
        print(f"export + eval: results_{it}.yaml {json.dumps(scores)}")
        for k in ("tracking", "safety", "quality", "overall"):
            if not 0.0 <= float(scores[k]) <= 1.0:
                raise AssertionError(f"results_{it}: {k} = {scores[k]}")
    return counts


def _fps_by_iteration(run_dir):
    """learn's logged env-steps/s (Perf/total_fps) by iteration."""
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["value"] for r in rows
            if r["tag"] == "Perf/total_fps"}


def _one_run(root):
    runs = sorted(os.listdir(root))
    if len(runs) != 1:
        raise AssertionError(f"{root} holds runs {runs}, want one")
    return os.path.join(root, runs[0])


def _rank_launches(out, world, want):
    """The `launches: {...}` lines of scripts.train's ranks in `out`: None
    unless there is one per rank, each with `want` patch launches; else
    their sum."""
    rows = [json.loads(ln[len("launches: "):]) for ln in out.splitlines()
            if ln.startswith("launches: ")]
    if sorted(r["rank"] for r in rows) != list(range(world)) or any(
            r["extract_patches"] != want for r in rows):
        return None
    return sum(r["extract_patches"] for r in rows)


def phase_train_script():
    """The user's commands as subprocesses (see the module docstring): (a)
    scripts.train with --profile_dir, (b) --resume, (c) scripts.play with
    no --task. Returns the patch launches that the processes printed."""
    import torch
    from go2_rl_gym_tpu_torch.utils import registry

    world = torch.cuda.device_count()
    # per rank: the init step, learn's warm-up and its capture; no replay
    want = 1 + 2 * registry.get_cfgs(
        "go2_moe_cts")[1].runner.num_steps_per_env
    launches = {}
    shutil.rmtree(TRAIN_SCRIPT_DIR, ignore_errors=True)
    logs = os.path.join(TRAIN_SCRIPT_DIR, "logs")
    prof_dir = os.path.join(TRAIN_SCRIPT_DIR, "profile")
    exp = os.path.join(logs, "go2_moe_cts")
    train = [sys.executable, "-m", "go2_rl_gym_tpu_torch.scripts.train",
             "--task", "go2_moe_cts", "--num_envs", str(NUM_ENVS),
             "--log_root", logs]
    bad = []

    # (a) train 14 iterations, 10-12 traced
    t = time.perf_counter()
    [out] = run_ranks([train + ["--max_iterations", str(TRAIN_SCRIPT_ITERS),
                                "--profile_dir", prof_dir]], tag="train_a")
    secs = {"train": time.perf_counter() - t}
    run_a = _one_run(exp)
    mode = [ln for ln in out.splitlines() if ln.startswith("learn: ")]
    ranks = [ln for ln in out.splitlines() if ln.startswith("data-parallel")]
    profiles = [json.loads(ln[len("profile: "):]) for ln in out.splitlines()
                if ln.startswith("profile: ")]
    fps = _fps_by_iteration(run_a)
    launches["train"] = _rank_launches(out, world, want)
    print(f"train script (a): {' '.join(train[1:])} --max_iterations "
          f"{TRAIN_SCRIPT_ITERS} --profile_dir ... in {secs['train']:.1f} s "
          f"on {world} card(s): {mode}; {ranks}; learn's env-steps/s by "
          f"iteration (Perf/total_fps) " + json.dumps(fps)
          + "; learn's lines " + json.dumps(
              [ln for ln in out.splitlines() if ln.startswith("it ")]))
    for p in profiles:
        print("train script (a) trace: " + json.dumps(
            dict(p, bytes=os.path.getsize(p["trace"]))))
    last = f"model_{TRAIN_SCRIPT_ITERS}.pt"
    if not mode or not mode[0].startswith("learn: graph ("):
        bad.append(f"(a) mode {mode}")
    if last not in os.listdir(run_a):
        bad.append(f"(a) no {last} in {sorted(os.listdir(run_a))}")
    if world > 1 and not any(f"data-parallel over {world} ranks" in ln
                             for ln in ranks):
        bad.append(f"(a) ranks {ranks}")
    if sorted(p["rank"] for p in profiles) != list(range(world)) or any(
            p["kernel_launches"] <= 0 or p["lost_launches"] != 0
            or p["iterations"] != [10, 12] for p in profiles):
        bad.append(f"(a) traces {profiles}")
    if launches["train"] is None:
        bad.append(f"(a) patch launches per rank, want {want}: " + str(
            [ln for ln in out.splitlines() if ln.startswith("launches: ")]))

    # (b) resume for one more iteration
    t = time.perf_counter()
    [out] = run_ranks([train + ["--resume", "--max_iterations", "1"]],
                      tag="train_b")
    secs["resume"] = time.perf_counter() - t
    launches["resume"] = _rank_launches(out, world, want)
    if launches["resume"] is None:
        bad.append(f"(b) patch launches per rank, want {want}: " + str(
            [ln for ln in out.splitlines() if ln.startswith("launches: ")]))
    resumed = [ln for ln in out.splitlines()
               if ln.startswith("resuming from")]
    run_b = [os.path.join(exp, r) for r in sorted(os.listdir(exp))
             if os.path.join(exp, r) != run_a]
    nxt = f"model_{TRAIN_SCRIPT_ITERS + 1}.pt"
    finite = None
    if len(run_b) == 1 and nxt in os.listdir(run_b[0]):
        ck = torch.load(os.path.join(run_b[0], nxt), map_location="cpu",
                        weights_only=True)
        params = ck["train_state"]["model"]
        finite = all(bool(torch.isfinite(v).all()) for v in params.values()
                     if v.is_floating_point())
    print(f"train script (b): --resume --max_iterations 1 in "
          f"{secs['resume']:.1f} s: {resumed}; runs "
          f"{[os.path.basename(r) for r in run_b]}, {nxt} parameters finite "
          f"{finite}; learn's env-steps/s " + json.dumps(
              _fps_by_iteration(run_b[0]) if len(run_b) == 1 else {}))
    if not (resumed and resumed[0].endswith(os.path.join(run_a, last))):
        bad.append(f"(b) {resumed}")
    if not finite:
        bad.append(f"(b) {nxt} in {run_b}: finite {finite}")

    # (c) play with no --task: the latest checkpoint, exported and rolled
    t = time.perf_counter()
    [out] = run_ranks([[sys.executable, "-m",
                        "go2_rl_gym_tpu_torch.scripts.play", "--log_root",
                        logs]], tag="play")
    secs["play"] = time.perf_counter() - t
    res = json.loads(out.strip().splitlines()[-1])
    rollout = [ln for ln in out.splitlines() if "-step rollout" in ln]
    print(f"train script (c): scripts.play --log_root ... in "
          f"{secs['play']:.1f} s: {rollout}; " + json.dumps(res))
    if len(run_b) == 1 and res["checkpoint"] != os.path.join(run_b[0], nxt):
        bad.append(f"(c) played {res['checkpoint']}")
    if sorted(res["exported"]) != ["jit", "onnx", "pkl"] or not all(
            os.path.getsize(p) > 0 for p in res["exported"].values()):
        bad.append(f"(c) exported {res['exported']}")
    # 250 steps: the init step, then env.step's warm-up and its capture
    if not (res["finite"] and rollout and rollout[0].startswith("250-step")
            and res["launches"]["extract_patches"] == 3):
        bad.append(f"(c) {rollout}, finite {res['finite']}, launches "
                   f"{res['launches']}")
    launches["play"] = res["launches"]["extract_patches"]
    print("train script: seconds " + json.dumps(
        {k: round(v, 1) for k, v in secs.items()}) + "; patch launches "
        f"(want {want} per rank in train and resume, 3 in play) "
        + json.dumps(launches))
    if bad:
        raise AssertionError(f"train script: {bad}")
    return {"extract_patches": sum(launches.values())}


def _worst(got, want, tol, fields):
    """Per field: (max abs error, share of envs beyond `tol`)."""
    out = {}
    for f in fields:
        err = (getattr(got, f) - getattr(want, f)).abs()
        per_env = err.reshape(err.shape[0], -1).amax(dim=1)
        out[f] = (float(per_env.max()), float((per_env > tol[f]).float()
                                              .mean()))
    return out


def phase_engine():
    """The N-major reference engine on the card (see the module
    docstring). Launches no hand-written kernel on its path."""
    import torch
    from go2_rl_gym_tpu_torch.env.config import Go2Cfg
    from go2_rl_gym_tpu_torch.env.go2_env import Go2Env
    from go2_rl_gym_tpu_torch.sim import engine, tengine
    from go2_rl_gym_tpu_torch.tools.profile_rollout import profiled

    cfg = Go2Cfg()
    cfg.env.num_envs = NUM_ENVS
    env = Go2Env(cfg)
    model, params = env.model, env.sim_params
    direct = env.terrain._replace(channels=None)     # the global heightfield
    print(f"engine: flagship heightfield {tuple(direct.height.shape)}, "
          f"{NUM_ENVS} envs")
    spawn = env.init_state(0)
    landed = spawn
    zero = torch.zeros((NUM_ENVS, 12), device="cuda")
    with torch.no_grad():
        for _ in range(ENGINE_SETTLE_STEPS):
            landed, _ = env.step(landed, zero)
    n = ENGINE_CPU_ENVS

    def pd_substeps(step, dyn, s, dev):
        q0 = env.default_dof_pos.to(dev)
        effort = torch.as_tensor(model.dof_effort_limit, dtype=torch.float32,
                                 device=dev)
        kd = torch.full_like(s.q, 0.5)
        for _ in range(4):
            tau = torch.clamp(20.0 * (q0 - s.q) - 0.5 * s.qd, -effort, effort)
            s, out = step(dyn, s, tau, kd)
        return s, out

    def head(tree, dev="cpu"):
        return type(tree)(*[x[:n].to(dev) for x in tree])

    # (a) card vs CPU, landed states
    card_step = engine.make_batched_substep(model, params, direct)
    cpu_step = engine.make_batched_substep(
        model, params, engine.terrain_to(direct, "cpu"), device="cpu")
    with torch.no_grad():
        s_card, o_card = pd_substeps(card_step, landed.dyn, landed.sim,
                                     "cuda")
        s_cpu, o_cpu = pd_substeps(cpu_step, head(landed.dyn),
                                   head(landed.sim), "cpu")
    errs = _worst(head(s_card), s_cpu, SUBSTEP_TOL, SUBSTEP_TOL)
    f_err = max(float(((getattr(head(o_card), k) - getattr(o_cpu, k)).abs()
                       - 1e-4 * getattr(o_cpu, k).abs()).max())
                for k in ("contact_forces", "foot_forces"))
    contact = float(o_cpu.foot_forces[..., 2].sum(dim=1).mean())
    print(f"engine (a): 4 card substeps vs the CPU engine, first {n} of "
          f"{NUM_ENVS} landed envs: max_abs_err "
          + json.dumps({k: v[0] for k, v in errs.items()})
          + f", forces beyond 1e-4 rel by {f_err:.3e} N (tol 1e-3); mean "
          f"foot Fz {contact:.1f} N")
    finite = all(bool(torch.isfinite(x).all()) for x in s_card)
    bad_a = ([k for k, v in errs.items() if v[1] > 0]
             + (["forces"] if f_err > 1e-3 else [])
             + ([] if finite else ["non-finite"]))

    # (b) tengine vs the N-major engine on the card
    p30 = params._replace(solver_iters=30)
    phys = tengine.make_physics_step(model, p30, direct, 4)
    bsub = engine.make_batched_substep(model, p30, direct)
    cpu_phys = tengine.make_physics_step(
        model, p30, engine.terrain_to(direct, "cpu"), 4)
    cpu_bsub = engine.make_batched_substep(
        model, p30, engine.terrain_to(direct, "cpu"), device="cpu")

    def both(phys, bsub, st_dyn, st_sim, dev):
        N = st_sim.q.shape[0]
        targets = env.default_dof_pos.to(dev).expand(4, N, 12)
        kp, kd = (torch.full((N, 12), v, device=dev) for v in (20.0, 0.5))
        ones, zeros = torch.ones_like(kp), torch.zeros_like(kp)
        s_t, o_t, _, _ = phys(st_dyn, st_sim, targets, kp, kd, ones, zeros)
        s_r, o_r = pd_substeps(bsub, st_dyn, st_sim, dev)
        return s_t, o_t, s_r, o_r

    bad_b = []
    for name, st in (("spawn", spawn), ("landed", landed)):
        with torch.no_grad():
            s_t, o_t, s_r, o_r = both(phys, bsub, st.dyn, st.sim, "cuda")
        errs = _worst(s_t, s_r, CROSS_TOL, CROSS_TOL)
        # contact forces: the error beyond 5% of the N-major engine's
        cf = ((o_t.contact_forces - o_r.contact_forces).abs()
              - 0.05 * o_r.contact_forces.abs()).reshape(NUM_ENVS, -1)
        fp = (o_t.foot_pos - o_r.foot_pos).abs().reshape(NUM_ENVS, -1)
        errs["contact_forces"] = (float(cf.max()),
                                  float((cf.amax(1) > 2.0).float().mean()))
        errs["foot_pos"] = (float(fp.max()),
                            float((fp.amax(1) > 1e-3).float().mean()))
        print(f"engine (b) {name}: card tengine step vs 4 card N-major "
              f"substeps (solver_iters 30), {NUM_ENVS} envs: [max_abs_err, "
              f"share of envs beyond the cross-parity tolerance] "
              + json.dumps(errs))
        if name == "spawn":
            bad_b += [f"spawn {k}" for k, v in errs.items() if v[1] > 0]
            continue
        with torch.no_grad():
            c_t, _, c_r, _ = both(cpu_phys, cpu_bsub, head(st.dyn),
                                  head(st.sim), "cpu")
        gap_err = {f: float(((getattr(s_t, f)[:n] - getattr(s_r, f)[:n])
                             .cpu() - (getattr(c_t, f) - getattr(c_r, f)))
                            .abs().max()) for f in SUBSTEP_TOL}
        print(f"engine (b) landed: the engines' difference on the card vs "
              f"on the CPU, first {n} envs: max_abs_err "
              + json.dumps(gap_err))
        bad_b += [f"landed gap {f}" for f, e in gap_err.items()
                  if e > SUBSTEP_TOL[f]]

    # times: the N-major substep and tengine's production step
    dyn, sim = landed.dyn, landed.sim
    tau = torch.zeros((NUM_ENVS, 12), device="cuda")
    kp, kd = (torch.full((NUM_ENVS, 12), v, device="cuda") for v in (20.0, 0.5))
    targets = env.default_dof_pos.expand(4, NUM_ENVS, 12)
    ones, zeros = torch.ones_like(kd), torch.zeros_like(kd)
    with torch.no_grad():
        e_ms, e_launch, e_busy = profiled(lambda: card_step(dyn, sim, tau, kd))
        t_ms, t_launch, t_busy = profiled(lambda: env.physics_step(
            dyn, sim, targets, kp, kd, ones, zeros))
    print(f"engine timing, {NUM_ENVS} envs, landed states: N-major substep "
          f"(solver_iters {params.solver_iters}) {e_ms:.3f} ms host, "
          f"{e_launch} launches, {e_busy:.3f} ms device busy; tengine "
          f"physics step (4 substeps + 1 patch extraction) {t_ms:.3f} ms "
          f"host, {t_launch} launches, {t_busy:.3f} ms device busy = per "
          f"substep {t_ms / 4:.3f} ms host, {t_launch / 4:.1f} launches, "
          f"{t_busy / 4:.3f} ms busy")
    if bad_a or bad_b:
        raise AssertionError(f"engine: (a) {bad_a} (b) {bad_b}")


def phase_profile():
    """The op tables and the stage decomposition of
    go2_rl_gym_tpu_torch/tools/profile_rollout.py, after a profiled CUDA
    graph replay in this process (see the module docstring). Returns the
    phase's patch launches."""
    import torch
    from go2_rl_gym_tpu_torch.tools import profile_rollout as pr
    from go2_rl_gym_tpu_torch.tools import trace_window

    reset_launch_counts()
    setup = pr.build("physics", NUM_ENVS, "cuda")
    t = time.perf_counter()
    graph, graph_runner = trace_window.capture(setup)
    replay = trace_window.profile_replay(graph, setup.env.device)
    print(f"profile: one profiled replay of the go2_moe_cts train graph "
          f"(captured with deterministic algorithms on, its window opened "
          f"after one more replay as its lead-in): {replay['kernels']} "
          f"kernels, {replay['lost']} launches whose kernel the trace "
          f"lacks; {time.perf_counter() - t:.1f} s with the warm-up and the "
          f"capture; the op tables follow in this process")
    bad = [] if replay["lost"] == 0 else [
        f"the profiled replay lost {replay['lost']} launches"]
    for mode in ("physics", "substep", "env"):
        setup = pr.build(mode, NUM_ENVS, "cuda", like=setup)
        res = pr.op_table(setup, iters=PROFILE_ITERS, top=PROFILE_TOP)
        rows = res["rows"]
        patch = [r for r in rows if r["name"] == "extract_patches"]
        print(f"profile {mode}: {res['total_ms']:.3f} ms of self device time "
              f"per call, profiler kernel sum {res['kernel_ms']:.3f} ms, "
              f"{res['attributed_share']:.4f} of it with a port source line, "
              f"{res['launches_per_call']:.1f} launches per call, "
              f"{len(rows)} rows; patch kernel launches "
              f"{res['patch_kernel_launches']}, its rows "
              + json.dumps(patch) + f"; traced in {res['trace_s']:.1f} s, "
              f"reduced in {res['reduce_s']:.1f} s")
        for by, key in (("file", lambda r: r["source"].split(":")[0]),
                        ("op", lambda r: r["name"])):
            share = {}
            for r in rows:
                share[key(r)] = share.get(key(r), 0.0) + r["pct"]
            top = sorted(share.items(), key=lambda kv: -kv[1])[:6]
            print(f"profile {mode}: percent by {by} "
                  + json.dumps({k: round(v, 2) for k, v in top}))
        if not abs(res["total_ms"] - res["kernel_ms"]) <= 0.01 * res[
                "kernel_ms"]:
            bad.append(f"{mode}: table total {res['total_ms']} ms vs kernel "
                       f"sum {res['kernel_ms']} ms")
        if mode == "substep":
            if res["patch_kernel_launches"] or patch:
                bad.append("substep launched the patch kernel")
            continue
        if res["attributed_share"] < 0.9:
            bad.append(f"{mode}: {res['attributed_share']} attributed")
        if [(r["calls"], r["launches"]) for r in patch] != [(1.0, 1.0)] or (
                res["patch_kernel_launches"] != PROFILE_ITERS):
            bad.append(f"{mode}: extract_patches rows {patch}")
    del graph, graph_runner
    gc.collect()
    torch.cuda.empty_cache()
    dec = pr.decompose(["physics", "env", "rollout", "train"], NUM_ENVS,
                       "cuda", iters=DECOMPOSE_ITERS, like=setup)
    print("profile decompose: " + json.dumps(dec))
    bad += [f"decompose {k}: {v['ms']} ms" for k, v in dec["decompose"].items()
            if not (math.isfinite(v["ms"]) and v["ms"] > 0)]
    if bad:
        raise AssertionError(f"profile: {bad}")
    return launch_counts()


def phase_graft():
    """entry() on the card vs the CPU, and the NCCL dry run (see the module
    docstring). Returns the ranks' patch launches, summed."""
    import torch
    from go2_rl_gym_tpu_torch import graft_entry

    forward, (model, obs, hist) = graft_entry.entry()
    _, (cpu_model, _, _) = graft_entry.entry(device="cpu")
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    g = torch.Generator().manual_seed(0)
    o = torch.randn(obs.shape, generator=g)
    h = torch.randn(hist.shape, generator=g)
    mu = forward(model, o.cuda(), h.cuda())
    err = float((mu.cpu() - forward(cpu_model, o, h)).abs().max())
    fwd_ms = cuda_ms(lambda: forward(model, obs, hist))
    print(f"graft entry: moe_cts student forward at batch {obs.shape[0]}, "
          f"card vs CPU max_abs_err {err:.3e} (tol 1e-5); {fwd_ms:.4f} ms "
          f"on the card (CUDA events)")
    if not err <= 1e-5:
        raise AssertionError("graft entry: card and CPU disagree")
    world = torch.cuda.device_count()
    t = time.perf_counter()
    res = graft_entry.dryrun_multichip(world)
    launches = [r["launches"]["extract_patches"] for r in res]
    graphed = [r["graphed"] for r in res]
    print(f"graft dryrun: nccl world {world}, "
          f"{max(8 * world, 16) // world} envs per rank, 2 x 9 terrain, "
          f"{graft_entry.DRYRUN_STEPS} steps, {time.perf_counter() - t:.1f} "
          f"s with start-up; the compiled step graphed per rank {graphed} "
          f"(mode {res[0]['mode']}), called twice (warm-up + capture, one "
          f"replay); patch launches per rank {launches}; metrics "
          + json.dumps({k: round(float(res[0]["metrics"][k]), 6) for k in
                        ("value_loss", "surrogate_loss", "latent_loss")}))
    if not all(graphed):
        raise AssertionError(f"graft dryrun: not graphed {graphed}")
    # the warm-up and the capture each launch once per policy step, the
    # replay not at all
    if launches != [2 * graft_entry.DRYRUN_STEPS] * world:
        raise AssertionError(f"graft dryrun: patch launches {launches}")
    return {"extract_patches": sum(launches)}


def main():
    sys.path.insert(0, ROOT)
    # cuBLAS's deterministic workspace, for phase train graph's
    # deterministic eager runs; set before the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    try:
        from go2_rl_gym_tpu_torch.ops import cuda_build
        modules = kernel_modules()
    except ImportError as e:
        fail(f"the port is not importable next to this script: {e}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    print(card)
    print(json.dumps({"python": sys.version.split()[0],
                      "torch": torch.__version__, "cuda": torch.version.cuda}))

    failures = []
    results = {}
    t0 = time.perf_counter()
    try:
        for m in modules:
            log = cuda_build.build(m.SOURCE)
            print(f"nvcc {m.SOURCE}: "
                  + (" | ".join(log.strip().splitlines()) or "cached"))
        print(f"built in {time.perf_counter() - t0:.1f} s")
    except Exception:   # a failed build fails every kernel phase
        traceback.print_exc()
        fail("kernel build failed")

    phases = [("patch kernel", lambda: phase_patch_kernel(results)),
              ("card vs CPU", phase_cpu_agreement),
              ("play", phase_play),
              ("rollout", phase_rollout),
              ("train", phase_train),
              ("train go2", lambda: phase_train("go2")),
              ("train go2_lstm", lambda: phase_train("go2_lstm")),
              ("train go2_fast_flat_move",
               lambda: phase_train("go2_fast_flat_move", iterations=1)),
              ("train graph", phase_train_graph),
              ("bench", phase_bench),
              ("export + eval", phase_export_eval),
              ("train script", phase_train_script),
              ("train ddp", phase_train_ddp),
              ("train ddp graph", phase_train_ddp_graph),
              ("engine", phase_engine),
              ("profile", phase_profile),
              ("graft", phase_graft)]
    launches = {}
    for name, fn in phases:
        t = time.perf_counter()
        try:
            counts = fn()
            if counts:
                for k, v in counts.items():
                    launches[k] = launches.get(k, 0) + v
                    results.setdefault(k, {}).setdefault(
                        "launches_by_phase", {})[name] = v
        except Exception:   # record the phase's failure, go on to the next
            traceback.print_exc()
            failures.append(name)
        print(f"phase {name}: {time.perf_counter() - t:.1f} s"
              f"{' FAILED' if name in failures else ''}")
        sys.stdout.flush()

    kernels = sorted(launch_counts())
    for k in kernels:
        if k not in results or "name" not in results[k]:
            failures.append(f"kernel {k} not measured")
        elif launches.get(k, 0) == 0:
            failures.append(f"kernel {k} never launched on the main path")
        results.setdefault(k, {})["launches"] = launches.get(k, 0)
    if failures:
        fail(f"failed: {failures}")

    print(json.dumps({"kernels": [results[k] for k in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
