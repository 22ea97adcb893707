"""PyTorch port: `distributed/mesh.all_reduce_autograd` on two gloo ranks.

The forward sums the ranks' inputs; the backward gives each rank the sum of
the ranks' incoming gradients (what the MoE load-balance terms rely on,
agents/cts.py), leaves the input as it was (a strided view included) and
warns of nothing. Without a mesh the input comes back as it is.
"""
import os
import socket
import subprocess
import sys
import textwrap

import torch

from go2_rl_gym_tpu_torch.distributed import mesh as mesh_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 120

RANK = textwrap.dedent("""
    import sys, warnings
    import torch
    from go2_rl_gym_tpu_torch.distributed import mesh as M
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dev = M.initialize_multihost(f"localhost:{port}", 2, rank, device="cpu",
                                 timeout_s=60)
    mesh = M.make_mesh(2, dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        base = (torch.arange(6.0) * (rank + 1)).requires_grad_()
        x = base[::2]                      # a strided view of a leaf
        y = M.all_reduce_autograd(mesh, x)
        g = torch.tensor([1.0, 10.0, 100.0]) * (rank + 1)
        (y * g).sum().backward()
    torch.save({"x": x.detach().clone(), "y": y.detach(), "grad": base.grad,
                "warnings": [str(w.message) for w in caught]},
               f"{out}.{rank}")
    M.shutdown()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_all_reduce_autograd_sums_gradients_over_two_ranks(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    out, port = str(tmp_path / "out"), str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), port, out],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=WAIT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
        assert "deprecat" not in log.lower(), log[-4000:]
    for r in range(2):
        res = torch.load(f"{out}.{r}", weights_only=True)
        assert res["warnings"] == []
        torch.testing.assert_close(res["x"], torch.tensor([0.0, 2.0, 4.0])
                                   * (r + 1), rtol=0, atol=0)
        torch.testing.assert_close(res["y"], torch.tensor([0.0, 6.0, 12.0]),
                                   rtol=0, atol=0)
        # d/dx_r sum_s (y . g_s) = sum_s g_s at the view's elements
        torch.testing.assert_close(
            res["grad"], torch.tensor([3.0, 0.0, 30.0, 0.0, 300.0, 0.0]),
            rtol=0, atol=0)


def test_all_reduce_autograd_without_a_mesh_is_the_identity():
    x = torch.ones(3, requires_grad=True)
    assert mesh_lib.all_reduce_autograd(None, x) is x
