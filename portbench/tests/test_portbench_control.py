"""The control on the card: the plain reference with TF32 on, put in the
program's place, against the sound reference, fails one of the cell's
numbers. At the cell's own size this is `portbench/control.py`; here the
go2_moe_cts cell is cut to 1024 envs so that a test run holds it, and its
limits are those of the full cell."""
import pytest
import torch

from conftest import ROOT
from portbench import compare, control, spec


@pytest.mark.gpu
def test_tf32_control_fails_a_number():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.load_cell(ROOT, "moe_cts.rough.8192")
    cell = cell._replace(traffic=dict(cell.traffic, num_envs=1024))
    got = control.readings(cell, 20260001, torch.device("cuda"),
                           kinds=("tf32",))["tf32"]
    rows = compare.check(got, cell.limits["numbers"])
    assert not all(ok for *_, ok in rows), rows


def test_sound_variants_round_otherwise_and_restore():
    """`reorder` and `fp64_nets` change the reference's rounding and
    nothing more, and put back what they replaced."""
    import torch.nn.functional as F
    from portbench.reference.sim import tmath as tm
    g = torch.Generator().manual_seed(7)
    A = torch.randn(18, 18, 512, generator=g)
    B = torch.randn(18, 18, 512, generator=g)
    v = torch.randn(18, 512, generator=g)
    names = ("dot", "norm", "mv", "mtv", "mm", "mtm", "mmt")
    before = {k: getattr(tm, k) for k in names}
    plain = [tm.dot(v, v), tm.norm(v), tm.mv(A, v), tm.mtv(A, v),
             tm.mm(A, B), tm.mtm(A, B), tm.mmt(A, B)]
    with control.reorder():
        turned = [tm.dot(v, v), tm.norm(v), tm.mv(A, v), tm.mtv(A, v),
                  tm.mm(A, B), tm.mtm(A, B), tm.mmt(A, B)]
    assert {k: getattr(tm, k) for k in names} == before
    for p, t in zip(plain, turned):
        torch.testing.assert_close(t, p, rtol=1e-5, atol=1e-5)
        assert not torch.equal(t, p)
    x, w = torch.randn(64, 48, generator=g), torch.randn(32, 48, generator=g)
    lin, ein = F.linear, torch.einsum
    with control.fp64_nets():
        y = F.linear(x, w)
        e = torch.einsum("ij,kj->ik", x, w)
    assert F.linear is lin and torch.einsum is ein
    assert y.dtype == torch.float32 and e.dtype == torch.float32
    exact = (x.double() @ w.double().T).float()
    assert torch.equal(y, exact) and torch.equal(e, exact)
    torch.testing.assert_close(y, F.linear(x, w), rtol=1e-5, atol=1e-5)
