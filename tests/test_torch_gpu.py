"""On the card: each CUDA kernel of the port against its plain version.

Imports no JAX (it runs where only the port is installed), carries the ``gpu``
marker and skips, with its reason, where torch.cuda is unavailable; run it
there with ``python -m pytest -m gpu tests/test_torch_gpu.py``. The
decision is taken inside a fixture, never at import.

Tolerances: K1 bit-exact; K2/K3 rtol = atol = 1e-5, the order of the f32
sums being the only difference."""
import pytest
import torch

from repro_torch.core.qmodule import pack_weight
from repro_torch.kernels import conv as k3
from repro_torch.kernels import msfp_quant as k1
from repro_torch.kernels import ops
from repro_torch.kernels import w4_matmul as k2
from repro_torch.quant.fakequant import QuantizerParams

S, U = 0, 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m gpu)")
    return torch.device("cuda")


TOL = dict(rtol=1e-5, atol=1e-5)


def _qps(kind, w, per_channel, dev):
    red = tuple(range(w.ndim - 1))
    mv = w.abs().amax(red) if per_channel else w.abs().max()
    if kind == S:
        wq = QuantizerParams(S, 2, 1, 4, mv)
        aq = QuantizerParams(S, 2, 1, 4, torch.tensor(2.5))
    else:
        wq = QuantizerParams(U, 2, 2, 4, mv * 1.2, -0.3 * float(mv.max()))
        aq = QuantizerParams(U, 2, 2, 4, torch.tensor(2.5),
                             torch.tensor(-0.28))
    return pack_weight(w, wq).to(dev), aq.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,e,m", [(S, 2, 1), (S, 1, 2), (U, 2, 2),
                                      (U, 3, 1)])
def test_k1_bit_exact(cuda, kind, e, m):
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(4096, 3, generator=g) * 3).to(cuda)
    mv = torch.tensor(2.3, device=cuda)
    zp = torch.tensor(0.0 if kind == S else -0.2, device=cuda)
    kw = dict(exp_bits=e, man_bits=m, signed=kind == S)
    before = k1.msfp_qdq_2d_cuda.launches
    got = k1.msfp_qdq_2d(x, mv, zp, **kw)
    assert k1.msfp_qdq_2d_cuda.launches == before + 1
    assert torch.equal(got, k1.msfp_qdq_2d_plain(x, mv, zp, **kw))


CASES = [  # (kind, per-channel, kh, stride, hw, cin, cout)
    (S, False, 3, 1, 8, 8, 16), (U, True, 3, 2, 8, 8, 12),
    (U, False, 3, 2, 9, 6, 8), (S, True, 1, 1, 5, 16, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,pc,k,s,hw,cin,cout", CASES)
def test_k3_and_k2_match_plain(cuda, kind, pc, k, s, hw, cin, cout):
    g = torch.Generator().manual_seed(2)
    w = torch.randn(k, k, cin, cout, generator=g) * 0.3
    x = torch.randn(2, hw, hw, cin, generator=g).to(cuda)
    pw, aq = _qps(kind, w, pc, cuda)
    kw = dict(stride=(s, s), padding="SAME")
    for act in (aq, None):
        got = k3.w4a4_conv2d_implicit(x, pw, act, **kw)
        want = k3.w4a4_conv2d_implicit_plain(x, pw, act, **kw)
        torch.testing.assert_close(got, want, **TOL)
        if kind == S:   # K2 on the unfolded patches: the im2col route
            got = k3.w4a4_conv2d_im2col(x, pw, act, **kw)
            torch.testing.assert_close(got, want, **TOL)
    x2 = x.reshape(-1, cin)
    p2, _ = _qps(kind, w[0, 0], pc, cuda)
    a2 = (aq.maxval, aq.zero_point, aq.exp_bits, aq.man_bits, kind == S)
    fmt = dict(exp_bits=p2.exp_bits, man_bits=p2.man_bits, signed=p2.signed)
    got = k2.w4_matmul_2d(x2, p2.packed, p2.scale, p2.zero_point, a2, **fmt)
    want = k2.w4_matmul_2d_plain(x2, p2.packed, p2.scale, p2.zero_point, a2,
                                 **fmt)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
def test_ops_on_card_take_kernels_only(cuda):
    g = torch.Generator().manual_seed(3)
    w = torch.randn(3, 3, 8, 8, generator=g)
    pw, aq = _qps(S, w, False, cuda)
    x = torch.randn(1, 6, 6, 8, generator=g).to(cuda)
    ops.reset_routes()
    ops.w4a4_conv2d(x, pw, aq)
    ops.msfp_quantize(x, aq)
    assert set(ops.ROUTES) == {("w4a4_conv2d", "cuda:implicit"),
                               ("msfp_quantize", "cuda")}
