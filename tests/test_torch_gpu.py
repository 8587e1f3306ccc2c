"""On the card: each CUDA kernel of the port against its plain version.

Imports no JAX (it runs where only the port is installed), carries the ``gpu``
marker and skips, with its reason, where torch.cuda is unavailable; run it
there with ``python -m pytest -m gpu tests/test_torch_gpu.py``. The
decision is taken inside a fixture, never at import.

Tolerances: K1, K4 and K5 bit-exact; K2/K3 rtol = atol = 1e-5, the order
of the f32 sums being the only difference; an LM decode on the card vs the
CPU as in tests/test_torch_lm.py (f32: 1e-4 of max |logit|, same argmax;
bf16: relative Frobenius error 2e-2)."""
import dataclasses

import pytest
import torch

from repro_torch.configs.smollm_135m import smoke as smollm_smoke
from repro_torch.core.qmodule import pack_weight
from repro_torch.kernels import conv as k3
from repro_torch.kernels import kv4 as k45
from repro_torch.kernels import msfp_quant as k1
from repro_torch.kernels import ops
from repro_torch.kernels import w4_matmul as k2
from repro_torch.launch.steps import (dyadic_weights, make_decode_fn,
                                      quantize_lm_for_serving)
from repro_torch.models.lm import init_caches, lm_init
from repro_torch.quant.calibrate import QuantContext
from repro_torch.quant.fakequant import QuantizerParams
from repro_torch.serving.weight_bank import _tree_to

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


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 24, 257, 8192])
def test_k4_k5_bit_exact(cuda, dt, rows):
    g = torch.Generator().manual_seed(4)
    x = (torch.randn(rows, 64, generator=g)
         * torch.rand(rows, 1, generator=g) * 9).to(cuda, dt)
    x[0, :5] = 0.0
    x[0, 5] = -0.0
    before = (k45.kv4_encode_2d_cuda.launches,
              k45.kv4_decode_2d_cuda.launches)
    p, s = ops.kv4_encode(x)
    pp, sp = k45.kv4_encode_2d_plain(x)
    assert torch.equal(p, pp)
    assert torch.equal(s.view(torch.int16), sp.view(torch.int16))
    for odt in (torch.float32, torch.bfloat16):
        got = ops.kv4_decode(p, s, odt)
        want = k45.kv4_decode_2d_plain(p, s, odt)
        assert torch.equal(got.float().view(torch.int32),
                           want.float().view(torch.int32))
    assert (k45.kv4_encode_2d_cuda.launches,
            k45.kv4_decode_2d_cuda.launches) == (before[0] + 1,
                                                 before[1] + 2)


@pytest.mark.gpu
@pytest.mark.parametrize("kv,act,dt", [("fp4", True, torch.float32),
                                       ("bf16", True, torch.float32),
                                       ("fp8", False, torch.float32),
                                       ("fp4", True, torch.bfloat16)])
def test_lm_decode_on_card_matches_cpu(cuda, kv, act, dt):
    """smollm-135m-smoke over packed ``dyadic_weights`` (exact W4A4 sums
    in any order; E2M1 acts fused into K2 where ``act``; an FP8 cache runs
    acts off, as in tests/test_torch_lm.py): 6 teacher-forced steps on the
    card (K2, K4, K5) vs the CPU (their plain versions), both in torch.
    Tolerance: f32, max abs error <= 1e-4 * max |logit| per step and the
    same argmax; bf16, relative Frobenius error <= 2e-2."""
    cfg = dataclasses.replace(smollm_smoke(), kv_dtype=kv, dtype=dt)
    params = quantize_lm_for_serving(dyadic_weights(lm_init(
        torch.Generator().manual_seed(5), cfg)))
    toks = torch.randint(0, cfg.vocab, (3, 6),
                         generator=torch.Generator().manual_seed(6))

    def run(dev):
        ctx = QuantContext("serve", act_qps={"*": QuantizerParams(
            0, 2, 1, 4, torch.tensor(6.0, device=dev))}) if act else None
        p, step = _tree_to(params, dev), make_decode_fn(cfg, ctx=ctx)
        caches = init_caches(cfg, 3, 6, dev)
        return torch.stack([step(p, caches, toks[:, i:i + 1].to(dev), i)[0]
                            .cpu() for i in range(6)]).float()

    ops.reset_routes()
    got = run(cuda)
    routes = {r for (_, r) in ops.ROUTES}
    assert routes == {"cuda", "torch"}, dict(ops.ROUTES)
    want = run(torch.device("cpu"))
    if dt == torch.float32:
        scale = want.abs().amax((1, 2, 3))
        assert ((got - want).abs().amax((1, 2, 3)) <= 1e-4 * scale).all()
        assert torch.equal(got.argmax(-1), want.argmax(-1))
    else:
        rel = torch.linalg.norm(got - want) / torch.linalg.norm(want)
        assert rel <= 2e-2, float(rel)
