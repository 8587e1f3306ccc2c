"""Port parity: K2/K3 plain versions vs the interpret-mode Pallas kernels,
the conv geometry and ops dispatch (each CUDA kernel vs its plain version
on the card: tests/test_torch_gpu.py).

K2/K3 tolerance: rtol = atol = 1e-5, the order of the f32 sums being the
only difference (both add an unsigned weight's zero-point as the rank-1
term zp_n * sum_k x_q[i, k])."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from _torch_parity import jx, t, t_packed, t_qp
from repro.core import qmodule as jq
from repro.kernels import conv as jk3
from repro.kernels import w4_matmul as jk2
from repro.quant import fakequant as jfq
from repro_torch.core import qmodule as tq
from repro_torch.kernels import conv as tk3
from repro_torch.kernels import ops as tops
from repro_torch.kernels import w4_matmul as tk2
from repro_torch.quant import fakequant as tfq

TOL = dict(rtol=1e-5, atol=1e-5)
S, U = jfq.KIND_FP_SIGNED, jfq.KIND_FP_UNSIGNED


def _weight_qp(kind, w, per_channel):
    n = w.shape[-1]
    mv = (np.abs(w).reshape(-1, n).max(0) if per_channel
          else np.float32(np.abs(w).max())).astype(np.float32)
    if kind == S:
        return jfq.QuantizerParams(S, 2, 1, 4, jnp.asarray(mv))
    return jfq.QuantizerParams(U, 2, 2, 4, jnp.asarray(mv * 1.2),
                               jnp.float32(-0.3 * float(np.max(mv))))


def _act_qp(kind):
    if kind == S:
        return jfq.QuantizerParams(S, 2, 1, 4, jnp.float32(2.5))
    return jfq.QuantizerParams(U, 2, 2, 4, jnp.float32(2.5),
                               jnp.float32(-0.28))


MATMUL_CASES = [  # (w kind, per-channel, act kind or None, m, k, n)
    (S, False, S, 7, 96, 64), (S, True, U, 33, 130, 66),
    (U, True, U, 17, 72, 48), (S, False, None, 9, 130, 66),
    (U, False, None, 1, 64, 34)]


@pytest.mark.parametrize("wk,pc,ak,m,k,n", MATMUL_CASES)
def test_k2_plain_matches_interpret_kernel(wk, pc, ak, m, k, n, rng):
    w = rng.normal(size=(k, n)).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32) * 1.5
    jpw = jq.pack_weight(jx(w), _weight_qp(wk, w, pc))
    tpw = t_packed(jpw)
    fmt = dict(exp_bits=jpw.exp_bits, man_bits=jpw.man_bits,
               signed=jpw.signed)
    if ak is None:
        want = jk2.w4_matmul_2d(jx(x), jpw.packed, jpw.scale, jpw.zero_point,
                                interpret=True, **fmt)
        got = tk2.w4_matmul_2d(t(x), tpw.packed, tpw.scale, tpw.zero_point,
                               None, **fmt)
    else:
        aq = _act_qp(ak)
        want = jk2.w4a4_matmul_2d(
            jx(x), jpw.packed, jpw.scale, jpw.zero_point, aq.maxval,
            aq.zero_point, act_exp_bits=aq.exp_bits, act_man_bits=aq.man_bits,
            act_signed=ak == S, interpret=True, **fmt)
        ta = t_qp(aq)
        got = tk2.w4a4_matmul_2d(
            t(x), tpw.packed, tpw.scale, tpw.zero_point, ta.maxval,
            ta.zero_point, act_exp_bits=aq.exp_bits, act_man_bits=aq.man_bits,
            act_signed=ak == S, **fmt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


CONV_CASES = [  # (w kind, per-channel, act kind, k, stride, hw, cin, cout)
    (S, False, S, 3, 1, 8, 8, 16), (S, True, U, 3, 2, 8, 8, 12),
    (U, False, U, 3, 2, 9, 6, 8), (U, True, S, 1, 1, 5, 16, 8)]


@pytest.mark.parametrize("wk,pc,ak,k,s,hw,cin,cout", CONV_CASES)
def test_k3_plain_matches_interpret_kernel(wk, pc, ak, k, s, hw, cin, cout,
                                           rng):
    w = (rng.normal(size=(k, k, cin, cout)) * 0.3).astype(np.float32)
    x = rng.normal(size=(2, hw, hw, cin)).astype(np.float32)
    jpw = jq.pack_weight(jx(w), _weight_qp(wk, w, pc))
    aq = None if ak is None else _act_qp(ak)
    want = jk3.w4a4_conv2d_implicit(jx(x), jpw, aq, stride=(s, s),
                                    padding="SAME", interpret=True)
    got = tk3.w4a4_conv2d_implicit(t(x), t_packed(jpw),
                                   None if aq is None else t_qp(aq),
                                   stride=(s, s), padding="SAME")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if ak != U:   # the im2col route fuses signed acts only
        via_k2 = tk3.w4a4_conv2d_im2col(t(x), t_packed(jpw),
                                        None if aq is None else t_qp(aq),
                                        stride=(s, s), padding="SAME")
        np.testing.assert_allclose(via_k2.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("hw,k,s,pad", [
    (32, 3, 2, "SAME"), (31, 3, 2, "SAME"), (8, 3, 1, "SAME"),
    (8, 1, 1, "SAME"), (9, 3, 2, "VALID"), (7, 3, 1, ((2, 0), (1, 1)))],
    ids=str)
def test_conv_pads_follow_lax(hw, k, s, pad, rng):
    assert tk3.conv_pads(hw, hw, k, k, (s, s), pad) == \
        jk3.conv_pads(hw, hw, k, k, (s, s), pad)
    x = rng.normal(size=(1, hw, hw, 3)).astype(np.float32)
    w = rng.normal(size=(k, k, 3, 4)).astype(np.float32)
    want = lax.conv_general_dilated(jx(x), jx(w), (s, s), pad,
                                    dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = tk3.conv2d_nhwc(t(x), t(w), stride=(s, s), padding=pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jp, jshape = jk3.im2col(jx(x), k, k, stride=(s, s), padding=pad)
    tp, tshape = tk3.im2col(t(x), k, k, stride=(s, s), padding=pad)
    assert tshape == tuple(jshape)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_ops_routes_follow_reference_rules(rng):
    w = rng.normal(size=(3, 3, 8, 8)).astype(np.float32)
    pw = tq.pack_weight(t(w), tfq.QuantizerParams(S, 2, 1, 4,
                                                  torch.tensor(2.0)))
    x = t(rng.normal(size=(1, 6, 6, 8)).astype(np.float32))
    uq = tfq.QuantizerParams(U, 2, 2, 4, torch.tensor(2.0),
                             torch.tensor(-0.2))
    iq = tfq.QuantizerParams(jfq.KIND_INT_AFFINE, 0, 0, 4, torch.tensor(2.0))
    dense = tq.pack_weight(t(w.reshape(72, 8)),
                           tfq.QuantizerParams(S, 2, 1, 4, torch.tensor(2.0)))
    tops.reset_routes()
    old = tops.CONV_ROUTE
    try:
        tops.w4a4_conv2d(x, pw, uq)                 # implicit fuses unsigned
        tops.CONV_ROUTE = "im2col"
        tops.w4a4_conv2d(x, pw, uq)                 # im2col pre-quantizes
        tops.w4a4_matmul(x.reshape(-1, 72)[:, :72], dense, iq)  # INT -> ref
    finally:
        tops.CONV_ROUTE = old
    assert tops.ROUTES == {("w4a4_conv2d", "plain:implicit"): 1,
                           ("msfp_quantize", "plain"): 1,
                           ("w4a4_conv2d", "plain:im2col"): 1,
                           ("w4a4_matmul", "ref"): 1}


def test_cuda_wrappers_refuse_cpu_tensors(rng):
    w = rng.normal(size=(16, 8)).astype(np.float32)
    pw = tq.pack_weight(t(w), tfq.QuantizerParams(S, 2, 1, 4,
                                                  torch.tensor(2.0)))
    x = t(rng.normal(size=(4, 16)).astype(np.float32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk2.w4_matmul_2d_cuda(x, pw.packed, pw.scale, pw.zero_point, None,
                              exp_bits=2, man_bits=1, signed=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk3.w4a4_conv2d_implicit_cuda(x.reshape(1, 2, 2, 16), pw, None,
                                      stride=(1, 1), padding="SAME")
