"""Port parity: the io sites' conv, ``qdq_conv2d`` (act snap, dense f32
conv, bias), against the composition it replaces and against the JAX
package's ``conv2d_apply`` on a dense weight (the kernel on the card:
tests/test_torch_gpu.py).

Tolerance against JAX: rtol = atol = 1e-5, the order of the f32 sums being
the only difference (the act snap is bit-exact with the interpret-mode
Pallas K1). Against the old composition: bit for bit."""
import jax
import numpy as np
import pytest
import torch

import repro.kernels.ops as jops
from _torch_parity import jx, t, t_qp
from repro.nn import layers as jlayers
from repro.quant import fakequant as jfq
from repro_torch.kernels import build
from repro_torch.kernels import msfp_quant as k1
from repro_torch.kernels import ops
from repro_torch.kernels.conv import conv2d_nhwc
from repro_torch.nn import layers as tlayers

TOL = dict(rtol=1e-5, atol=1e-5)
S, U, INT = jfq.KIND_FP_SIGNED, jfq.KIND_FP_UNSIGNED, jfq.KIND_INT_AFFINE


@pytest.fixture
def interpret_kernels():
    """The JAX package's Pallas kernels in interpret mode."""
    old = jops.FORCE
    jops.FORCE = "interpret"
    yield
    jops.FORCE = old


def _act_qp(kind):
    """E2M1 at maxval 6 (the main path), uE2M2 with zp -0.28 (its snap of
    0 is not 0, so the pads must be zeroed after it), or acts off."""
    if kind == S:
        return jfq.QuantizerParams(S, 2, 1, 4, np.float32(6.0))
    if kind == U:
        return jfq.QuantizerParams(U, 2, 2, 4, np.float32(3.0),
                                   np.float32(-0.28))
    return None


def _case(rng, b, hw, cin, cout, k, bias=True):
    x = (rng.normal(size=(b, *hw, cin)) * 2).astype(np.float32)
    w = (rng.normal(size=(k, k, cin, cout)) * (k * k * cin) ** -0.5).astype(
        np.float32)
    w_bf16 = torch.from_numpy(w).bfloat16()
    bvec = (rng.normal(size=(cout,)) * 0.1).astype(np.float32) if bias \
        else None
    return x, w_bf16, bvec


# (b, (h, w), cin, cout, k): tiny_ddim's io sites (conv_in 3->16, conv_out
# 16->3 at 8x8, B 2), a ragged image and 1x1 kernels
SHAPES = [(2, (8, 8), 3, 16, 3), (2, (8, 8), 16, 3, 3),
          (1, (7, 9), 16, 3, 3), (2, (5, 6), 3, 16, 1), (2, (8, 8), 16, 3, 1)]


@pytest.mark.parametrize("kind", [S, U, None])
@pytest.mark.parametrize("b,hw,cin,cout,k", SHAPES)
def test_plain_is_the_old_composition(rng, b, hw, cin, cout, k, kind):
    x, w, bvec = _case(rng, b, hw, cin, cout, k)
    qp = None if kind is None else t_qp(_act_qp(kind))
    xt, bt = t(x), t(bvec)
    got = k1.qdq_conv2d_plain(xt, w, qp, bt, padding="SAME")
    xq = xt if qp is None else ops.msfp_quantize(xt, qp)
    want = conv2d_nhwc(xq, w.to(torch.float32), stride=(1, 1),
                       padding="SAME") + bt
    assert torch.equal(got, want)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("kind", [S, U, None])
@pytest.mark.parametrize("b,hw,cin,cout,k", SHAPES)
def test_conv2d_apply_matches_jax(rng, interpret_kernels, b, hw, cin, cout,
                                  k, kind, bias):
    """The port's ``conv2d_apply`` on a dense bf16 weight (one
    ``qdq_conv2d`` call, its plain version here) against the reference's,
    whose act snap is the interpret-mode Pallas K1 and whose conv is
    XLA's."""
    x, w, bvec = _case(rng, b, hw, cin, cout, k, bias)
    jq = _act_qp(kind)
    jp = {"w": jax.numpy.asarray(w.float().numpy()).astype(
        jax.numpy.bfloat16)}
    tp = {"w": w}
    if bias:
        jp["b"], tp["b"] = jx(bvec), t(bvec)
    want = jax.jit(lambda p, x: jlayers.conv2d_apply(p, x, act_qp=jq))(
        jp, jx(x))
    ops.reset_routes()
    got = tlayers.conv2d_apply(tp, t(x), act_qp=None if jq is None
                               else t_qp(jq))
    assert dict(ops.ROUTES) == {("conv2d", "plain"): 1}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_pads_are_exact_zero_after_an_unsigned_snap():
    """Quantize, then pad: over an all-zero image an unsigned snap with
    zp != 0 gives every pixel s = snap(0) != 0, and a 3x3 all-ones conv
    then sums 4 of them at a corner, 6 on an edge and 9 inside."""
    qp = t_qp(_act_qp(U))
    s = float(k1.msfp_qdq(torch.zeros(1), qp))
    assert s != 0.0
    y = k1.qdq_conv2d(torch.zeros(1, 4, 5, 1), torch.ones(3, 3, 1, 1), qp,
                      None)[0, :, :, 0]
    assert float(y[0, 0]) == 4 * s and float(y[0, 2]) == 6 * s
    assert float(y[1, 2]) == 9 * s and float(y[3, 4]) == 4 * s


def test_dense_conv2d_routes(rng):
    """Covered calls take ``qdq_conv2d`` (``plain`` on the CPU); stride 2,
    an INT-affine act, bf16 acts and a band too wide for shared memory keep
    the old composition (a standalone snap, then ``torch_f32``)."""
    x, w, bvec = _case(rng, 2, (8, 8), 16, 3, 3)
    xt, bt = t(x), t(bvec)
    qp = t_qp(_act_qp(S))
    ops.reset_routes()
    covered = ops.dense_conv2d(xt, w, qp, bt)
    assert dict(ops.ROUTES) == {("conv2d", "plain"): 1}

    ops.reset_routes()
    strided = ops.dense_conv2d(xt, w, qp, bt, stride=2)
    assert dict(ops.ROUTES) == {("msfp_quantize", "plain"): 1,
                                ("conv2d", "torch_f32"): 1}
    want = conv2d_nhwc(k1.msfp_qdq(xt, qp), w.float(), stride=(2, 2),
                       padding="SAME") + bt
    assert torch.equal(strided, want)

    ops.reset_routes()
    intq = t_qp(jfq.QuantizerParams(INT, 0, 0, 4, np.float32(3.0),
                                    np.float32(0.0)))
    ops.dense_conv2d(xt, w, intq, bt)
    ops.dense_conv2d(xt.bfloat16(), w, None, None)
    assert dict(ops.ROUTES) == {("msfp_quantize", "ref"): 1,
                                ("conv2d", "torch_f32"): 2}

    # the covered route and the composition agree bit for bit on the CPU
    ops.reset_routes()
    assert torch.equal(covered, conv2d_nhwc(
        k1.msfp_qdq(xt, qp), w.float(), stride=(1, 1), padding="SAME") + bt)

    wide = torch.zeros(3, 3, 4096, 4, dtype=torch.bfloat16)
    assert not k1.io_conv_fits((1, 32, 32, 4096), tuple(wide.shape))
    ops.dense_conv2d(torch.zeros(1, 32, 32, 4096), wide)
    assert dict(ops.ROUTES) == {("conv2d", "torch_f32"): 1}


def test_io_conv_layout_at_the_io_sites():
    """Full width (ddim-cifar10, 32x32): conv_in 3 -> 128 takes the wide
    kernel, conv_out 128 -> 3 the narrow one with 16-byte reads; a 2-row
    band of conv_out needs 69.8 KB of halo, so above 48 KB of dynamic
    shared memory."""
    cin_ = k1.io_conv_layout(32, 32, 3, 128, 3)
    assert cin_ == k1.IoConvLayout(2, 3, 27, 4 * (408 + 27 * 128 + 128))
    out_ = k1.io_conv_layout(32, 32, 128, 3, 3)
    assert out_ == k1.IoConvLayout(2, 132, 1156,
                                  4 * (4 * 34 * 132 + 3 * 1156 + 4))
    assert 48 * 1024 < out_.smem <= build.BLOCK_SMEM_LIMIT
    assert (out_.cs // 4) % 2 == 1 and (out_.ks // 4) % 2 == 1
    assert k1.io_conv_layout(1, 32, 128, 3, 3).rows == 1


def test_cuda_wrapper_refuses_cpu_tensors(rng):
    x, w, bvec = _case(rng, 1, (4, 4), 3, 16, 3)
    with pytest.raises(ValueError, match="CUDA"):
        k1.qdq_conv2d_cuda(t(x), w, None, t(bvec))
