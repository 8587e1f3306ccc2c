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


def _bf16_ulps(got, want, mag, k):
    """|got - want| in units of one bf16 ulp at max(|got|, |want|), less
    the f32 sum-order bound 4 * sqrt(k) * 2^-24 * mag (``mag``: the same
    product over |x_q| and |w|), which decides outputs that cancel to near
    zero (chip_smoke.py:check_close allows the same)."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    top = np.maximum(np.abs(g), np.abs(w))
    ulp = np.exp2(np.floor(np.log2(np.maximum(top, 2.0**-126))) - 7)
    order = 4.0 * np.sqrt(k) * 2.0**-24 * np.asarray(mag, np.float64)
    return np.maximum(np.abs(g - w) - order, 0.0) / ulp


BF16_RULE_CASES = [  # ("matmul", m, k, n) or ("conv", k, stride, hw, cin, cout)
    ("matmul", 8, 576, 192), ("matmul", 8, 256, 128),
    ("conv", 3, 1, 6, 32, 16), ("conv", 1, 1, 6, 64, 32)]


@pytest.mark.parametrize("case", BF16_RULE_CASES, ids=str)
def test_bf16_k2_k3_decode_in_f32_like_the_oracle(case, rng):
    """The port's bf16 K2/K3 decode the weight in f32, as the oracles
    ``ref_w4a4_matmul`` / ``ref_w4a4_conv2d`` do: they agree up to bf16
    output-rounding ties (at most one bf16 ulp, on under 1% of outputs).
    The Pallas kernels round the decoded weight to x.dtype before the dot
    (src/repro/kernels/w4_matmul.py:124, conv.py:207), so in bf16 they
    differ from both, on over 1% of the outputs and over four times as
    many as the oracle's ties; the port does not follow them. The acts take the
    main path's E2M1 snap at maxval 6, whose scale is exactly 1, so both
    packages snap bf16 acts alike (at other maxvals XLA's excess precision
    can flip act ties, ROADMAP Queue C, which is not this test's subject)."""
    from repro.kernels import ref as jref
    aq = jfq.QuantizerParams(S, 2, 1, 4, jnp.float32(6.0))
    if case[0] == "matmul":
        _, m, k, n = case
        w = rng.normal(size=(k, n)).astype(np.float32)
        x = rng.normal(size=(m, k)).astype(np.float32) * 1.5
    else:
        _, kk, s, hw, cin, n = case
        w = (rng.normal(size=(kk, kk, cin, n)) * 0.3).astype(np.float32)
        x = rng.normal(size=(2, hw, hw, cin)).astype(np.float32)
    jpw = jq.pack_weight(jx(w), _weight_qp(S, w, False))
    tpw = t_packed(jpw)
    xb = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    fmt = dict(exp_bits=jpw.exp_bits, man_bits=jpw.man_bits, signed=True)
    xq_abs = tfq.apply_qdq(tx, t_qp(aq)).float().abs()
    w_abs = tq.dequant_weight(tpw, torch.float32).reshape(-1, n).abs()
    if case[0] == "matmul":
        oracle = jax.jit(lambda v: jref.ref_w4a4_matmul(
            v, jpw, aq, jnp.bfloat16))(xb)
        pallas = jk2.w4a4_matmul_2d(
            xb, jpw.packed, jpw.scale, jpw.zero_point, aq.maxval,
            aq.zero_point, act_exp_bits=aq.exp_bits,
            act_man_bits=aq.man_bits, act_signed=True, interpret=True, **fmt)
        ta = t_qp(aq)
        got = tk2.w4a4_matmul_2d(
            tx, tpw.packed, tpw.scale, tpw.zero_point, ta.maxval,
            ta.zero_point, act_exp_bits=aq.exp_bits,
            act_man_bits=aq.man_bits, act_signed=True, **fmt)
        mag = xq_abs @ w_abs
    else:
        kw = dict(stride=(s, s), padding="SAME")
        oracle = jax.jit(lambda v: jref.ref_w4a4_conv2d(
            v, jpw, aq, dtype=jnp.bfloat16, **kw))(xb)
        pallas = jk3.w4a4_conv2d_implicit(xb, jpw, aq, interpret=True, **kw)
        got = tk3.w4a4_conv2d_implicit(tx, tpw, t_qp(aq), **kw)
        mag = tk3.conv2d_nhwc(xq_abs, w_abs.reshape(tpw.shape), **kw)
        k = kk * kk * cin
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    to_f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    mag = mag.numpy()
    ulps = _bf16_ulps(got, to_f32(oracle), mag, k)
    assert ulps.max() <= 1.0, float(ulps.max())
    assert np.mean(ulps > 0) < 0.01, float(np.mean(ulps > 0))
    oracle_ties = np.mean(got != to_f32(oracle))
    assert np.mean(got != to_f32(pallas)) > max(0.01, 4 * oracle_ties)


MAIN_PATH_GEMMS = [  # (m, k, n): smollm-135m decode at batch 8, the
    # ddim-cifar10 temb and attention products and its convs' (pixels,
    # kh*kw*cin, cout)
    (8, 576, 576), (8, 576, 192), (8, 576, 1536), (8, 1536, 576),
    (8, 128, 512), (8, 512, 512), (8, 512, 128), (8, 512, 256),
    (2048, 256, 256), (128, 256, 256), (8192, 1152, 128), (2048, 2304, 256),
    (512, 4608, 256), (512, 512, 256), (128, 4608, 256), (1, 1536, 576)]


@pytest.mark.parametrize("m,k,n", MAIN_PATH_GEMMS)
def test_gemm_plan_fills_one_wave_with_non_empty_splits(m, k, n):
    """The split is the smallest k range (at least MIN_STEPS steps) whose
    launch fits one wave of 2 x 132 blocks, and no split is empty."""
    cfg, splits = tk2.gemm_plan(m, n, k)
    assert (cfg, splits) in tk2.gemm_candidates(m, n, k)
    rows, bj, bk, _ = tk2.TILES[cfg]
    assert (cfg == 1) == (m <= 8)
    steps = -(-k // bk)
    per = -(-steps // splits)
    assert (splits - 1) * per < steps <= splits * per   # none empty
    blocks = -(-m // rows) * -(-(n // 2) // bj)
    wave = 2 * tk2.SMS
    assert splits == 1 or blocks * splits <= wave
    if per > tk2.MIN_STEPS[cfg]:   # one step less a split overflows it
        assert blocks * -(-steps // (per - 1)) > max(wave, blocks)


@pytest.mark.parametrize("m,k,n", MAIN_PATH_GEMMS + [(9, 0, 64), (8, 31, 2)])
def test_gemm_candidates_are_the_plans_the_kernel_accepts(m, k, n):
    """Every candidate is a tile m admits and a split count csrc/w4_gemm.cuh
    launches (each split non-empty); no accepted split count is missing."""
    cands = tk2.gemm_candidates(m, n, k)
    assert {c for c, _ in cands} == set(tk2.tiles_for(m))
    for cfg in tk2.tiles_for(m):
        steps = -(-k // tk2.TILES[cfg][2])
        accepted = {s for s in range(1, max(steps, 1) + 1)
                    if steps == 0 or (s - 1) * -(-steps // s) < steps}
        assert {s for c, s in cands if c == cfg} == accepted
