"""Port parity: formats, fake-quant, W4 packing and K1's plain version.

Held bit-exact against the JAX package on f32 (round half to even, octave
from the exponent bits, the reference's operation order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, t, t_packed, t_qp
from repro.core import qmodule as jq
from repro.kernels import msfp_quant as jk1
from repro.quant import fakequant as jfq
from repro.quant import formats as jfmt
from repro_torch.core import qmodule as tq
from repro_torch.kernels import msfp_quant as tk1
from repro_torch.kernels import ops as tops
from repro_torch.quant import fakequant as tfq
from repro_torch.quant import formats as tfmt

ALL_FORMATS = sorted(tfmt.FORMAT_BY_NAME)
EXACT_FORMATS = [n for n in ALL_FORMATS
                 if tfmt.FORMAT_BY_NAME[n].exp_bits <= 3]
WIDE_FORMATS = [n for n in ALL_FORMATS
                if tfmt.FORMAT_BY_NAME[n].exp_bits > 3]


def _probe(fmt, maxval, zp=0.0, seed=0):
    """Random values plus every grid point, every midpoint between grid
    neighbours and their one-ulp neighbours, mapped to the scaled grid."""
    rng = np.random.default_rng(seed)
    grid = np.unique(np.abs(tfmt.enumerate_grid(fmt)))
    mids = (grid[1:] + grid[:-1]) / 2
    pts = np.concatenate([grid, mids, [fmt.base_max * 1.5, 1e-9, 0.0]])
    scale = np.float32(maxval) / np.float32(fmt.base_max)
    y = (pts * scale).astype(np.float32)
    y = np.concatenate([y, np.nextafter(y, np.float32(np.inf)),
                        np.nextafter(y, np.float32(-np.inf))])
    x = np.concatenate([y, -y, rng.normal(size=512).astype(np.float32)
                        * np.float32(maxval)])
    return (x + np.float32(zp)).astype(np.float32)


def test_format_registry_matches_reference():
    assert sorted(jfmt.FORMAT_BY_NAME) == ALL_FORMATS
    for name in ALL_FORMATS:
        j, p = jfmt.FORMAT_BY_NAME[name], tfmt.FORMAT_BY_NAME[name]
        assert (j.exp_bits, j.man_bits, j.signed) == \
            (p.exp_bits, p.man_bits, p.signed)
        assert j.base_max == p.base_max
        np.testing.assert_array_equal(jfmt.enumerate_grid(j),
                                      tfmt.enumerate_grid(p))
        np.testing.assert_array_equal(jfmt.quant_codes(j),
                                      tfmt.quant_codes(p))


# The reference as it serves: jitted, maxval traced (XLA then divides by
# the constant base_max as a multiply by its reciprocal; grid_scale).
_jit_fp_qdq = jax.jit(jfq.fp_qdq, static_argnums=(1,))


@pytest.mark.parametrize("name", EXACT_FORMATS)
def test_fp_qdq_bit_exact(name):
    fmt = tfmt.FORMAT_BY_NAME[name]
    jf = jfmt.FORMAT_BY_NAME[name]
    for maxval, zp in ((2.3, 0.0), (0.7, -0.15), (6.0, 0.25)):
        zp = 0.0 if fmt.signed else zp
        x = _probe(fmt, maxval, zp)
        want = np.asarray(_jit_fp_qdq(jx(x), jf, jnp.float32(maxval),
                                      jnp.float32(zp)))
        got = tfq.fp_qdq(t(x), fmt, torch.tensor(maxval),
                         torch.tensor(zp)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", WIDE_FORMATS)
def test_snap_on_grid_for_wide_exponents(name):
    """For exp_bits > 3 the reference's exp2 is inexact at large octaves;
    the port is held to the grid itself: every snap lands on a grid point
    and on one nearest to its input."""
    fmt = tfmt.FORMAT_BY_NAME[name]
    grid = np.unique(np.abs(tfmt.enumerate_grid(fmt)))
    y = np.abs(_probe(fmt, fmt.base_max)).astype(np.float32)
    q = tfmt.snap_to_base_grid(t(y), fmt).numpy().astype(np.float64)
    assert np.isin(q, grid).all()
    nearest = grid[np.argmin(np.abs(y[:, None] - grid[None, :]), axis=1)]
    np.testing.assert_array_equal(np.abs(y - q), np.abs(y - nearest))


def test_int_qdq_and_range_match_reference(rng):
    x = rng.normal(size=300).astype(np.float32)
    for sym in (True, False):
        want = np.asarray(jfq.int_qdq(jx(x), 4, jnp.float32(1.7),
                                      jnp.float32(-0.3), symmetric=sym))
        got = tfq.int_qdq(t(x), 4, 1.7, -0.3, symmetric=sym).numpy()
        np.testing.assert_array_equal(got, want)
    qp = tfq.QuantizerParams(tfq.KIND_FP_UNSIGNED, 2, 2, 4,
                             torch.tensor(2.0), torch.tensor(-0.25))
    lo, hi = tfq.quantizer_range(qp)
    assert float(lo) == -0.25 and float(hi) == 1.75


CASES = [  # (kind, e, m, per_channel)
    (jfq.KIND_FP_SIGNED, 2, 1, False), (jfq.KIND_FP_SIGNED, 1, 2, True),
    (jfq.KIND_FP_SIGNED, 3, 0, False), (jfq.KIND_FP_SIGNED, 0, 3, True),
    (jfq.KIND_FP_UNSIGNED, 2, 2, False), (jfq.KIND_FP_UNSIGNED, 1, 3, True),
    (jfq.KIND_FP_UNSIGNED, 3, 1, True)]


@pytest.mark.parametrize("kind,e,m,per_channel", CASES)
@pytest.mark.parametrize("shape", [(48, 24), (3, 3, 8, 6)], ids=str)
def test_pack_weight_bytes_identical(kind, e, m, per_channel, shape, rng):
    w = rng.normal(size=shape).astype(np.float32)
    n = shape[-1]
    mv = (np.abs(w).reshape(-1, n).max(0) * 0.9 if per_channel
          else np.float32(np.abs(w).max() * 0.8)).astype(np.float32)
    zp = np.float32(-0.4 if kind == jfq.KIND_FP_UNSIGNED else 0.0)
    jqp = jfq.QuantizerParams(kind, e, m, 4, jnp.asarray(mv), jnp.float32(zp))
    jpw = jq.pack_weight(jx(w), jqp)
    tpw = tq.pack_weight(t(w), t_qp(jqp))
    assert tpw.shape == tuple(jpw.shape)
    np.testing.assert_array_equal(tpw.packed.numpy(), np.asarray(jpw.packed))
    np.testing.assert_array_equal(tpw.scale.numpy(), np.asarray(jpw.scale))
    np.testing.assert_array_equal(tpw.zero_point.numpy(),
                                  np.asarray(jpw.zero_point))
    want = np.asarray(jax.jit(lambda p: jq.dequant_weight(p, jnp.float32))(
        jpw))
    got = tq.dequant_weight(t_packed(jpw), torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


def test_pack_weight_wide_exponent_held_to_grid(rng):
    """uE4M0 is the one 4-bit format with exp_bits > 3: the reference's
    exp2(13) is 8192.004 on XLA CPU, so it is held to the grid instead of
    to the reference's bytes: every decoded value is a scaled grid point
    nearest to its input."""
    fmt = tfmt.FPFormat(4, 0, False)
    w = np.abs(rng.normal(size=(40, 16))).astype(np.float32) * 3000
    w[0, :8] = [1.5 * 2.0**k for k in range(6, 14)]   # exact ties
    qp = tfq.QuantizerParams(tfq.KIND_FP_UNSIGNED, 4, 0, 4,
                             torch.tensor(fmt.base_max))
    got = tq.dequant_weight(tq.pack_weight(t(w), qp), torch.float32).numpy()
    grid = np.unique(tfmt.enumerate_grid(fmt))
    assert np.isin(got, grid).all()
    nearest = grid[np.argmin(np.abs(w.reshape(-1, 1) - grid), axis=1)]
    np.testing.assert_array_equal(np.abs(w - got).ravel(),
                                  np.abs(w.ravel() - nearest))


def test_quantize_param_tree_packs_planned_4bit_sites(rng):
    from repro_torch.core.msfp import QuantPlan, SiteInfo
    w = {"a": {"w": t(rng.normal(size=(8, 6)).astype(np.float32)),
               "b": torch.zeros(6)},
         "io": {"w": t(rng.normal(size=(8, 6)).astype(np.float32))}}
    qp4 = tfq.QuantizerParams(tfq.KIND_FP_SIGNED, 2, 1, 4, torch.tensor(2.0))
    qp8 = tfq.QuantizerParams(tfq.KIND_FP_SIGNED, 4, 3, 8, torch.tensor(2.0))
    plan = QuantPlan({"a/w": SiteInfo(qp4, True, False, 0.0),
                      "io/w": SiteInfo(qp8, True, False, 0.0)}, 4, 4, "msfp")
    out = tq.quantize_param_tree(w, plan)
    assert isinstance(out["a"]["w"], tq.PackedW4)
    assert torch.equal(out["a"]["w"].packed,
                       tq.pack_weight(w["a"]["w"], qp4).packed)
    assert out["io"]["w"] is w["io"]["w"] and out["a"]["b"] is w["a"]["b"]


def test_nibble_layout_is_split_half():
    codes = torch.arange(8, dtype=torch.uint8).reshape(1, 8)
    packed = tq.pack_nibbles(codes)
    assert packed.tolist() == [[0x40, 0x51, 0x62, 0x73]]
    assert torch.equal(tq.unpack_nibbles(packed), codes)


K1_CASES = [(jfq.KIND_FP_SIGNED, 2, 1), (jfq.KIND_FP_SIGNED, 1, 2),
            (jfq.KIND_FP_SIGNED, 3, 0), (jfq.KIND_FP_SIGNED, 0, 3),
            (jfq.KIND_FP_SIGNED, 3, 4), (jfq.KIND_FP_UNSIGNED, 2, 2),
            (jfq.KIND_FP_UNSIGNED, 3, 1)]


@pytest.mark.parametrize("kind,e,m,shape",
                         [c + ((33, 130),) for c in K1_CASES]
                         + [(jfq.KIND_FP_SIGNED, 2, 1, (64, 3))])
def test_k1_plain_bit_exact_vs_interpret_kernel(kind, e, m, shape, rng):
    signed = kind == jfq.KIND_FP_SIGNED
    zp = 0.0 if signed else -0.2
    x = rng.normal(size=shape).astype(np.float32) * 2
    want = np.asarray(jk1.msfp_qdq_2d(
        jx(x), jnp.float32(2.3), jnp.float32(zp), exp_bits=e, man_bits=m,
        signed=signed, interpret=True))
    got = tk1.msfp_qdq_2d(t(x), torch.tensor(2.3), torch.tensor(zp),
                          exp_bits=e, man_bits=m, signed=signed).numpy()
    np.testing.assert_array_equal(got, want)


def test_k1_dispatch_routes_and_cuda_wrapper_refuses_cpu(rng):
    x = t(rng.normal(size=(8, 5)).astype(np.float32))
    qp = tfq.QuantizerParams(tfq.KIND_FP_SIGNED, 2, 1, 4, torch.tensor(1.5))
    tops.reset_routes()
    tops.msfp_quantize(x, qp)
    tops.msfp_quantize(x, tfq.QuantizerParams(tfq.KIND_INT_AFFINE, 0, 0, 4,
                                              torch.tensor(1.5)))
    assert tops.ROUTES == {("msfp_quantize", "plain"): 1,
                           ("msfp_quantize", "ref"): 1}
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk1.msfp_qdq_2d_cuda(x, qp.maxval, qp.zero_point, exp_bits=2,
                             man_bits=1, signed=True)
