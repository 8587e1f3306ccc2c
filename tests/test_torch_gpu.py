"""On the card: each CUDA kernel of the port against its plain version.

Imports no JAX (it runs where only the port is installed), carries the ``gpu``
marker and skips, with its reason, where torch.cuda is unavailable; run it
there with ``python -m pytest -m gpu tests/test_torch_gpu.py``. The
decision is taken inside a fixture, never at import.

Tolerances: K1, K4, K5 and kv4_store bit-exact; qdq_conv2d (the io
sites' snap, conv and bias) by check_close's rule against its plain
version (the snap is K1's, bit for bit; the f32 sums run in another
order than cuDNN's); kv4_attend within
kernels/kv4.py:kv4_attend_allowed (the f32 sum-order bound of
check_close's rule, carried through the softmax, plus one ulp of the load
dtype on the weights and on the output); K2/K3 rtol = atol = 1e-5, the order
of the f32 sums and per-term roundings of the scales being the only
differences (at long K, or the f32 sum-order bound where larger, as
chip_smoke.py:check_close; bit-exact on power-of-two scales); an LM decode on the card vs the
CPU as in tests/test_torch_lm.py (f32: 1e-4 of max |logit|, same argmax;
bf16: relative Frobenius error 2e-2); the golden replay at tiny_ddim(8)
card vs CPU: tick log, outcomes, bank counters and x_T identical, x0 on
power-of-two weight scales within chip_smoke.py's REPLAY_X0_LIMIT (the
relative Frobenius error of the model's part of x0 <= 5e-2, at most 40% of
the elements off, which K2/K3 snapping bf16-rounded acts must break)."""
import dataclasses
import pathlib

import pytest
import torch

from repro_torch.common.tree import flatten_paths
from repro_torch.configs.diffusion_presets import tiny_ddim
from repro_torch.configs.smollm_135m import smoke as smollm_smoke
from repro_torch.core.qmodule import (PackedW4, decode_codes, pack_weight,
                                      unpack_nibbles)
from repro_torch.kernels import conv as k3
from repro_torch.kernels import kv4 as k45
from repro_torch.kernels import msfp_quant as k1
from repro_torch.kernels import ops
from repro_torch.kernels import w4_matmul as k2
from repro_torch.diffusion.schedule import make_schedule
from repro_torch.launch.serve_diffusion import TALORA_CFG
from repro_torch.launch.steps import (dyadic_weights, make_decode_fn,
                                      quantize_lm_for_serving)
from repro_torch.models.lm import init_caches, lm_init
from repro_torch.nn import layers
from repro_torch.nn.unet import io_sites, unet_init
from repro_torch.quant.calibrate import QuantContext
from repro_torch.quant.fakequant import QuantizerParams, apply_qdq, fp_qdq
from repro_torch.quant.formats import FPFormat, enumerate_grid
from repro_torch.serving import (DiffusionServingEngine, VirtualClock,
                                 WeightBank, absmax_talora_setup)
from repro_torch.serving.obs import Observability
from repro_torch.serving.replay import (dyadic_unet_weights, eps_free_x0,
                                        replay, replay_mismatches, x0_error)
from repro_torch.serving.traffic import load_trace
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


def _kv4_cache(b, slots, n_kv, hd, dev, seed):
    """An FP4 cache of finite garbage (random codes, f16 scales in [0, 4))
    and q (b, n_kv, 3, hd) drawers, from a seed."""
    g = torch.Generator().manual_seed(seed)
    codes = (b, slots, n_kv, hd // 2)
    cache = [torch.randint(0, 256, codes, generator=g, dtype=torch.uint8),
             torch.randint(0, 256, codes, generator=g, dtype=torch.uint8),
             torch.rand(b, slots, n_kv, generator=g) * 4,
             torch.rand(b, slots, n_kv, generator=g) * 4]
    cache[2:] = [x.half() for x in cache[2:]]

    def draw(*shape):
        return torch.randn(*shape, generator=g) * torch.rand(
            *shape[:-1], 1, generator=g) * 8
    return [x.to(dev) for x in cache], draw


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 16])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_kv4_store_bit_exact_in_place(cuda, dt, hd):
    """k and v of one token encoded into a middle slot of a garbage cache:
    codes and f16 scale bits equal the plain version's, every other slot
    untouched, one launch."""
    cache, draw = _kv4_cache(8, 64, 3, hd, cuda, 12)
    k_new, v_new = draw(8, 3, hd).to(cuda, dt), draw(8, 3, hd).to(cuda, dt)
    k_new[0, 0] = 0.0
    k_new[1, 0, :3] = -0.0
    want = [x.clone() for x in cache]
    k45.kv4_store_plain(k_new, v_new, *want, 31)
    before = k45.kv4_store_cuda.launches
    ops.kv4_store(k_new, v_new, *cache, 31)
    assert k45.kv4_store_cuda.launches == before + 1
    for got, ref in zip(cache, want):
        assert torch.equal(got.view(torch.uint8), ref.view(torch.uint8))


# (B, slots, valid): the serve shape's cache early, mid-way and full; a
# long cache; one whose logits take the shared memory past 48 KB
ATTEND_CASES = [(8, 64, 1), (8, 64, 33), (8, 64, 64), (2, 2048, 2048),
                (1, 4096, 4000)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,slots,valid", ATTEND_CASES)
@pytest.mark.parametrize("softcap", [None, 5.0])
@pytest.mark.parametrize("hd", [64, 16])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_kv4_attend_matches_plain(cuda, dt, hd, softcap, b, slots, valid):
    """3 kv-heads x 3 query heads over a garbage cache (the slots from
    ``valid`` on must not count): within kv4_attend_allowed of the plain
    version on the card, one launch a call."""
    cache, draw = _kv4_cache(b, slots, 3, hd, cuda, slots + valid + hd)
    q = draw(b, 3, 3, hd).to(cuda, dt)
    args = (valid, hd ** -0.5, softcap)
    want = k45.kv4_attend_plain(q, *cache, *args)
    before = k45.kv4_attend_cuda.launches
    got = ops.kv4_attend(q, *cache, *args)
    assert k45.kv4_attend_cuda.launches == before + 1
    assert got.dtype == dt and got.shape == q.shape
    allowed = k45.kv4_attend_allowed(q, *cache, *args, want)
    diff = (got.double() - want.double()).abs()
    assert not bool((diff > allowed).any()), (int((diff > allowed).sum()),
                                              float(diff.max()))


@pytest.mark.gpu
def test_kv4_attend_over_limit_raises(cuda):
    """A cache whose G x S logits do not fit one block's shared memory is
    refused before any launch."""
    cache, draw = _kv4_cache(1, 20_000, 3, 64, cuda, 13)
    q = draw(1, 3, 3, 64).to(cuda)
    before = k45.kv4_attend_cuda.launches
    with pytest.raises(ValueError, match="shared memory"):
        ops.kv4_attend(q, *cache, 20_000, 0.125)
    assert k45.kv4_attend_cuda.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("kv,act,dt", [("fp4", True, torch.float32),
                                       ("bf16", True, torch.float32),
                                       ("fp8", False, torch.float32),
                                       ("fp4", True, torch.bfloat16)])
def test_lm_decode_on_card_matches_cpu(cuda, kv, act, dt):
    """smollm-135m-smoke over packed ``dyadic_weights`` (exact W4A4 sums
    in any order; E2M1 acts fused into K2 where ``act``; an FP8 cache runs
    acts off, as in tests/test_torch_lm.py): 6 teacher-forced steps on the
    card (K2, kv4_store, kv4_attend) vs the CPU (their plain versions),
    both in torch.
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


def _abs_weight(pw):
    """|w| + |zp| per weight element, w decoded without its zero-point."""
    w = decode_codes(unpack_nibbles(pw.packed), pw.fmt, pw.scale, 0.0,
                     torch.float32)
    return (w.abs() + pw.zero_point.abs()).reshape(pw.shape)


def _assert_order_close(got, want, mag, k):
    """K2/K3 vs the plain version where K is long (chip_smoke.py:
    check_close's rule): per element TOL, or where larger the f32 sum-order
    bound 4 * sqrt(k) * 2^-24 * mag, mag being the same product over |x_q|
    and |w| + |zp| (the order error of a k-term f32 sum grows like sqrt(k)
    ulps of the summands' magnitude, far above TOL where they cancel)."""
    diff = (got.float() - want.float()).abs()
    allowed = (TOL["atol"] + TOL["rtol"] * want.float().abs()).maximum(
        4.0 * k ** 0.5 * 2.0 ** -24 * mag)
    bad = diff > allowed
    assert not bool(bad.any()), (int(bad.sum()), float(diff.max()))


def _dense_mag(x, args, fmt, k, n):
    """|x_q| @ (|w| + |zp|) for the K2 arguments ``args``."""
    packed, sc, zp, a = args
    xq = x if a is None else fp_qdq(x, FPFormat(a[2], a[3], a[4]), a[0], a[1])
    pw = PackedW4(packed, sc, zp, fmt["exp_bits"], fmt["man_bits"],
                  fmt["signed"], (k, n))
    return xq.abs() @ _abs_weight(pw)


def _dense_case(kind, m, k, n, dt, dev, act=True, seed=7, dyadic=False):
    """x (m, k) in ``dt`` and a packed (k, n) weight with its act tuple.
    ``dyadic``: weight scale maxval/6 = 2^-3 and act maxval 6 (scale 1),
    so every W4A4 sum is exact and kernel and plain version agree bit for
    bit whatever the order."""
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(k, n, generator=g) * 0.3
    x = (torch.randn(m, k, generator=g) * 1.5).to(dev, dt)
    if dyadic:
        pw = pack_weight(w, QuantizerParams(S, 2, 1, 4, torch.tensor(0.75)))
        aq = QuantizerParams(S, 2, 1, 4, torch.tensor(6.0))
        pw, aq = pw.to(dev), aq.to(dev)
    else:
        pw, aq = _qps(kind, w, kind == U, dev)
    a = None if not act else (aq.maxval, aq.zero_point, aq.exp_bits,
                              aq.man_bits, aq.kind == S)
    fmt = dict(exp_bits=pw.exp_bits, man_bits=pw.man_bits, signed=pw.signed)
    return x, (pw.packed, pw.scale, pw.zero_point, a), fmt


GEMM_CASES = [  # (kind, m, k, n, act): split-K at M 1 and 8 with K >= 1536,
    # ragged M, N and K (no tile multiple, K rows not 16-byte aligned), the
    # act-off (three-term split) and unsigned-act operand routes, each tile
    (S, 1, 1536, 576, True), (S, 8, 1536, 576, True), (U, 8, 2304, 192, True),
    (S, 131, 100, 66, True), (U, 9, 37, 34, True), (S, 200, 1536, 130, False),
    (U, 5, 576, 1536, False), (U, 300, 300, 256, True),
    (S, 4100, 1030, 260, True), (U, 4096, 1152, 256, False)]  # Large tile


@pytest.mark.gpu
@pytest.mark.parametrize("kind,m,k,n,act", GEMM_CASES)
def test_k2_tensor_core_routes_match_plain(cuda, kind, m, k, n, act):
    x, args, fmt = _dense_case(kind, m, k, n, torch.float32, cuda, act)
    before = k2.w4_matmul_2d_cuda.launches
    got = k2.w4_matmul_2d(x, *args, **fmt)
    assert k2.w4_matmul_2d_cuda.launches == before + 1  # split-K included
    _assert_order_close(got, k2.w4_matmul_2d_plain(x, *args, **fmt),
                        _dense_mag(x, args, fmt, k, n), k)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("cfg", [0, 1, 2])
@pytest.mark.parametrize("kind,act", [(S, True), (U, True), (S, False)])
def test_k2_every_tile_and_split_matches_plain(cuda, cfg, splits, kind,
                                              act):
    """Each tile shape (Large, Small, Medium) and split count forced on
    one ragged product (M, N and K no tile multiple, rows not 16-byte
    aligned), whatever gemm_plan would pick there; held to the sum-order
    rule (an unsigned weight's zero-point term cancels most of its row)."""
    m, k, n = 37, 130, 66
    x, args, fmt = _dense_case(kind, m, k, n, torch.float32, cuda, act)
    got = k2.w4_matmul_2d_cuda(x, *args, **fmt, plan=(cfg, splits))
    _assert_order_close(got, k2.w4_matmul_2d_plain(x, *args, **fmt),
                        _dense_mag(x, args, fmt, k, n), k)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(8, 576, 1536), (8, 1536, 576),
                                   (3, 576, 192), (200, 256, 256)])
def test_k2_bf16_bit_exact_on_dyadic_scales(cuda, m, k, n):
    x, args, fmt = _dense_case(S, m, k, n, torch.bfloat16, cuda,
                               dyadic=True)
    got = k2.w4_matmul_2d(x, *args, **fmt)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, k2.w4_matmul_2d_plain(x, *args, **fmt))


CONV_GPU_CASES = [  # (kind, k, stride, b, hw, cin, cout, dtype): split-K at
    # 4x4 with cin 512, the chunked gather (cin a multiple of 32), cin not a
    # multiple of the chunk (40, 6), bf16
    (S, 3, 1, 8, 4, 512, 256, torch.float32),
    (U, 3, 2, 2, 16, 128, 128, torch.float32),
    (S, 3, 1, 2, 9, 40, 24, torch.float32),
    (U, 1, 1, 3, 7, 6, 10, torch.float32),
    (S, 3, 1, 8, 8, 384, 256, torch.bfloat16),
    (S, 3, 2, 2, 9, 40, 16, torch.bfloat16)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,k,s,b,hw,cin,cout,dt", CONV_GPU_CASES)
def test_k3_tensor_core_routes_match_plain(cuda, kind, k, s, b, hw, cin,
                                          cout, dt):
    g = torch.Generator().manual_seed(8)
    w = torch.randn(k, k, cin, cout, generator=g) * (k * k * cin) ** -0.5
    x = torch.randn(b, hw, hw, cin, generator=g).to(cuda, dt)
    if dt == torch.bfloat16:   # dyadic scales: exact sums, bit-exact
        pw = pack_weight(w, QuantizerParams(S, 2, 1, 4, torch.tensor(0.75)))
        pw, aq = pw.to(cuda), QuantizerParams(S, 2, 1, 4,
                                              torch.tensor(6.0)).to(cuda)
    else:
        pw, aq = _qps(kind, w, kind == U, cuda)
    kw = dict(stride=(s, s), padding="SAME")
    for act in (aq, None):
        got = k3.w4a4_conv2d_implicit(x, pw, act, **kw)
        want = k3.w4a4_conv2d_implicit_plain(x, pw, act, **kw)
        if dt == torch.float32:
            xq = x if act is None else apply_qdq(x, act)
            mag = k3.conv2d_nhwc(xq.abs(), _abs_weight(pw), **kw)
            _assert_order_close(got, want, mag, k * k * cin)
        elif act is not None:
            assert torch.equal(got, want)
        else:   # raw bf16 acts: inexact f32 sums, then one bf16 rounding
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=2.0**-8, atol=1e-5)


@pytest.mark.gpu
def test_split_k_is_deterministic(cuda):
    """Two launches on the same inputs are bit-identical: the split-K
    partials are summed in split order, never by float atomics."""
    x, args, fmt = _dense_case(S, 8, 1536, 576, torch.float32, cuda)
    assert k2.gemm_plan(8, 576, 1536)[1] > 1
    runs = [k2.w4_matmul_2d(x, *args, **fmt) for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    g = torch.Generator().manual_seed(9)
    w = torch.randn(3, 3, 512, 256, generator=g) * 0.02
    pw, aq = _qps(U, w, True, cuda)
    xc = torch.randn(8, 4, 4, 512, generator=g).to(cuda)
    outs = [k3.w4a4_conv2d_implicit(xc, pw, aq, stride=(1, 1),
                                    padding="SAME") for _ in range(3)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def _io_act(kind, dev):
    """The io kernel's act quantizers: E2M1 at maxval 6 (the main path),
    uE2M2 with zp -0.28 (whose snap of 0 is not 0), or acts off."""
    if kind == S:
        return QuantizerParams(S, 2, 1, 4, torch.tensor(6.0)).to(dev)
    if kind == U:
        return QuantizerParams(U, 2, 2, 4, torch.tensor(3.0),
                               torch.tensor(-0.28)).to(dev)
    return None


IO_CONV_CASES = [  # (b, h, w, cin, cout, k): the full-width io sites
    # (conv_in, conv_out), ragged 7x9 images, 1x1, a narrow conv without
    # 16-byte reads (cin % 4 != 0), a wide one with cin % 4 == 0, and the
    # narrow kernel's other channel counts (2; 6: a group of 4 and one
    # padded with zero weight rows)
    (8, 32, 32, 3, 128, 3), (8, 32, 32, 128, 3, 3), (2, 7, 9, 3, 128, 3),
    (2, 7, 9, 128, 3, 3), (2, 8, 8, 128, 3, 1), (2, 8, 8, 3, 16, 1),
    (3, 5, 6, 6, 3, 3), (2, 9, 7, 16, 8, 3), (2, 8, 8, 16, 6, 3),
    (1, 6, 5, 8, 2, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", [S, U, None])
@pytest.mark.parametrize("b,h,w,cin,cout,k", IO_CONV_CASES)
def test_qdq_conv2d_matches_plain(cuda, b, h, w, cin, cout, k, kind):
    """f32 and bf16 weights, with and without a bias: one launch each,
    within check_close's rule of the plain version; a band of 1, 3 or 5
    rows gives the same bits (each output is one chain whatever the
    band)."""
    g = torch.Generator().manual_seed(10)
    x = (torch.randn(b, h, w, cin, generator=g) * 2).to(cuda)
    w32 = torch.randn(k, k, cin, cout, generator=g) * (k * k * cin) ** -0.5
    bias = (torch.randn(cout, generator=g) * 0.1).to(cuda)
    aq = _io_act(kind, cuda)
    xq = x if aq is None else apply_qdq(x, aq)
    for wt in (w32.to(cuda), w32.to(cuda, torch.bfloat16)):
        mag = k3.conv2d_nhwc(xq.abs(), wt.float().abs(), stride=(1, 1),
                             padding="SAME")
        for bv in (bias, None):
            before = k1.qdq_conv2d_cuda.launches
            got = k1.qdq_conv2d(x, wt, aq, bv)
            assert k1.qdq_conv2d_cuda.launches == before + 1
            _assert_order_close(got, k1.qdq_conv2d_plain(x, wt, aq, bv),
                                mag, k * k * cin)
            for rows in (1, 3, 5):
                assert torch.equal(
                    k1.qdq_conv2d_cuda(x, wt, aq, bv, rows=rows), got)


@pytest.mark.gpu
def test_qdq_conv2d_raises_on_uncovered_inputs(cuda):
    x = torch.zeros(1, 8, 8, 4, device=cuda)
    w = torch.zeros(3, 3, 4, 4, device=cuda)
    intq = QuantizerParams(2, 0, 0, 4, torch.tensor(3.0)).to(cuda)
    bad = [(x.bfloat16(), w, None), (x, torch.zeros(5, 5, 4, 4, device=cuda),
                                     None),
           (x, w.half(), None), (x, w, intq),
           (torch.zeros(1, 32, 32, 8192, device=cuda),
            torch.zeros(3, 3, 8192, 4, device=cuda), None)]
    for xb, wb, aq in bad:
        with pytest.raises(ValueError):
            k1.qdq_conv2d_cuda(xb, wb, aq, None)
    with pytest.raises(ValueError):
        k1.qdq_conv2d_cuda(x, w, None, torch.zeros(3, device=cuda))


@pytest.mark.gpu
def test_io_sites_on_card_take_the_kernel_only(cuda):
    """Both io sites through ``conv2d_apply`` with a dense bf16 weight and
    a bias: one qdq_conv2d launch each, no K1, no off-kernel route."""
    g = torch.Generator().manual_seed(11)
    aq = _io_act(S, cuda)
    ops.reset_routes()
    k1_before = k1.msfp_qdq_2d_cuda.launches
    io_before = k1.qdq_conv2d_cuda.launches
    for cin, cout in ((3, 128), (128, 3)):
        p = {"w": torch.randn(3, 3, cin, cout, generator=g).to(
                 cuda, torch.bfloat16),
             "b": torch.randn(cout, generator=g).to(cuda)}
        x = torch.randn(2, 32, 32, cin, generator=g).to(cuda)
        y = layers.conv2d_apply(p, x, act_qp=aq)
        assert y.shape == (2, 32, 32, cout)
    assert dict(ops.ROUTES) == {("conv2d", "cuda"): 2}
    assert k1.qdq_conv2d_cuda.launches == io_before + 2
    assert k1.msfp_qdq_2d_cuda.launches == k1_before


# ---------------------------------------------------------------------------
# The golden replay, card vs CPU, and the kernel profiler on the card.
# ---------------------------------------------------------------------------

GOLDEN = str(pathlib.Path(__file__).resolve().parent / "data"
             / "golden_trace.jsonl")
# x0's limit as chip_smoke.py:REPLAY_X0_LIMIT (relative to the model's part
# of x0, serving/replay.py:x0_error)
REPLAY_X0_LIMIT = (5e-2, 0.4)


def _tiny_golden_setup(dyadic):
    """tiny_ddim(8) as the launcher builds it from --seed 0, on the CPU,
    optionally on power-of-two weight scales; the hubs' B is 0, so the
    bank's merge keeps them."""
    cfg = tiny_ddim(8)
    gen = torch.Generator().manual_seed(0)
    params = unet_init(gen, cfg, "cpu")
    if dyadic:
        params = dyadic_unet_weights(params, {
            k: v for k, v in flatten_paths(params).items()
            if k.endswith("/w") and v.ndim >= 2})
    plan, hubs, router = absmax_talora_setup(params, TALORA_CFG, gen,
                                             io_sites=io_sites(params))
    assert not any(bool(h["B"].any()) for h in hubs.values())
    return cfg, params, plan, hubs, router


def _tiny_golden_replay(setup, dev, obs=None):
    cfg, params, plan, hubs, router = setup
    bank = WeightBank(params, plan, hubs, router, TALORA_CFG, 100,
                      device=dev)
    eng = DiffusionServingEngine(
        cfg, make_schedule("linear", 100), bank,
        act_qps={"*": QuantizerParams(0, 2, 1, 4,
                                      torch.tensor(6.0, device=dev))},
        max_batch=2, clock=VirtualClock(), device=dev, obs=obs)
    return replay(eng, load_trace(GOLDEN)[0])


def _within(d, limit):
    return d["rel_frobenius"] <= limit[0] and d["frac_off"] <= limit[1]


@pytest.mark.gpu
def test_golden_replay_on_card_matches_cpu(cuda, monkeypatch):
    """tiny_ddim(8): the tick log, outcomes, bank counters and x_T equal
    card vs CPU on both weight sets; on power-of-two scales x0 within
    REPLAY_X0_LIMIT, and K2/K3 snapping bf16-rounded acts breaks it."""
    reqs = load_trace(GOLDEN)[0]
    base = eps_free_x0(reqs, make_schedule("linear", 100), (1, 8, 8, 3))
    for dyadic in (True, False):
        setup = _tiny_golden_setup(dyadic)
        card = _tiny_golden_replay(setup, cuda)
        host = _tiny_golden_replay(setup, torch.device("cpu"))
        assert replay_mismatches(card, host) == []
        assert len(card["ticks"]) > 0 and card["bank"]["builds"] > 0
        if not dyadic:
            continue
        assert _within(x0_error(card["x0"], host["x0"], base),
                       REPLAY_X0_LIMIT)
        for mod, name in ((k2, "w4_matmul_2d_cuda"),
                          (k3, "w4a4_conv2d_implicit_cuda")):
            f = getattr(mod, name)

            def bf16_acts(x, *a, f=f, **kw):
                return f(x.bfloat16().float(), *a, **kw)
            bf16_acts.launches = f.launches
            monkeypatch.setattr(mod, name, bf16_acts)
        ctl = _tiny_golden_replay(setup, cuda)
        monkeypatch.undo()
        assert not _within(x0_error(ctl["x0"], host["x0"], base),
                           REPLAY_X0_LIMIT)


@pytest.mark.gpu
def test_kernel_profiler_times_the_kernels_on_card(cuda):
    """The profiler on the card: its route counts equal ops.ROUTES and the
    kernels' launch counters, and the CUDA events give K2 and K3 positive
    device seconds, read when the counts are."""
    ops.reset_routes()
    before = {"w4a4_matmul:cuda": k2.w4_matmul_2d_cuda.launches,
              "w4a4_conv2d:cuda:implicit":
                  k3.w4a4_conv2d_implicit_cuda.launches,
              "conv2d:cuda": k1.qdq_conv2d_cuda.launches}
    obs = Observability()
    with obs.kernel_profiler:
        _tiny_golden_replay(_tiny_golden_setup(False), cuda, obs)
    counts = obs.kernel_profiler.route_counts()
    assert counts == {f"{op}:{r}": n for (op, r), n in ops.ROUTES.items()}
    launched = {"w4a4_matmul:cuda": k2.w4_matmul_2d_cuda.launches,
                "w4a4_conv2d:cuda:implicit":
                    k3.w4a4_conv2d_implicit_cuda.launches,
                "conv2d:cuda": k1.qdq_conv2d_cuda.launches}
    snap = obs.metrics.snapshot()
    for key, n in launched.items():
        assert counts[key] == n - before[key] > 0
        op, route = key.split(":", 1)
        hist = f'kernel_call_seconds{{op="{op}",route="{route}"}}'
        assert snap[f"{hist}_count"] == counts[key]
        assert snap[f"{hist}_sum"] > 0


# ---------------------------------------------------------------------------
# the paper pipeline on the card
# ---------------------------------------------------------------------------

def _tiny_pipeline_bundle():
    """tiny_ddim(8) through the port's pipeline on the CPU: calibration,
    the searched plan on power-of-two scales (``msfp.pow2_plan``), the
    weights fake-quantized, TALoRA attached."""
    from repro_torch.core import msfp
    from repro_torch.diffusion import pipeline as pipe
    cfg, sched = tiny_ddim(8), make_schedule("linear", 50)
    params = unet_init(torch.Generator().manual_seed(3), cfg, "cpu")
    calib = pipe.build_calibration_set(params, cfg, sched, n_samples=2,
                                       steps=2, batch=2)
    db = pipe.calibrate_activations(params, cfg, calib)
    weights = {k: v for k, v in flatten_paths(params).items()
               if k.endswith("/w")}
    plan = msfp.pow2_plan(msfp.build_mixed_plan(
        weights, db, io_sites=io_sites(params), device="cpu"))
    flat = dict(flatten_paths(params))
    flat.update(msfp.quantize_weight_tree(weights, plan))
    from repro_torch.common.tree import unflatten_paths
    bundle = pipe.QuantizedDiffusion(cfg, sched, params,
                                     unflatten_paths(flat), plan)
    return pipe.attach_talora(bundle, TALORA_CFG, seed=4)


def _steps(bundle, dev, n=2):
    from repro_torch.optim.adam import adam_init
    from repro_torch.train import finetune as ft_mod
    bundle = bundle.to(dev)
    ft = ft_mod.FinetuneConfig(batch=2)
    tr = {"hubs": bundle.hubs, "router": bundle.router}
    opt = adam_init(tr, ft.adam())
    gen = torch.Generator().manual_seed(8)
    gammas = bundle.sched.gamma()
    out = []
    for tt in (37, 12)[:n]:
        x = torch.randn((2, 8, 8, 3), generator=gen).to(dev)
        tb = torch.full((2,), float(tt), device=dev)
        g = torch.full((2,), float(gammas[tt]), device=dev)
        before = tr
        tr, opt, loss, m = ft_mod.train_step(bundle, ft, tr, opt, x, tb, g,
                                             t_frac=tt / 50)
        out.append(dict(tr=tr, opt=opt, loss=loss, grad_norm=m["grad_norm"],
                        grads=m["grads"], before=before))
    return out


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(cuda):
    """Two fine-tune steps card vs CPU from the same state, within
    finetune.STEP_LIMIT; every hub's B gradient nonzero on the card, the
    STE's K1 and the convs' qdq_conv2d (under autograd) launched."""
    from repro_torch.train.finetune import STEP_LIMIT, step_errors
    bundle = _tiny_pipeline_bundle()
    k1_before = k1.msfp_qdq_2d_cuda.launches
    io_before = k1.qdq_conv2d_cuda.launches
    card = _steps(bundle, cuda)
    assert k1.msfp_qdq_2d_cuda.launches > k1_before
    assert k1.qdq_conv2d_cuda.launches > io_before
    host = _steps(bundle, torch.device("cpu"))
    grads = flatten_paths(card[0]["grads"])
    bs = [k for k in grads if k.endswith("/B")]
    assert len(bs) == len(bundle.hubs)
    assert all(bool(grads[k].abs().sum() > 0) for k in bs)
    for c, h in zip(card, host):
        errs = step_errors(c, h, h["before"])
        assert all(v <= STEP_LIMIT for v in errs.values()), errs


@pytest.mark.gpu
@pytest.mark.parametrize("kind,e,m,bits,mv,zp", [
    (0, 2, 1, 4, 2.5, 0.0), (1, 2, 2, 4, 3.0, -0.25), (1, 4, 0, 4, 5.0, -0.3),
    (0, 5, 2, 8, 4.0, 0.0), (1, 5, 3, 8, 2.0, -0.1), (0, 2, 5, 8, 1.3, 0.0)])
def test_ste_forward_is_k1_bit_exact_on_card(cuda, kind, e, m, bits, mv, zp):
    """The STE's forward on the card is K1 in the folded form, bit for bit
    with fp_qdq's folded form on the CPU; its gradient is the same clip
    mask."""
    from repro_torch.quant.fakequant import ste_qdq
    qp = QuantizerParams(kind, e, m, bits, torch.tensor(mv),
                         torch.tensor(zp))
    x = torch.randn(4096, 33, generator=torch.Generator().manual_seed(e)) * 3
    before = k1.msfp_qdq_2d_cuda.launches
    xc = x.to(cuda).requires_grad_(True)
    out = ste_qdq(xc, qp.to(cuda))
    assert k1.msfp_qdq_2d_cuda.launches == before + 1
    assert torch.equal(out.detach().cpu(), fp_qdq(
        x, qp.fmt, qp.maxval, qp.zero_point, form="folded"))
    (g,) = torch.autograd.grad(out.sum(), xc)
    xh = x.clone().requires_grad_(True)
    (gh,) = torch.autograd.grad(ste_qdq(xh, qp).sum(), xh)
    assert torch.equal(g.cpu(), gh)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["normal", "silu"])
def test_batched_search_on_card_matches_cpu(cuda, kind):
    """The search's batched candidate grids on the card against the CPU's on
    the same samples: every candidate's MSE within the sum-order bound,
    the same pick or a near-tie by the CPU's own MSEs."""
    from repro_torch.quant import formats as F
    from repro_torch.quant import search
    x = torch.randn(32768, generator=torch.Generator().manual_seed(1))
    if kind == "silu":
        x = x * torch.sigmoid(x)
    mvs = torch.linspace(0.02, float(x.abs().max()), 99)
    zps = torch.linspace(-0.3, 0.0, 6)
    bound = search.tie_bound(x.numel())
    for fmt in F.signed_formats(4) + F.unsigned_formats(4):
        if fmt.signed:
            host = search.mse_signed_grid(x, fmt, mvs)
            card = search.mse_signed_grid(x.to(cuda), fmt, mvs.to(cuda))
        else:
            host = search.mse_unsigned_grid(x, fmt, mvs, zps).ravel()
            card = search.mse_unsigned_grid(x.to(cuda), fmt, mvs.to(cuda),
                                            zps.to(cuda)).ravel()
        assert abs(card - host).max() <= bound * host.max()
        i, j = int(host.argmin()), int(card.argmin())
        assert i == j or abs(host[i] - host[j]) <= bound * host[i]
    r_host = search.search_activation_params(x, 4, allow_unsigned=True,
                                             device="cpu")
    r_card = search.search_activation_params(x, 4, allow_unsigned=True,
                                             device=cuda)
    assert r_card.params.maxval.is_cuda
    assert abs(r_card.mse - r_host.mse) <= bound * r_host.mse


def _scale_split_case(fmt: FPFormat):
    """A (K, 64) weight and a per-channel quantizer whose 64 maxvals each
    round differently as ``maxval / base_max`` and as ``maxval * (1 /
    base_max)``, every weight within 8 ulps of a grid midpoint, where a
    one-ulp change of the scale moves the code."""
    bm = torch.tensor(fmt.base_max)
    m = torch.rand(1 << 16, generator=torch.Generator().manual_seed(5)) * 3
    m = m[m / bm != m * (1 / bm)][:64]
    g = torch.tensor(sorted({abs(v) for v in enumerate_grid(fmt)}),
                     dtype=torch.float64)
    mids = ((g[1:] + g[:-1]) / 2).float()
    zp = torch.tensor(0.0 if fmt.signed else -0.25)
    w0 = mids[:, None] * (m / bm)[None, :] + zp
    ulp = torch.nextafter(w0.abs(), torch.tensor(float("inf"))) - w0.abs()
    w = torch.stack([w0 + o * ulp for o in range(-8, 9)]).reshape(-1, 64)
    return w, QuantizerParams(S if fmt.signed else U, fmt.exp_bits,
                              fmt.man_bits, 4, m, zp)


@pytest.mark.gpu
@pytest.mark.parametrize("e,m,signed", [(2, 1, True), (1, 2, True),
                                        (0, 3, True), (3, 1, False),
                                        (2, 2, False), (0, 4, False)])
def test_pack_weight_on_card_equals_cpu_bytes(cuda, monkeypatch, e, m,
                                              signed):
    """The weight bank's pack built on the card equals the CPU's bytes at
    maxvals where the true division ``maxval / base_max`` and a multiply
    by its reciprocal (CUDA's division by a Python scalar) round apart:
    the encode divides by a tensor on every device (qmodule.encode_codes,
    fakequant.true_div). The case is checked to tell the two apart."""
    from repro_torch.core import qmodule
    fmt = FPFormat(e, m, signed)
    w, qp = _scale_split_case(fmt)
    assert qp.maxval.numel() == 64
    host = pack_weight(w, qp)
    card = pack_weight(w.to(cuda), qp.to(cuda))
    assert torch.equal(card.packed.cpu(), host.packed)
    assert torch.equal(card.scale.cpu(), host.scale)
    assert torch.equal(card.zero_point.cpu(), host.zero_point)
    monkeypatch.setattr(qmodule, "true_div", lambda t, c: t * (1.0 / c))
    assert not torch.equal(pack_weight(w, qp).packed, host.packed)
