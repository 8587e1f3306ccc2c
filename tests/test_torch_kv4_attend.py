"""The FP4-cache decode path's two ops, ``kv4_store`` and ``kv4_attend``
(``kernels/kv4.py``), on the CPU: their plain versions against the
composition they replaced in ``nn/attention.py`` (K4's encode and four
slice copies; K5's decode of the whole cache and the torch attention), a
copy of which serves as the oracle here; ``attn_decode`` with an FP4 cache,
a softcap and a ring slot against the JAX package; the tolerance that holds
the CUDA kernel to the plain version (``kv4_attend_allowed``) against an
implementation summing in another order and two faults; the kernel's
shared-memory limit.

Tolerances: the plain versions bit-exact with the former composition
(codes, f16 scale bits, output bits); ``attn_decode`` vs JAX rtol = atol =
1e-5 (as tests/test_torch_lm.py: XLA's and torch's tanh and sums differ by
an ulp or two); the other-order implementation within
``kv4_attend_allowed``, the faults outside it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as jops
from _torch_parity import np_tree, t
from repro.nn import attention as jattn
from repro_torch.common.device import no_tf32
from repro_torch.convert import from_numpy_tree
from repro_torch.kernels import kv4 as tkv4
from repro_torch.kernels import ops as tops
from repro_torch.nn import attention as tattn

TOL = dict(rtol=1e-5, atol=1e-5)
B, K, HD = 2, 2, 16


@pytest.fixture
def jax_interpret():
    """The JAX package's Pallas kernels in interpret mode (on the CPU its
    kv4 dispatch otherwise takes the ref.py oracles)."""
    old = jops.FORCE
    jops.FORCE = "interpret"
    yield
    jops.FORCE = old


def _bits(x: torch.Tensor) -> np.ndarray:
    x = x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return x.view(np.uint32 if x.dtype == np.float32 else np.uint16)


def _garbage_cache(slots: int, rng) -> dict:
    """An FP4 cache whose every slot holds finite garbage: random codes and
    f16 scales in [0, 4)."""
    codes = (B, slots, K, HD // 2)
    return {"k": torch.from_numpy(rng.integers(0, 256, codes, np.uint8)),
            "v": torch.from_numpy(rng.integers(0, 256, codes, np.uint8)),
            "k_scale": torch.from_numpy(
                rng.uniform(0, 4, (B, slots, K)).astype(np.float16)),
            "v_scale": torch.from_numpy(
                rng.uniform(0, 4, (B, slots, K)).astype(np.float16))}


def _old_store(cache, k_new, v_new, pos):
    """nn/attention.py:_kv_store's fp4 branch before the fusion: k_new,
    v_new (B, 1, K, hd)."""
    for name, x in (("k", k_new), ("v", v_new)):
        packed, scale = tops.kv4_encode(x)
        cache[name][:, pos] = packed[:, 0]
        cache[f"{name}_scale"][:, pos] = scale[:, 0]


def _old_attend(cache, q, valid_len, head_dim, softcap, dtype):
    """nn/attention.py's _kv_load + attn_decode arithmetic before the
    fusion: q (B, 1, K, G, hd) -> o (B, 1, K, G, hd)."""
    keys = tops.kv4_decode(cache["k"], cache["k_scale"], dtype)
    vals = tops.kv4_decode(cache["v"], cache["v_scale"], dtype)
    s_max = keys.shape[1]
    with no_tf32():
        logits = torch.einsum("bqkgh,bskh->bkgqs", q.to(torch.float32),
                              keys.to(torch.float32)) * head_dim ** -0.5
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    valid = torch.arange(s_max) < valid_len
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1).to(vals.dtype)
    with no_tf32():
        return torch.einsum("bkgqs,bskh->bqkgh", w, vals)


def _new_token(g, dt, rng):
    """q (B, 1, K, G, hd), k and v (B, 1, K, hd), of mixed magnitudes."""
    def draw(*shape):
        x = rng.normal(size=shape) * rng.uniform(0.05, 8, (*shape[:-1], 1))
        return torch.from_numpy(x.astype(np.float32)).to(dt)
    return draw(B, 1, K, g, HD), draw(B, 1, K, HD), draw(B, 1, K, HD)


# (slots, store_pos, valid_len): slots past valid_len hold garbage; a ring
# slot (a windowed layer after wraparound: every slot valid, the new token
# mid-ring); the first token
SLOT_CASES = [(8, 2, 3), (8, 5, 8), (8, 0, 1)]


@pytest.mark.parametrize("slots,pos,valid", SLOT_CASES)
@pytest.mark.parametrize("softcap", [None, 3.0])
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_store_and_attend_plain_match_former_composition(dt, g, softcap,
                                                         slots, pos, valid):
    rng = np.random.default_rng(slots * 31 + pos * 7 + valid + g)
    cache = _garbage_cache(slots, rng)
    q, k_new, v_new = _new_token(g, dt, rng)
    old = {n: x.clone() for n, x in cache.items()}
    _old_store(old, k_new, v_new, pos)
    want = _old_attend(old, q, valid, HD, softcap, dt)

    tops.reset_routes()
    fp4 = (cache["k"], cache["v"], cache["k_scale"], cache["v_scale"])
    tops.kv4_store(k_new[:, 0], v_new[:, 0], *fp4, pos)
    got = tops.kv4_attend(q[:, 0], *fp4, valid, HD ** -0.5, softcap)
    assert dict(tops.ROUTES) == {("kv4_store", "plain"): 1,
                                 ("kv4_attend", "plain"): 1}
    for name in ("k", "v"):
        assert torch.equal(cache[name], old[name])
        assert torch.equal(cache[f"{name}_scale"].view(torch.int16),
                           old[f"{name}_scale"].view(torch.int16))
    assert got.dtype == dt and got.shape == (B, K, g, HD)
    np.testing.assert_array_equal(_bits(got), _bits(want[:, 0]))


@pytest.mark.parametrize("softcap,window", [(None, None), (20.0, None),
                                            (None, 3), (20.0, 3)])
def test_attn_decode_fp4_matches_reference(softcap, window, jax_interpret):
    """Six decode steps of one attention layer with an FP4 cache, against
    the JAX package's attn_decode; with a window the cache is a ring of 3
    slots, as models/lm.py keeps it (store at pos % 3, attend over
    min(pos + 1, 3))."""
    kw = dict(qkv_bias=True, softcap=softcap)
    jcfg = jattn.AttnConfig(32, 6, 2, 16, **kw)
    tcfg = tattn.AttnConfig(32, 6, 2, 16, **kw)
    jp = jattn.attn_init(jax.random.PRNGKey(7), jcfg)
    jp = jax.tree.map(lambda a: a * 3 + 0.1, jp)   # logits past the softcap
    tp = from_numpy_tree(np_tree(jp), "cpu")
    slots = window or 6
    jc = jattn.init_kv_cache(2, slots, jcfg, "fp4")
    tc = tattn.init_kv_cache(2, slots, tcfg, "fp4")
    xs = np.random.default_rng(8).normal(size=(6, 2, 1, 32)).astype(np.float32)
    step = jax.jit(lambda c, x, cos, sin, i, n: jattn.attn_decode(
        jp, x, c, i, n, cos, sin, jcfg, kv_dtype="fp4", site="a"))
    for i in range(6):
        store, valid = (i % window, min(i + 1, window)) if window else (i,
                                                                       i + 1)
        ang = i * (1.0 / (10_000.0 ** (np.arange(0, 16, 2) / 16)))
        cos = np.cos(ang)[None].astype(np.float32)
        sin = np.sin(ang)[None].astype(np.float32)
        want, jc = step(jc, jnp.asarray(xs[i]), jnp.asarray(cos),
                        jnp.asarray(sin), jnp.int32(store), jnp.int32(valid))
        got, tc = tattn.attn_decode(tp, t(xs[i]), tc, store, valid, t(cos),
                                    t(sin), tcfg, kv_dtype="fp4", site="a")
        torch.testing.assert_close(got, t(want), **TOL)
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))


def _attend_other_order(q, k, v, k_scale, v_scale, valid_len, scale,
                        softcap, dt):
    """kv4_attend's arithmetic with every f32 sum in another order than
    the plain version's (the dot over hd and the sum over the slots run
    backwards, one f32 add at a time) and the softmax divided, not
    multiplied by a reciprocal: what the CUDA kernel may do."""
    keys = tkv4._decode_cache(k, k_scale, dt)[:, :valid_len].float()
    vals = tkv4._decode_cache(v, v_scale, dt)[:, :valid_len].float()
    qf = q.float()
    logits = torch.zeros(*q.shape[:3], valid_len)
    for h in reversed(range(q.shape[-1])):
        logits = logits + qf[..., h, None] * keys[..., h].permute(
            0, 2, 1)[:, :, None]
    logits = logits * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    w = (e / e.sum(-1, keepdim=True)).to(dt).float()
    o = torch.zeros(q.shape)
    for s in reversed(range(valid_len)):
        o = o + w[..., s, None] * vals[:, s, :, None]
    return o.to(dt)


@pytest.mark.parametrize("softcap", [None, 3.0])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_attend_tolerance_admits_sum_order_and_sees_faults(dt, softcap):
    """``kv4_attend_allowed`` holds an implementation that sums in another
    order, and breaks for two faults the kernel could make: one slot past
    valid_len attended, and the query heads grouped under the wrong
    kv-head."""
    rng = np.random.default_rng(11)
    slots, valid, g = 40, 33, 3
    cache = _garbage_cache(slots, rng)
    q = _new_token(g, dt, rng)[0][:, 0]
    fp4 = (cache["k"], cache["v"], cache["k_scale"], cache["v_scale"])
    args = (valid, HD ** -0.5, softcap)
    want = tkv4.kv4_attend_plain(q, *fp4, *args)
    allowed = tkv4.kv4_attend_allowed(q, *fp4, *args, want)

    def outside(got):
        return int(((got.double() - want.double()).abs() > allowed).sum())

    assert outside(_attend_other_order(q, *fp4, *args, dt)) == 0
    assert outside(tkv4.kv4_attend_plain(q, *fp4, valid + 1,
                                         *args[1:])) > 0
    swapped = q.reshape(B, g, K, HD).transpose(1, 2).contiguous()
    assert outside(tkv4.kv4_attend_plain(swapped, *fp4, *args)) > 0


def test_attend_shape_limits():
    """The kernel's limits raise ValueError naming them. A cache whose
    G x S f32 logits pass one block's shared memory takes the global
    workspace instead, so any length passes the shape check; the
    shared-memory path forced there raises, naming the limit."""
    tkv4.check_attend_shape(3, 64, 2048)
    tkv4.check_attend_shape(1, 16, 1)
    tkv4.check_attend_shape(3, 64, 20_000)
    tkv4.check_attend_shape(8, 256, 524_288)
    assert tkv4.attend_smem_bytes(3, 64, 64) == 2 * 128 * 48 + 4 * (
        192 + 256 + 64 + 192)
    assert tkv4.attend_smem_bytes(3, 64, 20_000, logits=False) == \
        2 * 128 * 48 + 4 * (192 + 256 + 64)
    assert tkv4.attend_logits_shared(3, 64, 2048)
    assert not tkv4.attend_logits_shared(3, 64, 20_000)
    m = dict(device="meta")
    fp4 = (torch.empty(1, 20_000, 1, 32, dtype=torch.uint8, **m),) * 2 + (
        torch.empty(1, 20_000, 1, dtype=torch.float16, **m),) * 2
    q = torch.empty(1, 1, 3, 64, dtype=torch.bfloat16, **m)
    with pytest.raises(ValueError, match="shared memory"):
        tkv4.kv4_attend_cuda(q, *fp4, 20_000, 0.125, workspace=False)
    with pytest.raises(ValueError, match="multiple of 16"):
        tkv4.check_attend_shape(3, 8, 64)
    with pytest.raises(ValueError, match="1 to 8"):
        tkv4.check_attend_shape(9, 64, 64)
