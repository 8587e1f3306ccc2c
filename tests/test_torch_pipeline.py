"""Port parity: the paper pipeline's search, calibration and plans, the
STE, TALoRA routing, DFA, Adam, the loop samplers, and ``--plan search``.

The port runs on the CPU; the JAX package is the reference. Tolerances:

* Search. Each candidate's qdq equals the reference's bit for bit (the
  compiled form, ``quant/fakequant.py``), so the MSEs differ only in the
  order of the f32 sums of the mean: held within ``tie_bound(n)``
  (``repro_torch.quant.search``: 2 ceil(log2 n) 2^-24 relative). A pick
  (format, maxval, zp) must equal the reference's; where it does not, the
  reference's own MSEs at the two picks must agree within the same bound
  (a near-tie), and such picks are counted and printed.
* exp2. XLA CPU's ``exp2(k)`` is inexact for k in {13, 15, 17, 19, 21,
  23, 25, 26, 27, 29, 30, 31} (jax 0.9.0), which the grids of sE5M2,
  sE4M3, uE5M3 and uE4M0 reach. Those formats are held to a brute-force
  nearest-grid oracle in f64, not to JAX; the port's pick's oracle MSE
  must be within 1e-5 (relative) of the oracle's best (the f32 roundings
  of the port's qdq against f64).
* Calibration. The DB's samples, min, max and counts equal the reference's
  on the same records; from the reference's calibration taps, the port's
  FP forwards differ by f32 sum order, so samples, min and max are held at
  rtol 1e-4, atol 1e-5, with the AAL classes equal.
* STE: forward and gradient bit-exact. Routing, DFA, gamma, Adam, loop
  samplers: stated per test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_forward_close, jx, np_db, np_plan,
                           np_tree, ref_x_T, t, tiny_unet_params)
from repro.common.tree import flatten_paths as jflat
from repro.common.tree import unflatten_paths as junflat
from repro.core import msfp as jmsfp
from repro.core import qmodule as jq
from repro.core import talora as jtal
from repro.core import dfa as jdfa
from repro.diffusion import pipeline as jpipe
from repro.diffusion import samplers as jsamp
from repro.diffusion.schedule import make_schedule as jmake_schedule
from repro.nn.unet import io_sites as jio_sites
from repro.nn.unet import unet_apply as junet_apply
from repro.optim import adam as jadam
from repro.quant import calibrate as jcal
from repro.quant import fakequant as jfq
from repro.quant import formats as jfmt
from repro.quant import search as js
from repro.configs.diffusion_presets import tiny_ddim as jtiny
from repro_torch import convert
from repro_torch.common.tree import flatten_paths, unflatten_paths
from repro_torch.configs.diffusion_presets import tiny_ddim
from repro_torch.core import dfa as tdfa
from repro_torch.core import msfp as tmsfp
from repro_torch.core import qmodule as tq
from repro_torch.core import talora as ttal
from repro_torch.diffusion import pipeline as tpipe
from repro_torch.diffusion import samplers as tsamp
from repro_torch.diffusion.schedule import make_schedule as tmake_schedule
from repro_torch.kernels import ops
from repro_torch.optim import adam as tadam
from repro_torch.quant import calibrate as tcal
from repro_torch.quant import fakequant as tfq
from repro_torch.quant import formats as tfmt
from repro_torch.quant import search as ts

ORACLE_REL = 1e-5
CALIB_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while this file runs: under the suite's parallel
    workers, torch's parallel regions over the search's grids spin against
    each other's threads (a plan test took ten minutes so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(kind: str, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    if kind == "silu":
        return (x / (1 + np.exp(-x))).astype(np.float32)
    if kind == "laplace":
        return rng.laplace(scale=0.7, size=n).astype(np.float32)
    return x


def _exact(fmt) -> bool:
    """The format's grid stays out of the octaves where XLA's exp2 errs."""
    return fmt.exp_bits <= 3


def _near_tie(ref_mses: np.ndarray, i_ref, i_port, n: int) -> int:
    """0 for the same pick; 1 for a near-tie (else the assert fails)."""
    if i_ref == i_port:
        return 0
    a, b = float(ref_mses[i_ref]), float(ref_mses[i_port])
    assert abs(a - b) <= ts.tie_bound(n) * max(a, b), (i_ref, i_port, a, b)
    print(f"near-tie pick: reference {i_ref} ({a!r}), port {i_port} ({b!r})")
    return 1


def _held_grid(j: np.ndarray, p: np.ndarray, n: int) -> int:
    assert j.shape == p.shape
    np.testing.assert_allclose(p, j, rtol=ts.tie_bound(n), atol=0)
    return _near_tie(j.ravel(), int(np.argmin(j)), int(np.argmin(p)), n)


def oracle_qdq(x: np.ndarray, fmt, mv: float, zp: float = 0.0) -> np.ndarray:
    """Brute-force nearest-grid qdq in f64 (no snap arithmetic)."""
    g = np.unique(np.abs(jfmt.enumerate_grid(fmt))) * (mv / fmt.base_max)
    x = np.asarray(x, np.float64)
    y = np.abs(x) if fmt.signed else np.maximum(x - zp, 0.0)
    i = np.clip(np.searchsorted(g, y), 1, len(g) - 1)
    lo, hi = g[i - 1], g[i]
    q = np.where(y - lo <= hi - y, lo, hi)
    q = np.minimum(q, g[-1])
    return np.sign(x) * q if fmt.signed else q + zp


def oracle_mse(x, fmt, mv, zp=0.0) -> float:
    return float(np.mean((np.asarray(x, np.float64)
                          - oracle_qdq(x, fmt, mv, zp)) ** 2))


# ---------------------------------------------------------------------------
# formats, subsample
# ---------------------------------------------------------------------------

def test_encode_to_codes_and_format_names_match_reference():
    x = _data("normal", 3000)
    for name in ("sE2M1", "uE2M2", "sE3M0", "uE4M0", "sE5M2"):
        jf, tf = jfmt.FORMAT_BY_NAME[name], tfmt.FORMAT_BY_NAME[name]
        np.testing.assert_array_equal(tfmt.encode_to_codes(x, tf, 2.5),
                                      jfmt.encode_to_codes(x, jf, 2.5))
    assert (tfmt.format_list_names(tfmt.signed_formats(4))
            == jfmt.format_list_names(jfmt.signed_formats(4)))


@pytest.mark.parametrize("n", [1000, 65536, 100_003, 300_000])
def test_subsample_matches_reference(n):
    x = _data("normal", n)
    np.testing.assert_array_equal(ts._subsample(x, device="cpu").numpy(),
                                  np.asarray(js._subsample(x)))


# ---------------------------------------------------------------------------
# the MSE search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["normal", "silu", "laplace"])
@pytest.mark.parametrize("bits", [4, 8])
def test_signed_grid_and_search_match_reference(kind, bits):
    x = _data(kind, 20000, seed=bits)
    xs = np.asarray(js._subsample(x))
    grid = np.linspace(0.0, float(np.abs(xs).max()), 100)[1:]
    near = 0
    for tf in tfmt.signed_formats(bits):
        jf = jfmt.FORMAT_BY_NAME[tf.name]
        p = ts.mse_signed_grid(t(xs), tf, t(grid.astype(np.float32)))
        if _exact(tf):
            j = np.asarray(js._mse_signed_grid(jx(xs), jf,
                                               jnp.asarray(grid, jnp.float32)))
            near += _held_grid(j, p, xs.size)
        else:   # exp2 octaves: the oracle
            o = np.array([oracle_mse(xs, tf, mv) for mv in grid])
            assert o[int(np.argmin(p))] <= o.min() * (1 + ORACLE_REL)
    if all(_exact(f) for f in tfmt.signed_formats(bits)):
        r = js.search_signed_fp(x, bits)
        q = ts.search_signed_fp(x, bits, device="cpu")
        assert (q.params.fmt.name, float(q.params.maxval)) == \
            (r.params.fmt.name, float(r.params.maxval))
        np.testing.assert_allclose(q.mse, r.mse, rtol=ts.tie_bound(xs.size))
        assert q.per_format.keys() == r.per_format.keys()
    print(f"{kind} {bits}-bit: {near} near-tie picks")


@pytest.mark.parametrize("kind", ["normal", "silu"])
def test_unsigned_grid_and_search_match_reference(kind):
    x = _data(kind, 12000, seed=3)
    xs = np.asarray(js._subsample(x))
    grid = np.linspace(0.0, float(xs.max()), 100)[1:]
    zps = np.linspace(-0.3, 0.0, 6)
    near = 0
    for tf in tfmt.unsigned_formats(4):
        jf = jfmt.FORMAT_BY_NAME[tf.name]
        p = ts.mse_unsigned_grid(t(xs), tf, t(grid.astype(np.float32)),
                                 t(zps.astype(np.float32)))
        if _exact(tf):
            j = np.asarray(js._mse_unsigned_grid(
                jx(xs), jf, jnp.asarray(grid, jnp.float32),
                jnp.asarray(zps, jnp.float32)))
            near += _held_grid(j, p, xs.size)
        else:   # uE4M0 reaches octave 13: the oracle
            o = np.array([[oracle_mse(xs, tf, mv, zp) for zp in zps]
                          for mv in grid])
            assert o.ravel()[int(np.argmin(p))] <= o.min() * (1 + ORACLE_REL)
    exact = [f for f in tfmt.unsigned_formats(4) if _exact(f)]
    r = js.search_unsigned_fp(x, 4, formats=[jfmt.FORMAT_BY_NAME[f.name]
                                             for f in exact])
    q = ts.search_unsigned_fp(x, 4, formats=exact, device="cpu")
    assert (q.params.fmt.name, float(q.params.maxval),
            float(q.params.zero_point)) == (r.params.fmt.name,
                                            float(r.params.maxval),
                                            float(r.params.zero_point))
    np.testing.assert_allclose(q.mse, r.mse, rtol=ts.tie_bound(xs.size))
    print(f"{kind}: {near} near-tie picks")


@pytest.mark.parametrize("kind", ["normal", "silu", "laplace"])
@pytest.mark.parametrize("symmetric", [True, False])
def test_int_affine_search_matches_reference(kind, symmetric):
    x = _data(kind, 30000, seed=5)
    r = js.search_int_affine(x, 4, symmetric=symmetric)
    q = ts.search_int_affine(x, 4, symmetric=symmetric, device="cpu")
    assert float(q.params.maxval) == float(r.params.maxval)
    assert float(q.params.zero_point) == float(r.params.zero_point)
    assert q.params.kind == r.params.kind == jfq.KIND_INT_AFFINE
    np.testing.assert_allclose(q.mse, r.mse, rtol=ts.tie_bound(x.size))


@pytest.mark.parametrize("kind", ["normal", "silu"])
@pytest.mark.parametrize("allow_unsigned", [False, True])
def test_activation_search_matches_reference(kind, allow_unsigned):
    """The mixup-sign selection: SiLU data picks unsigned, normal signed;
    every exact format's best MSE as the reference's, uE4M0's held to the
    oracle's best over its candidates."""
    x = _data(kind, 12000, seed=7)
    r = js.search_activation_params(x, 4, allow_unsigned=allow_unsigned)
    q = ts.search_activation_params(x, 4, allow_unsigned=allow_unsigned,
                                    device="cpu")
    assert q.params.kind == r.params.kind
    assert (q.params.fmt.name, float(q.params.maxval),
            float(q.params.zero_point)) == (r.params.fmt.name,
                                            float(r.params.maxval),
                                            float(r.params.zero_point))
    np.testing.assert_allclose(q.mse, r.mse, rtol=ts.tie_bound(x.size))
    assert q.per_format.keys() == r.per_format.keys()
    for name, v in q.per_format.items():
        if _exact(tfmt.FORMAT_BY_NAME[name]):
            np.testing.assert_allclose(v, r.per_format[name],
                                       rtol=ts.tie_bound(x.size))
        else:
            f = tfmt.FORMAT_BY_NAME[name]
            mvs = np.linspace(0.0, float(x.max()), 100)[1:]
            best = min(oracle_mse(x, f, mv, zp) for mv in mvs
                       for zp in np.linspace(-0.3, 0.0, 6))
            assert abs(v - best) <= ORACLE_REL * best, (name, v, best)
    if allow_unsigned:
        want = (tfq.KIND_FP_UNSIGNED if kind == "silu"
                else tfq.KIND_FP_SIGNED)
        assert q.params.kind == want


@pytest.mark.parametrize("name", ["sE5M2", "sE4M3", "uE5M3", "uE4M0"])
def test_exp2_octave_formats_held_to_grid_oracle(name):
    """Where XLA's exp2 errs the port is held to the nearest grid point."""
    f = tfmt.FORMAT_BY_NAME[name]
    x = np.concatenate([_data("laplace", 4000, 1),
                        _data("normal", 4000, 2) * 1e-3])
    mv, zp = 2.75, (0.0 if f.signed else -0.25)
    got = tfq.fp_qdq(t(x), f, mv, zp).numpy().astype(np.float64)
    want = oracle_qdq(x, f, mv, zp)
    # two f32 roundings of the terms of q * s + zp
    bound = 2.0**-22 * (np.abs(want - zp) + abs(zp))
    assert (np.abs(got - want) <= bound).all()


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def test_calibration_db_matches_reference():
    """Records that overflow the cap (merge and re-stride), min/max/n_seen,
    the asymmetry and AAL classes, on identical inputs."""
    jdb, tdb = jcal.CalibrationDB(sample_cap=1000), tcal.CalibrationDB(1000)
    rng = np.random.default_rng(0)
    for i in range(5):
        for site, kind in (("a", "silu"), ("b", "normal"), ("c", "relu")):
            x = _data("silu" if kind == "silu" else "normal", 700 + 311 * i,
                      seed=10 * i + len(site)).reshape(-1, 1)
            if kind == "relu":
                x = np.maximum(x, 0) + rng.normal(size=x.shape) * 1e-3
            x = x.astype(np.float32)
            jdb.record(site, jnp.asarray(x))
            tdb.record(site, torch.from_numpy(x))
    for k, s in jdb.sites.items():
        u = tdb.sites[k]
        np.testing.assert_array_equal(u.samples, s.samples)
        assert (u.x_min, u.x_max, u.n_seen) == (s.x_min, s.x_max, s.n_seen)
        assert u.asymmetry == s.asymmetry
    assert tdb.classify() == jdb.classify()
    assert tdb.summary() == jdb.summary()
    # the converted DB is the same DB
    cdb = convert.calibration_db_from_numpy(np_db(jdb))
    for k, s in jdb.sites.items():
        np.testing.assert_array_equal(cdb.sites[k].samples, s.samples)
    assert cdb.classify() == jdb.classify()


def test_quant_context_modes():
    for mode in tcal.MODES:
        if mode != "collect":
            tcal.QuantContext(mode)
    with pytest.raises(ValueError):
        tcal.QuantContext("collect")
    with pytest.raises(ValueError):
        tcal.QuantContext("bogus")


@pytest.fixture(scope="module")
def tiny():
    return tiny_setup()


def tiny_setup():
    """tiny_ddim(8), the reference's calibration taps (x_T injected into
    the port), the reference's DB at a small sample cap, and its plan."""
    cfg_j, cfg_t = jtiny(8), tiny_ddim(8)
    jp, tp = tiny_unet_params(8, seed=0)
    jsched, tsched = jmake_schedule("linear", 50), tmake_schedule("linear", 50)
    key = jax.random.PRNGKey(3)
    calib = jpipe.build_calibration_set(jp, cfg_j, jsched, key, n_samples=4,
                                        steps=4, batch=2)
    x_Ts, k = [], key
    for _ in range(2):   # build_calibration_set's key split per batch
        k, kb = jax.random.split(k)
        x_Ts.append(ref_x_T(kb, (2, 8, 8, 3)))
    tcalib = tpipe.build_calibration_set(tp, cfg_t, tsched, n_samples=4,
                                         steps=4, batch=2,
                                         x_T=[torch.from_numpy(x)
                                              for x in x_Ts])
    jdb = jcal.CalibrationDB(sample_cap=1024)
    ctx = jcal.QuantContext("collect", db=jdb)
    for tt, x in calib[:4]:
        junet_apply(jp, jnp.asarray(x), jnp.full((x.shape[0],), tt,
                                                 jnp.float32), cfg_j, ctx=ctx)
    jw = {k: v for k, v in jflat(jp).items() if k.endswith("/w")}
    jplan = jmsfp.build_mixed_plan(jw, jdb, io_sites=jio_sites(jp))
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, jp=jp, tp=tp, jsched=jsched,
                tsched=tsched, calib=calib, tcalib=tcalib, jdb=jdb, jw=jw,
                jplan=jplan, jq_w=jmsfp.quantize_weight_tree(jw, jplan))


def test_calibration_set_matches_reference(tiny):
    """The reference's x_T injected: the same taps, within CALIB_TOL."""
    assert [tt for tt, _ in tiny["tcalib"]] == [tt for tt, _ in tiny["calib"]]
    for (_, a), (_, b) in zip(tiny["tcalib"], tiny["calib"]):
        np.testing.assert_allclose(a.numpy(), b, **CALIB_TOL)


def test_calibrate_activations_matches_reference(tiny):
    jdb = jpipe.calibrate_activations(tiny["jp"], tiny["cfg_j"], tiny["calib"])
    tdb = tpipe.calibrate_activations(tiny["tp"], tiny["cfg_t"],
                                      [(tt, x) for tt, x in tiny["calib"]])
    assert list(tdb.sites) == list(jdb.sites)
    for k, s in jdb.sites.items():
        u = tdb.sites[k]
        assert u.n_seen == s.n_seen
        np.testing.assert_allclose(u.samples, s.samples, **CALIB_TOL)
        np.testing.assert_allclose([u.x_min, u.x_max], [s.x_min, s.x_max],
                                   **CALIB_TOL)
    assert tdb.classify() == jdb.classify()
    assert any(tdb.classify().values()) and not all(tdb.classify().values())


def _ref_mse_at(samples, qp) -> float:
    """The reference's own MSE at a (port) pick, on the site's samples."""
    xs = js._subsample(samples)
    jqp = jfq.QuantizerParams(qp.kind, qp.exp_bits, qp.man_bits, qp.bits,
                              jnp.float32(float(qp.maxval)),
                              jnp.float32(float(qp.zero_point)))
    f = jax.jit(lambda x: jnp.mean((x - jfq.apply_qdq(x, jqp)) ** 2))
    return float(f(xs))


@pytest.mark.parametrize("mode", jmsfp.PLAN_MODES)
def test_build_mixed_plan_matches_reference(tiny, mode):
    """From a converted DB and the same weights, every site's kind,
    format, bits, maxval, zp and AAL class as the reference's (near-ties
    counted); the 8-bit io sites, whose formats reach exp2's octaves, held
    to the oracle."""
    jdb, jw = tiny["jdb"], tiny["jw"]
    tdb = convert.calibration_db_from_numpy(np_db(jdb))
    tw = {k: v for k, v in flatten_paths(tiny["tp"]).items()
          if k.endswith("/w")}
    io = jio_sites(tiny["jp"])
    jplan = (tiny["jplan"] if mode == "msfp" else
             jmsfp.build_mixed_plan(jw, jdb, mode=mode, io_sites=io))
    tplan = tmsfp.build_mixed_plan(tw, tdb, mode=mode, io_sites=io,
                                   device="cpu")
    assert list(tplan.sites) == list(jplan.sites)
    assert tplan.summary() == jplan.summary()
    near = 0
    for k, s in jplan.sites.items():
        u = tplan.sites[k]
        assert (u.is_weight, u.is_aal, u.qp.bits) == \
            (s.is_weight, s.is_aal, s.qp.bits), k
        same = ((u.qp.kind, u.qp.exp_bits, u.qp.man_bits,
                 float(u.qp.maxval), float(u.qp.zero_point))
                == (s.qp.kind, s.qp.exp_bits, s.qp.man_bits,
                    float(s.qp.maxval), float(s.qp.zero_point)))
        samples = (np.asarray(jw[k]) if s.is_weight
                   else jdb.sites[k].samples)
        if k in io:
            if mode == "signed_zp" and not s.is_weight:
                samples = samples - float(u.qp.zero_point)
            if u.qp.kind != jfq.KIND_INT_AFFINE and not same:
                xs = np.asarray(js._subsample(samples))
                got = oracle_mse(xs, u.qp.fmt, float(u.qp.maxval),
                                 float(u.qp.zero_point)
                                 if u.qp.is_unsigned else 0.0)
                ref = oracle_mse(xs, s.qp.fmt, float(s.qp.maxval),
                                 float(s.qp.zero_point)
                                 if s.qp.is_unsigned else 0.0)
                assert got <= ref * (1 + ORACLE_REL), (k, got, ref)
                near += 1
            continue
        n = js._subsample(samples).size
        if not same:
            if mode == "signed_zp" and not s.is_weight:
                assert float(u.qp.zero_point) == float(s.qp.zero_point), k
                samples = samples - float(u.qp.zero_point)
                u_qp = dataclasses.replace(u.qp, zero_point=torch.tensor(0.))
                s_qp = dataclasses.replace(s.qp, zero_point=jnp.float32(0.))
            else:
                u_qp, s_qp = u.qp, s.qp
            a, b = _ref_mse_at(samples, s_qp), _ref_mse_at(samples, u_qp)
            assert abs(a - b) <= ts.tie_bound(n) * max(a, b), (k, a, b)
            near += 1
            continue
        np.testing.assert_allclose(u.mse, s.mse, rtol=ts.tie_bound(n), atol=0)
    print(f"{mode}: {near} of {len(jplan.sites)} sites picked apart "
          "(near-ties, or io sites held to the oracle)")
    assert near <= max(2, len(jplan.sites) // 10)


def test_plan_converts_and_quantize_weight_tree_is_eager(tiny):
    """A converted plan keeps every field; the weights' fake-quant is the
    reference's eager one bit for bit on the exact formats, and the
    wide-exponent io weights lie on their grid (oracle)."""
    jw, jplan = tiny["jw"], tiny["jplan"]
    tplan = convert.plan_from_numpy(np_plan(jplan), "cpu")
    for k, s in jplan.sites.items():
        u = tplan.sites[k]
        assert (u.qp.kind, u.qp.exp_bits, u.qp.man_bits, u.qp.bits,
                float(u.qp.maxval), float(u.qp.zero_point), u.is_weight,
                u.is_aal, u.mse) == (
            s.qp.kind, s.qp.exp_bits, s.qp.man_bits, s.qp.bits,
            float(s.qp.maxval), float(s.qp.zero_point), s.is_weight,
            s.is_aal, s.mse)
    assert tmsfp.plan_mse_report(tplan) == jmsfp.plan_mse_report(jplan)
    jq_w = tiny["jq_w"]
    tq_w = tmsfp.quantize_weight_tree(
        {k: t(np.asarray(v)) for k, v in jw.items()}, tplan)
    for k, v in jq_w.items():
        qp = tplan.sites[k].qp
        if _exact(qp.fmt):
            np.testing.assert_array_equal(tq_w[k].numpy(), np.asarray(v))
        else:
            want = oracle_qdq(np.asarray(jw[k]), qp.fmt, float(qp.maxval))
            np.testing.assert_allclose(tq_w[k].numpy(), want, rtol=2.0**-22)


def _exact_plan(jplan):
    """The plan with every wide-exponent (exp2-octave) format replaced by
    sE2M5/uE2M6 at the same maxval, for holding forwards against JAX."""
    sites = {}
    for k, s in jplan.sites.items():
        qp = s.qp
        if qp.kind != jfq.KIND_INT_AFFINE and qp.exp_bits > 3:
            m = qp.bits - 2 - (1 if qp.kind == jfq.KIND_FP_SIGNED else 0)
            qp = dataclasses.replace(qp, exp_bits=2, man_bits=m)
        sites[k] = dataclasses.replace(s, qp=qp)
    return jmsfp.QuantPlan(sites, jplan.bits_w, jplan.bits_a, jplan.mode)


def test_quantize_mode_forward_matches_jitted_reference(tiny):
    """The student's forward under a searched plan (quantize mode, STE act
    fake-quant) against the reference's jitted forward, with and without
    TALoRA merged: the whole-forward tolerance of assert_forward_close."""
    jw = tiny["jw"]
    jplan = _exact_plan(tiny["jplan"])
    jqw = jmsfp.quantize_weight_tree(jw, jplan)
    flat = dict(jflat(tiny["jp"]))
    flat.update(jqw)
    jq_params = junflat(flat)
    tcfg = jtal.TALoRAConfig(hub_size=2, rank=4, t_emb_dim=32,
                             router_hidden=16)
    dims = jtal.lora_target_dims_from_weights(jqw)
    hubs = jtal.init_lora_hub(jax.random.PRNGKey(1), dims, tcfg)
    # B != 0, small beside the weights: a merged weight of the random
    # UNet that the adapters dominate turns the ulps of A_sel @ B_sel's
    # sum order into act-grid ties everywhere
    hubs = {k: {"A": h["A"], "B": 1e-3 * jax.random.normal(
        jax.random.PRNGKey(2), h["B"].shape)} for k, h in hubs.items()}
    router = jtal.init_router(jax.random.PRNGKey(3), len(dims), tcfg)
    jb = jpipe.QuantizedDiffusion(tiny["cfg_j"], tiny["jsched"], tiny["jp"],
                                  jq_params, jplan, tcfg, hubs, router)
    tb = tpipe.QuantizedDiffusion(
        tiny["cfg_t"], tiny["tsched"], tiny["tp"],
        convert.from_numpy_tree(np_tree(jq_params), "cpu"),
        convert.plan_from_numpy(np_plan(jplan), "cpu"),
        ttal.TALoRAConfig(hub_size=2, rank=4, t_emb_dim=32,
                          router_hidden=16),
        convert.from_numpy_tree(np_tree(hubs), "cpu"),
        convert.from_numpy_tree(np_tree(router), "cpu"))
    x = np.random.default_rng(4).normal(size=(3, 8, 8, 3)).astype(np.float32)
    ts_ = np.array([40.0, 40.0, 7.0], np.float32)   # mixed: routed per t
    ctx = jcal.QuantContext("quantize", plan=jplan,
                            act_fn=jmsfp.quantize_act)
    fwd = jax.jit(lambda p, xx, tt: junet_apply(p, xx, tt, tiny["cfg_j"],
                                                ctx=ctx))
    want = fwd(jq_params, jx(x), jx(ts_))
    with torch.no_grad():
        got = dataclasses.replace(tb, hubs=None, router=None).student_eps(
            t(x), t(ts_))
    assert_forward_close(got.numpy(), np.asarray(want))
    # TALoRA merged per distinct timestep: three timesteps, one sample
    # each, so each group's forward has the reference's batch (the conv's
    # f32 sum order follows the batch size, and its ulps flip act-grid
    # ties: a batch of 2 against 1 reads 0.003)
    ts_ = np.array([40.0, 7.0, 23.0], np.float32)
    want = np.concatenate([np.asarray(jax.jit(
        lambda xx, tt: jb.student_eps(xx, tt))(jx(x[i:i + 1]),
                                               jx(ts_[i:i + 1])))
        for i in range(3)])
    with torch.no_grad():
        got = tb.student_eps(t(x), t(ts_))
    assert_forward_close(got.numpy(), want)


# ---------------------------------------------------------------------------
# the STE, TALoRA routing
# ---------------------------------------------------------------------------

STE_QPS = [(0, 2, 1, 4, 2.5, 0.0), (1, 2, 2, 4, 3.0, -0.25),
           (1, 3, 1, 4, 1.7, -0.3), (0, 0, 3, 4, 1.1, 0.0),
           (0, 2, 5, 8, 4.0, 0.0), (2, 0, 0, 4, 2.2, -0.6)]


@pytest.mark.parametrize("kind,e,m,bits,mv,zp", STE_QPS)
def test_ste_qdq_forward_and_grad_bit_exact(kind, e, m, bits, mv, zp):
    """Forward against the jitted reference, gradient against jax.grad, at
    random points and on both ends of the range."""
    rng = np.random.default_rng(kind * 10 + e)
    jqp = jfq.QuantizerParams(kind, e, m, bits, jnp.float32(mv),
                              jnp.float32(zp))
    tqp = convert.quantizer_params_from_numpy(
        {"kind": kind, "exp_bits": e, "man_bits": m, "bits": bits,
         "maxval": mv, "zero_point": zp}, "cpu")
    lo, hi = (np.float32(zp), np.float32(mv) + np.float32(zp)) \
        if kind == 1 else (-np.float32(mv), np.float32(mv))
    x = np.concatenate([rng.normal(size=3000).astype(np.float32) * 2.5,
                        [lo, hi, np.nextafter(lo, -np.inf),
                         np.nextafter(hi, np.inf)]]).astype(np.float32)
    c = rng.normal(size=x.shape).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jfq.ste_qdq(a, jqp))(jx(x)))
    wgrad = np.asarray(jax.grad(lambda a: jnp.sum(
        jfq.ste_qdq(a, jqp) * jx(c)))(jx(x)))
    tx = t(x).requires_grad_(True)
    out = tfq.ste_qdq(tx, tqp)
    (gx,) = torch.autograd.grad((out * t(c)).sum(), tx)
    np.testing.assert_array_equal(out.detach().numpy(), want)
    np.testing.assert_array_equal(gx.numpy(), wgrad)
    assert 0 < (wgrad == 0).sum() < x.size   # the clip mask cuts


def test_ste_qdq_routes_through_k1_for_fp():
    ops.reset_routes()
    qp = tfq.QuantizerParams(tfq.KIND_FP_SIGNED, 2, 1, 4, torch.tensor(3.0))
    tfq.ste_qdq(torch.randn(4, 5, generator=torch.Generator().manual_seed(0)),
                qp)
    assert ops.ROUTES == {("msfp_quantize", "plain"): 1}
    ops.reset_routes()
    iq = tfq.QuantizerParams(tfq.KIND_INT_AFFINE, 0, 0, 4, torch.tensor(3.0),
                             torch.tensor(-1.0))
    tfq.ste_qdq(torch.zeros(3), iq)
    assert not ops.ROUTES    # INT-affine stays plain


def test_route_and_ste_one_hot_match_reference():
    """Forward selections and the router's gradients through the softmax
    STE (rtol 1e-5: softmax, tanh and the embedding's cos/sin differ by
    ulps between XLA and torch)."""
    cfg_j = jtal.TALoRAConfig(hub_size=3, rank=2, t_emb_dim=16,
                              router_hidden=8)
    cfg_t = ttal.TALoRAConfig(hub_size=3, rank=2, t_emb_dim=16,
                              router_hidden=8)
    names = [f"l{i}" for i in range(5)]
    router = jtal.init_router(jax.random.PRNGKey(0), 5, cfg_j)
    trouter = convert.from_numpy_tree(np_tree(router), "cpu")
    c = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    for tt in (0.0, 17.0, 333.0, 999.0):
        sel_j = jtal.route(router, jnp.float32(tt), names, cfg_j)
        sel_t = ttal.route(trouter, torch.tensor(tt), names, cfg_t)
        for n in names:
            np.testing.assert_allclose(sel_t[n].detach().numpy(),
                                       np.asarray(sel_j[n]), rtol=1e-6,
                                       atol=1e-7)
            assert np.argmax(sel_t[n].detach().numpy()) == \
                np.argmax(np.asarray(sel_j[n]))

        def jl(r):
            s = jtal.route(r, jnp.float32(tt), names, cfg_j)
            return jnp.sum(jnp.stack([s[n] for n in names]) * jx(c))
        gj = jax.grad(jl)(router)
        tr = {k: v.clone().requires_grad_(True) for k, v in trouter.items()}
        s = ttal.route(tr, torch.tensor(tt), names, cfg_t)
        loss = (torch.stack([s[n] for n in names]) * t(c)).sum()
        gt = torch.autograd.grad(loss, [tr[k] for k in sorted(tr)])
        for k, g in zip(sorted(tr), gt):
            np.testing.assert_allclose(g.numpy(), np.asarray(gj[k]),
                                       rtol=1e-5, atol=1e-6)
    logits = np.random.default_rng(1).normal(size=(4, 3)).astype(np.float32)
    np.testing.assert_allclose(
        ttal.ste_one_hot(t(logits)).numpy(),
        np.asarray(jtal.ste_one_hot(jx(logits))), rtol=1e-6, atol=1e-7)
    hist_j = jtal.allocation_histogram(router, jnp.arange(0, 1000, 50.0),
                                       names, cfg_j)
    hist_t = ttal.allocation_histogram(trouter, np.arange(0, 1000, 50.0),
                                       names, cfg_t)
    np.testing.assert_array_equal(hist_t.numpy(), np.asarray(hist_j))


def test_lora_apply_and_merged_weight_match_reference():
    cfg_j = jtal.TALoRAConfig(hub_size=2, rank=4, alpha=8.0)
    cfg_t = ttal.TALoRAConfig(hub_size=2, rank=4, alpha=8.0)
    rng = np.random.default_rng(1)
    w = rng.normal(size=(12, 10)).astype(np.float32)
    hub = {"A": rng.normal(size=(2, 12, 4)).astype(np.float32),
           "B": rng.normal(size=(2, 4, 10)).astype(np.float32)}
    thub = {k: t(v) for k, v in hub.items()}
    jhub = {k: jx(v) for k, v in hub.items()}
    x = rng.normal(size=(5, 12)).astype(np.float32)
    sel = np.array([0.0, 1.0], np.float32)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        ttal.lora_apply(t(x), t(w), thub, t(sel), cfg_t).numpy(),
        np.asarray(jtal.lora_apply(jx(x), jx(w), jhub, jx(sel), cfg_j)),
        **tol)
    np.testing.assert_allclose(
        ttal.merged_weight(t(w), thub, t(sel), cfg_t).numpy(),
        np.asarray(jtal.merged_weight(jx(w), jhub, jx(sel), cfg_j)), **tol)
    # merged forward == branch forward, and merge_into_tree stays
    # differentiable in the hub (not in the base weight)
    np.testing.assert_allclose(
        (t(x) @ ttal.merged_weight(t(w), thub, t(sel), cfg_t)).numpy(),
        ttal.lora_apply(t(x), t(w), thub, t(sel), cfg_t).numpy(), **tol)
    a = thub["A"].clone().requires_grad_(True)
    wq = t(w).requires_grad_(True)
    tree = ttal.merge_into_tree({"lin": {"w": wq}}, {"lin/w": {
        "A": a, "B": thub["B"]}}, {"lin/w": t(sel)}, cfg_t)
    (ga,) = torch.autograd.grad((t(x) @ tree["lin"]["w"]).sum(), a)
    assert ga.abs().sum() > 0
    assert tree["lin"]["w"].grad_fn is not None


# ---------------------------------------------------------------------------
# DFA, gamma, Adam, loop samplers
# ---------------------------------------------------------------------------

def test_gamma_and_dfa_losses_match_reference():
    js_, ts_ = jmake_schedule("linear", 100), tmake_schedule("linear", 100)
    np.testing.assert_array_equal(ts_.gamma().numpy(),
                                  np.asarray(js_.gamma()))
    rng = np.random.default_rng(2)
    a = rng.normal(size=(4, 8, 8, 3)).astype(np.float32)
    b = a + 0.1 * rng.normal(size=a.shape).astype(np.float32)
    g = np.asarray(js_.gamma())[[99, 50, 10, 0]]
    for jf, tf, args in ((jdfa.dfa_loss, tdfa.dfa_loss, (g,)),
                         (jdfa.plain_loss, tdfa.plain_loss, ()),
                         (jdfa.eps_mse, tdfa.eps_mse, ()),
                         (jdfa.denoising_gap, tdfa.denoising_gap, ())):
        np.testing.assert_allclose(
            tf(t(a), t(b), *map(t, args)).numpy(),
            np.asarray(jf(jx(a), jx(b), *map(jx, args))), rtol=1e-6)


def _tree(rng, scale):
    return {"hubs": {"down.res/conv1/w": {
        "A": (rng.normal(size=(2, 9, 3)) * scale).astype(np.float32),
        "B": (rng.normal(size=(2, 3, 4)) * scale).astype(np.float32)},
        "mid.attn/q/w": {"A": (rng.normal(size=(2, 4, 3)) * scale
                               ).astype(np.float32),
                         "B": np.zeros((2, 3, 4), np.float32)}},
        "router": {"w1": (rng.normal(size=(5, 6)) * scale).astype(np.float32),
                   "b1": np.zeros(6, np.float32)}}


@pytest.mark.parametrize("schedule", ["constant", "linear_warmup_cosine"])
def test_adam_update_three_steps_with_clipping(schedule):
    """Three steps from the converted state, the gradients large enough to
    clip: grad_norm and lr within rtol 1e-6, params and moments within
    rtol 1e-6 plus 1e-6 of each leaf's largest magnitude (pow, and XLA's
    FMA contraction of the moment updates, round differently, and a
    moment's two terms can cancel)."""
    rng = np.random.default_rng(0)
    kw = dict(lr=1e-2, clip_norm=1.0, weight_decay=0.01, schedule=schedule,
              warmup_steps=2, total_steps=10)
    jcfg, tcfg = jadam.AdamConfig(**kw), tadam.AdamConfig(**kw)
    params = _tree(rng, 1.0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = convert.from_numpy_tree(params, "cpu")
    jst = jadam.adam_init(jp, jcfg)
    tst = convert.adam_state_from_numpy(np_tree(jst), "cpu")
    for step in range(3):
        g = _tree(np.random.default_rng(step + 1), 3.0)
        jp, jst, jm = jadam.adam_update(jax.tree.map(jnp.asarray, g), jst,
                                        jp, jcfg)
        tp, tst, tm = tadam.adam_update(convert.from_numpy_tree(g, "cpu"),
                                        tst, tp, tcfg)
        assert float(jm["grad_norm"]) > 1.0     # clipping engaged
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        assert int(tst["step"]) == int(jst["step"])
        for a, b in ((tp, jp), (tst["m"], jst["m"]), (tst["v"], jst["v"])):
            fa, fb = flatten_paths(a), flatten_paths(np_tree(b))
            assert fa.keys() == fb.keys()
            for k in fa:   # a moment's update can cancel: atol by leaf
                np.testing.assert_allclose(
                    fa[k].numpy(), fb[k], rtol=1e-6,
                    atol=1e-6 * float(np.abs(fb[k]).max()))
    ema_t, ema_j = tadam.EMA(0.9), jadam.EMA(0.9)
    np.testing.assert_allclose(
        flatten_paths(ema_t.update(ema_t.init(tp), tp))["router/w1"].numpy(),
        np.asarray(ema_j.update(ema_j.init(jp), jp)["router"]["w1"]),
        rtol=1e-6)


def _eps_fns():
    def j_eps(x, tt):
        return 0.3 * jnp.sin(x) + (tt / 100.0)[:, None, None, None] * 0.1

    def t_eps(x, tt):
        return 0.3 * torch.sin(x) + (tt / 100.0)[:, None, None, None] * 0.1
    return j_eps, t_eps


@pytest.mark.parametrize("sampler,steps", [("ddim", 7), ("plms", 9),
                                           ("dpm_solver2", 6)])
def test_loop_samplers_match_reference(sampler, steps):
    """x_T injected; rtol 1e-5 (the f32 coefficient arithmetic is the
    reference's, sin differs by ulps)."""
    j_eps, t_eps = _eps_fns()
    js_, ts_ = jmake_schedule("linear", 100), tmake_schedule("linear", 100)
    key, shape = jax.random.PRNGKey(5), (2, 4, 4, 3)
    x_T = torch.from_numpy(ref_x_T(key, shape))
    jout = jsamp.SAMPLERS[sampler](j_eps, js_, shape, key, steps=steps)
    tout = tsamp.SAMPLERS[sampler](t_eps, ts_, shape, steps=steps, x_T=x_T)
    if sampler == "ddim":
        (jout, jtaps), (tout, ttaps) = jout, tout
        assert not jtaps and not ttaps
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    if sampler == "ddim":
        _, jtaps = jsamp.ddim_sample(j_eps, js_, shape, key, steps=steps,
                                     collect_every=2)
        _, ttaps = tsamp.ddim_sample(t_eps, ts_, shape, steps=steps,
                                     collect_every=2, x_T=x_T)
        assert [a for a, _ in ttaps] == [a for a, _ in jtaps]
        for (_, a), (_, b) in zip(ttaps, jtaps):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# --plan search
# ---------------------------------------------------------------------------

def test_searched_plan_packs_equal_reference_bytes(tiny):
    """A converted searched plan: the port's fake-quant then W4 pack gives
    the reference's bytes, scales and zero-points (every third 4-bit site,
    dense and conv; the reference packs eagerly, about 0.5 s a site), and
    the port's tree packs exactly the 4-bit sites."""
    jplan = tiny["jplan"]
    tplan = convert.plan_from_numpy(np_plan(jplan), "cpu")
    tw = {k: v for k, v in flatten_paths(tiny["tp"]).items()
          if k.endswith("/w")}
    tq_w = tmsfp.quantize_weight_tree(tw, tplan)
    four = [k for k, s in jplan.sites.items()
            if s.is_weight and s.qp.bits == 4]
    for k in four[::3]:
        want = jq.pack_weight(tiny["jq_w"][k], jplan.sites[k].qp)
        got = tq.pack_weight(tq_w[k], tplan.sites[k].qp)
        np.testing.assert_array_equal(got.packed.numpy(),
                                      np.asarray(want.packed))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(want.scale))
        np.testing.assert_array_equal(got.zero_point.numpy(),
                                      np.asarray(want.zero_point))
        assert got.shape == tuple(want.shape)
    tflat = dict(flatten_paths(tiny["tp"]))
    tflat.update(tq_w)
    packed = flatten_paths(tq.quantize_param_tree(unflatten_paths(tflat),
                                                  tplan))
    assert sorted(k for k, v in packed.items()
                  if isinstance(v, tq.PackedW4)) == sorted(four)


def test_launcher_plan_search_on_cpu(monkeypatch):
    """``--plan search`` on the CPU: the pipeline, the bank on the searched
    plan, the serve run (finite x0 or the launcher raises), every route a
    kernel's plain version. The calibration DB keeps 4096 samples a site
    (the reference's 32768 would make the CPU search the test's cost)."""
    from repro_torch.launch import serve_diffusion
    monkeypatch.setattr(tpipe, "CalibrationDB",
                        lambda: tcal.CalibrationDB(4096))
    ops.reset_routes()
    out = serve_diffusion.main([
        "--device", "cpu", "--preset", "tiny-ddim", "--image-size", "8",
        "--plan", "search", "--smoke", "--replay-clock", "virtual",
        "--scenario", "steady"])
    assert out["evals"] > 0
    routes = {r for _, r in ops.ROUTES}
    assert routes <= {"plain", "plain:implicit"}, ops.ROUTES
