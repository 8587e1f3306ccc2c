"""Helpers shared by the tests/test_torch_*.py parity suites.

Both packages get the same inputs as numpy; JAX stays on the CPU. The port
(``repro_torch``) runs on the CPU here, where every kernel wrapper takes its
plain PyTorch version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.qmodule import PackedW4 as JPackedW4
from repro_torch.core.qmodule import PackedW4 as TPackedW4
from repro_torch.configs.diffusion_presets import tiny_ddim
from repro_torch.convert import from_numpy_tree
from repro_torch.nn.unet import unet_init
from repro_torch.quant.fakequant import QuantizerParams as TQP


def tiny_unet_params(size=8, seed=0):
    """Random tiny-ddim params as (JAX tree, port tree): the JAX tree is
    handed to the port through ``convert.from_numpy_tree``, so both
    packages run the same numbers. The values come from the port's seeded
    init, which costs no JAX compile (the reference's eager init does)."""
    tp = unet_init(torch.Generator().manual_seed(seed), tiny_ddim(size))
    jp = jax.tree.map(lambda v: jnp.asarray(v.numpy()), tp)
    return jp, from_numpy_tree(np_tree(jp), "cpu")


def j_packed(pw):
    """A port PackedW4 as the reference's (the bytes are held identical by
    tests/test_torch_quant.py and the weight-bank test)."""
    return JPackedW4(jnp.asarray(pw.packed.numpy()),
                     jnp.asarray(pw.scale.numpy()),
                     jnp.asarray(pw.zero_point.numpy()),
                     pw.exp_bits, pw.man_bits, pw.signed, tuple(pw.shape))


def np_tree(tree):
    """A JAX tree as nested dicts of numpy arrays (what convert takes)."""
    return jax.tree.map(np.asarray, tree)


def t_qp(qp):
    """A JAX QuantizerParams as the port's (CPU tensors)."""
    return TQP(qp.kind, qp.exp_bits, qp.man_bits, qp.bits,
               torch.from_numpy(np.asarray(qp.maxval, np.float32)),
               torch.from_numpy(np.asarray(qp.zero_point, np.float32)))


def t_plan(plan):
    """A JAX QuantPlan as the port's (CPU tensors)."""
    from repro_torch.core.msfp import QuantPlan, SiteInfo
    sites = {k: SiteInfo(t_qp(s.qp), s.is_weight, s.is_aal, s.mse)
             for k, s in plan.sites.items()}
    return QuantPlan(sites, plan.bits_w, plan.bits_a, plan.mode)


def t_packed(pw):
    return TPackedW4(torch.from_numpy(np.asarray(pw.packed)),
                     torch.from_numpy(np.asarray(pw.scale, np.float32)),
                     torch.from_numpy(np.asarray(pw.zero_point, np.float32)),
                     pw.exp_bits, pw.man_bits, pw.signed, tuple(pw.shape))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def jx(a):
    return jnp.asarray(np.asarray(a))


def assert_forward_close(got, want, *, rel_frob=1e-3, frac=0.01, atol=1e-4):
    """The whole-forward tolerance: relative Frobenius error <= rel_frob
    and at most ``frac`` of the elements off by more than ``atol``. A one-ulp
    difference in a sum can move an activation across a snap midpoint and
    one element by a whole grid step, so elementwise allclose is wrong."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    off = np.mean(np.abs(got - want) > atol)
    assert err <= rel_frob, f"relative Frobenius error {err:.3g}"
    assert off <= frac, f"{off:.3%} of elements off by more than {atol}"


# ---------------------------------------------------------------------------
# The paper pipeline's state as numpy (what repro_torch.convert takes)
# ---------------------------------------------------------------------------

def np_qp(qp):
    return {"kind": qp.kind, "exp_bits": qp.exp_bits,
            "man_bits": qp.man_bits, "bits": qp.bits,
            "maxval": np.asarray(qp.maxval, np.float32),
            "zero_point": np.asarray(qp.zero_point, np.float32)}


def np_plan(plan):
    """A JAX QuantPlan as the nested mappings convert.plan_from_numpy takes."""
    return {"sites": {k: {"qp": np_qp(s.qp), "is_weight": s.is_weight,
                          "is_aal": s.is_aal, "mse": s.mse,
                          "diagnostics": dict(s.diagnostics)}
                      for k, s in plan.sites.items()},
            "bits_w": plan.bits_w, "bits_a": plan.bits_a, "mode": plan.mode}


def np_db(db):
    """A JAX CalibrationDB as convert.calibration_db_from_numpy takes it."""
    return {"sample_cap": db.sample_cap,
            "sites": {k: {"samples": s.samples, "x_min": s.x_min,
                          "x_max": s.x_max, "n_seen": s.n_seen}
                      for k, s in db.sites.items()}}


def ref_x_T(key, shape):
    """The x_T the reference's sampler_init draws from ``key``."""
    _, k0 = jax.random.split(key)
    return np.asarray(jax.random.normal(k0, shape))


# ---------------------------------------------------------------------------
# A reference launcher's report layout, read from its source
# ---------------------------------------------------------------------------

def report_layout(path, func: str = "main", var: str = "report") -> dict:
    """The keys of the dict literal assigned to ``var`` in ``func`` of the
    module at ``path``: key -> None, or key -> the layout of a dict literal
    value, or key -> {"*": layout} for a dict comprehension whose values
    are such literals. Running the reference's launchers takes over a
    minute of jit compiles on the CPU; their report is one literal, so its
    keys are read from the source."""
    import ast
    import pathlib

    def layout(node):
        if isinstance(node, ast.DictComp):
            entry = layout(node.value)
            return None if entry is None else {"*": entry}
        if not isinstance(node, ast.Dict):
            return None
        return {k.value: layout(v) for k, v in zip(node.keys, node.values)
                if isinstance(k, ast.Constant)}

    tree = ast.parse(pathlib.Path(path).read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == var):
            return layout(node.value)
    raise LookupError(f"no {var} = {{...}} in {path}:{func}")


def assert_layout(got: dict, want: dict, where: str = "report") -> None:
    """``got`` (a report) has exactly ``want``'s keys at every level
    ``want`` spells out (``report_layout``)."""
    if set(want) == {"*"}:
        for name, entry in got.items():
            assert_layout(entry, want["*"], f"{where}.{name}")
        return
    assert sorted(got) == sorted(want), where
    for k, sub in want.items():
        if sub is not None:
            assert_layout(got[k], sub, f"{where}.{k}")
