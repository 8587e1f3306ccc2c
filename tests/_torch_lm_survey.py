"""Survey: how far the port's teacher-forced LM decode drifts from the JAX
package's on the CPU when the two sum in different orders.

    PYTHONPATH=src:tests python tests/_torch_lm_survey.py

For each smoke config, model dtype, KV cache, act quant and weight kind
(random, or ``dyadic``: exact W4A4 sums, see
``repro_torch.launch.steps.dyadic_weights``) it runs 8 teacher-forced
decode steps on three seeds, both sides from an empty cache, and prints per seed the
max abs logit error over max |logit| (worst step), the relative Frobenius
error over all steps and whether every step's argmax agreed. The cases
that ``test_torch_lm.py`` holds to its tolerances are the ones whose
drift this survey shows to be the order of the sums alone.

    PYTHONPATH=src:tests python tests/_torch_lm_survey.py --no-excess-precision

runs only the bf16-model W4A4 cases on dyadic weights, with XLA's
``--xla_allow_excess_precision=false`` (XLA then rounds every bf16 op's
result to bf16, as torch does, instead of keeping f32 between fused ops).
"""
import os
import sys

NO_EXCESS = "--no-excess-precision" in sys.argv
if NO_EXCESS:   # before JAX starts its backend
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_allow_excess_precision=false")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro.kernels.ops as jops  # noqa: E402
import test_torch_lm as T  # noqa: E402


def run(name, dt, kv, act, dyadic, seed, steps=8, b=2):
    jcfg = dataclasses.replace(T.J_CONFIGS[name], dtype=dt, kv_dtype=kv)
    tcfg = T.t_config(jcfg)
    jp = T.j_lm_init(jax.random.PRNGKey(seed), jcfg)
    tp = T.from_numpy_tree(T.np_tree(jp), "cpu")
    if dyadic:     # back to the reference (bf16 -> f32 -> bf16 is exact)
        tp = T.dyadic_weights(tp)
        jp = jax.tree.map(lambda a: jnp.asarray(a.float().numpy()).astype(
            jcfg.dtype), tp)
    tp = T.quantize_lm_for_serving(tp)
    jp = T.j_quantize(jp, searched=False)
    jctx = tctx = None
    if act:
        jctx = T.JCtx("serve", act_qps={"*": T.JQP(0, 2, 1, 4,
                                                  jnp.float32(6.0))})
        tctx = T.QuantContext("serve", act_qps={"*": T.QuantizerParams(
            0, 2, 1, 4, torch.tensor(6.0))})
    toks = np.random.default_rng(6 + seed).integers(0, jcfg.vocab, (b, steps))
    jstep = jax.jit(T.j_make_decode_fn(jcfg, ctx=jctx))
    tstep = T.make_decode_fn(tcfg, ctx=tctx)
    jc, tc = T.j_init_caches(jcfg, b, steps), T.tlm.init_caches(tcfg, b, steps)
    want, got = [], []
    for i in range(steps):
        tok = toks[:, i:i + 1].astype(np.int32)
        lg, jc = jstep(jp, jc, jnp.asarray(tok), jnp.int32(i))
        want.append(np.asarray(lg.astype(jnp.float32)))
        lg, tc = tstep(tp, tc, torch.from_numpy(tok).long(), i)
        got.append(lg.float().numpy())
    w, g = np.stack(want), np.stack(got)
    err = (np.abs(g - w).max(axis=(1, 2, 3))
           / np.abs(w).max(axis=(1, 2, 3))).max()
    rel = np.linalg.norm(g - w) / np.linalg.norm(w)
    return err, rel, bool((g.argmax(-1) == w.argmax(-1)).all())


def main():
    jops.FORCE = "interpret"
    print("config dtype kv acts weights: per seed max-err/rel-frob/argmax")
    cases = [(dt, kv, True, dy) for dt in (jnp.float32, jnp.bfloat16)
             for kv in ("fp4", "fp8", "bf16") for dy in (True, False)]
    cases += [(jnp.float32, "fp8", False, False),
              (jnp.bfloat16, "bf16", False, False)]
    if NO_EXCESS:
        cases = [c for c in cases if c[0] == jnp.bfloat16 and c[2] and c[3]]
        print("XLA_FLAGS:", os.environ["XLA_FLAGS"].strip())
    for name in T.J_CONFIGS:
        for dt, kv, act, dyadic in cases:
            res = [run(name, dt, kv, act, dyadic, s) for s in range(3)]
            print(f"{name} {jnp.dtype(dt).name} {kv} "
                  f"{'fp4' if act else 'off'} "
                  f"{'dyadic' if dyadic else 'random'}: "
                  + "  ".join(f"{e:.1e}/{r:.1e}/{a}" for e, r, a in res),
                  flush=True)


if __name__ == "__main__":
    main()
