"""Port parity for LM training on one device: gradients and the train step
against the JAX package, gradient accumulation, remat, the
decode-vs-forward invariant, the trainer, the checkpoints, the token
stream and the train launcher.

Tolerances, all in f32: the loss within 1e-5; each gradient leaf's max
abs error within GRAD_LIMIT of its largest |grad| (or of 1e-3 of the
tree's largest, for a leaf whose gradient is rounding noise around 0: the
router's under top-1 routing, where the gate weight is p / p = 1); after
one Adam step each parameter within 0.1 * lr of the reference's (the
first step moves a weight by lr * g / (|g| + eps), so an f32 ulp of g
near 0 moves it by a share of lr) and the moments by the gradients' rule;
decode against forward within the reference's 2e-2 of max |logit|;
remat on against off bit for bit; a CPU resume bit for bit.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_decode import j_tree, one_torch_thread, t_config  # noqa: F401
from repro.checkpoint.ckpt import CheckpointManager as JCheckpointManager
from repro.configs import registry as jreg
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import lm as jlm
from repro.optim.adam import AdamConfig as JAdamConfig
from repro.optim.adam import adam_init as j_adam_init
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.common.tree import flatten_paths, tree_leaves
from repro_torch.convert import adam_state_from_numpy, from_numpy_tree
from repro_torch.data.synthetic import token_batches, zipf_tokens
from repro_torch.kernels import ops as tops
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import value_and_grad, make_train_step
from repro_torch.models import lm as tlm
from repro_torch.models.lm import ATTN, SSM, LMConfig
from repro_torch.optim.adam import AdamConfig, adam_init
from repro_torch.train.trainer import Trainer, TrainerConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_LIMIT = 1e-5
DECODE_LIMIT = 2e-2
B, S = 2, 16


def np_flat(tree) -> dict:
    """path -> float64 numpy, for a JAX tree or a tree of tensors."""
    tree = jax.tree.map(lambda v: np.asarray(v, np.float64), tree) \
        if not isinstance(tree_leaves(tree)[0], torch.Tensor) else tree
    return {k: (v.detach().double().numpy() if isinstance(v, torch.Tensor)
                else v) for k, v in flatten_paths(tree).items()}


def grads_close(got, want, limit=GRAD_LIMIT) -> None:
    g, w = np_flat(got), np_flat(want)
    assert set(g) == set(w)
    top = max(np.abs(v).max() for v in w.values())
    for k in w:
        assert g[k].shape == w[k].shape, k
        scale = max(np.abs(w[k]).max(), 1e-3 * top)
        err = np.abs(g[k] - w[k]).max()
        assert err <= limit * scale, (k, err, scale)


def inputs(cfg, seed=0):
    """(JAX batch, port batch): numpy-seeded (B, S) tokens and, for the
    vlm, patch embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S))
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.family == "vlm":
        ex = rng.standard_normal((B, cfg.n_img_tokens, cfg.d_vision)).astype(
            np.float32)
        jb["extra"], tb["extra"] = jnp.asarray(ex), torch.from_numpy(ex)
    return jb, tb


def model(arch, seed=0, **kw):
    jcfg = dataclasses.replace(jreg.get_config(arch, smoke=True), **kw)
    tcfg = t_config(jcfg)
    tp = tlm.lm_init(torch.Generator().manual_seed(seed), tcfg)
    return jcfg, tcfg, tp, j_tree(tp)


# ---------------------------------------------------------------------------
# gradients and the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-370m", "zamba2-2.7b",
                                  "llama4-scout-17b-a16e",
                                  "llava-next-mistral-7b"])
def test_grads_match_reference(arch):
    """The loss and every gradient leaf against jax.value_and_grad(loss_fn)
    for the dense, ssm, hybrid, moe and vlm smoke configs."""
    jcfg, tcfg, tp, jp = model(arch)
    jb, tb = inputs(jcfg)
    want_l, want_g = jax.value_and_grad(lambda p: jlm.loss_fn(
        p, jcfg, jb["tokens"], jb.get("extra")))(jp)
    got_l, got_g = value_and_grad(tp, tcfg, tb)
    assert abs(float(got_l) - float(want_l)) <= 1e-5
    grads_close(got_g, want_g)


def test_train_step_matches_reference():
    """One make_train_step (Adam, lr 1e-3, clip 1.0) against the
    reference's: loss, grad norm, the new parameters and both moments."""
    jcfg, tcfg, tp, jp = model("smollm-135m")
    jb, tb = inputs(jcfg, 3)
    lr = 1e-3
    jnew, jopt, jm = jax.jit(j_make_train_step(jcfg, JAdamConfig(lr=lr)))(
        jp, j_adam_init(jp, JAdamConfig(lr=lr)), jb)
    acfg = AdamConfig(lr=lr)
    tnew, topt, tm = make_train_step(tcfg, acfg)(tp, adam_init(tp, acfg), tb)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-5)
    assert int(topt["step"]) == int(jopt["step"]) == 1
    g, w = np_flat(tnew), np_flat(jnew)
    assert max(np.abs(g[k] - w[k]).max() for k in w) <= 0.1 * lr
    grads_close(topt["m"], jopt["m"])
    grads_close(topt["v"], jopt["v"])


def test_grad_accum_matches_single_step():
    """grad_accum=2 against 1 (the reference's test_launch.py recipe and
    tolerances: loss rtol 2e-2, parameters within 5e-2), and the loss,
    an average of two equal microbatches' means, within 1e-5."""
    _, cfg, p, _ = model("smollm-135m")
    acfg = AdamConfig(lr=1e-3, clip_norm=None)
    opt = adam_init(p, acfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 16)))
    p1, _, m1 = make_train_step(cfg, acfg, grad_accum=1)(
        p, opt, {"tokens": toks})
    p2, _, m2 = make_train_step(cfg, acfg, grad_accum=2)(
        p, opt, {"tokens": toks})
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=2e-2)
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= 1e-5
    a, b = np_flat(p1), np_flat(p2)
    assert max(np.abs(a[k] - b[k]).max() for k in a) < 5e-2


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-2.7b"])
def test_remat_changes_no_gradient(arch):
    """cfg.remat (torch.utils.checkpoint over each group) on and off give
    the same loss and gradients, bit for bit."""
    _, cfg, p, _ = model(arch, remat=True)
    tb = inputs(jreg.get_config(arch, smoke=True), 4)[1]
    l_on, g_on = value_and_grad(p, cfg, tb)
    l_off, g_off = value_and_grad(p, dataclasses.replace(cfg, remat=False),
                                   tb)
    assert torch.equal(l_on, l_off)
    for a, b in zip(tree_leaves(g_on), tree_leaves(g_off)):
        assert torch.equal(a, b)


def test_train_step_runs_no_kernel():
    """Training has float weights and no context, in the reference and in
    the port: a train step dispatches only the dense products (the tied
    readout, the untied head's and the router's f32 products), no kernel
    route and no oracle."""
    for arch in ("smollm-135m", "llama4-scout-17b-a16e"):
        jcfg, cfg, p, _ = model(arch)
        acfg = AdamConfig(lr=1e-3)
        tops.reset_routes()
        make_train_step(cfg, acfg)(p, adam_init(p, acfg), inputs(jcfg)[1])
        assert tops.ROUTES, arch
        assert {r for _, r in tops.ROUTES} <= {"torch_f32", "torch"}, \
            dict(tops.ROUTES)


def test_five_steps_lower_the_loss():
    """The reference's test_arch_train_step_decreases_loss recipe: five
    steps at lr 5e-3 on one fixed batch."""
    jcfg, cfg, p, _ = model("zamba2-2.7b")
    batch = inputs(jcfg)[1]
    acfg = AdamConfig(lr=5e-3)
    opt = adam_init(p, acfg)
    step = make_train_step(cfg, acfg)
    losses = []
    for _ in range(5):
        p, opt, m = step(p, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


# ---------------------------------------------------------------------------
# decode against forward (the reference's tests/test_models.py:89, :118)
# ---------------------------------------------------------------------------

DECODE_CASES = {
    "dense": LMConfig("t", n_layers=3, d_model=64, n_heads=4, n_kv=2,
                      d_ff=128, vocab=97, qkv_bias=True, dtype=torch.float32,
                      q_chunk=4),
    "swa": LMConfig("t", n_layers=4, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                    vocab=97, dtype=torch.float32, q_chunk=4,
                    layer_pattern=((ATTN, 4, 10_000.0), (ATTN, 4, 10_000.0),
                                   (ATTN, None, 10_000.0),
                                   (ATTN, 4, 10_000.0))),
    "ssm": LMConfig("t", n_layers=4, d_model=64, n_heads=4, n_kv=4, d_ff=0,
                    vocab=97, family="ssm", ssm_d_state=16, ssm_headdim=16,
                    ssm_chunk=4, layer_pattern=((SSM, None, 10_000.0),),
                    dtype=torch.float32),
    "hybrid": LMConfig("t", n_layers=4, d_model=64, n_heads=4, n_kv=4,
                       d_ff=64, vocab=97, family="hybrid", ssm_d_state=16,
                       ssm_headdim=16, ssm_chunk=4, mlp_kind="gelu",
                       layer_pattern=((SSM, None, 10_000.0),) * 2,
                       shared_attn_every=2, dtype=torch.float32, q_chunk=4),
    "moe": LMConfig("t", n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                    vocab=97, family="moe", n_experts=4, top_k=2,
                    moe_d_ff=32, capacity_factor=4.0, dtype=torch.float32,
                    q_chunk=4),
    "ring, long context": LMConfig(
        "t", n_layers=2, d_model=32, n_heads=2, n_kv=2, d_ff=64, vocab=64,
        dtype=torch.float32, q_chunk=4, layer_pattern=((ATTN, 4, 10_000.0),)),
}


def decode_all(p, cfg, toks):
    """Teacher-forced decode of every position from empty caches (a bf16
    KV cache, acts off) -> (B, S, vocab)."""
    caches = tlm.init_caches(cfg, toks.shape[0], toks.shape[1])
    outs = []
    for i in range(toks.shape[1]):
        lg, caches = tlm.decode_step(p, cfg, caches, toks[:, i:i + 1], i)
        outs.append(lg[:, 0])
    return torch.stack(outs, dim=1)


def rel_max(a, b) -> float:
    return float((a - b).abs().max() / (b.abs().max() + 1e-9))


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_matches_forward(case):
    cfg = DECODE_CASES[case]
    p = tlm.lm_init(torch.Generator().manual_seed(0), cfg)
    s = 12
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (1 if case.startswith("ring") else B, s)))
    with torch.no_grad():
        full = tlm.forward(p, cfg, toks)
        dec = decode_all(p, cfg, toks)
    assert rel_max(dec, full) < DECODE_LIMIT


def test_first_k_dense_decode_window_differs_alike():
    """gemma3's first_k_dense layers decode over the whole cache
    (repro/models/lm.py:432) but the forward masks them to the window, so
    past the smoke config's window of 8 decode and forward differ, in both
    packages alike (ROADMAP Queue C; the port follows the reference)."""
    jcfg, cfg, p, jp = model("gemma3-4b")
    s = 16
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (B, s))
    with torch.no_grad():
        full = tlm.forward(p, cfg, torch.from_numpy(toks))
        dec = decode_all(p, cfg, torch.from_numpy(toks))
    jfull = jlm.forward(jp, jcfg, jnp.asarray(toks))
    jc = jlm.init_caches(jcfg, B, s)
    step = jax.jit(lambda c, t, i: jlm.decode_step(jp, jcfg, c, t, i))
    jdec = []
    for i in range(s):
        lg, jc = step(jc, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        jdec.append(np.asarray(lg[:, 0]))
    jdec = torch.from_numpy(np.stack(jdec, axis=1))
    jfull = torch.from_numpy(np.array(jfull))
    w = jcfg.layer_pattern[0][1]
    for a, b in ((dec, full), (jdec, jfull)):
        assert rel_max(a[:, :w], b[:, :w]) < DECODE_LIMIT
        assert rel_max(a[:, w:], b[:, w:]) > 10 * DECODE_LIMIT
    assert rel_max(dec, jdec) < 1e-4 and rel_max(full, jfull) < 1e-5


# ---------------------------------------------------------------------------
# checkpoints, trainer, token stream (the reference's test_substrates.py)
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_gc_checksum(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(5.0), "h": torch.ones(3, dtype=torch.bfloat16)
            * 1.5, "blocks": [{"w": torch.ones(2)}, {"w": torch.zeros(2)}],
            "step": torch.tensor(3, dtype=torch.int32)}
    cm.save(1, tree)
    cm.save(2, tree, {"note": "x"})
    cm.save(3, tree)
    assert cm.steps() == [2, 3]
    s, t2, extra = cm.restore()
    assert s == 3 and extra == {}
    assert cm.restore(2)[2] == {"note": "x"}
    assert flatten_paths(t2).keys() == flatten_paths(tree).keys()
    for k, v in flatten_paths(tree).items():
        got = flatten_paths(t2)[k]
        assert got.dtype == v.dtype and torch.equal(got, v), k
    manifest = json.load(open(tmp_path / "step_0000000003" / "manifest.json"))
    assert manifest["leaves"]["h"]["dtype"] == "bfloat16"
    # corrupt -> checksum failure
    path = tmp_path / "step_0000000002" / "arrays.npz"
    data = dict(np.load(path))
    data["a0"] = data["a0"] + 1
    np.savez(path, **data)
    with pytest.raises(IOError):
        cm.restore(2)


def test_checkpoint_async_and_atomic(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=5)
    cm.save_async(7, {"x": torch.ones(3)})
    cm.wait()
    assert cm.steps() == [7]
    assert not any(p.endswith(".tmp") for p in os.listdir(tmp_path))
    # a leftover .tmp of a save cut short is not a checkpoint
    os.makedirs(tmp_path / "step_0000000009.tmp")
    assert cm.latest_step() == 7
    # a failed background write raises from wait()
    cm.save_async(8, {"x": torch.ones(3)})
    cm.wait()
    cm._write = lambda *a: 1 / 0
    cm.save_async(9, {"x": torch.ones(3)})
    with pytest.raises(RuntimeError, match="background save failed"):
        cm.wait()


def test_checkpoint_reads_what_the_reference_wrote(tmp_path):
    """A checkpoint of an LM's params and Adam state written by the JAX
    package's CheckpointManager (bf16 leaves as ml_dtypes' bfloat16)
    restores, verified, bit for bit; convert's Adam state from numpy keeps
    the LM tree's nesting."""
    jcfg = dataclasses.replace(jreg.get_config("zamba2-2.7b", smoke=True),
                               dtype=jnp.bfloat16)
    tp = tlm.lm_init(torch.Generator().manual_seed(0), t_config(jcfg))
    jp = j_tree(tp)
    jopt = j_adam_init(jp, JAdamConfig())
    JCheckpointManager(str(tmp_path)).save(5, (jp, jopt))
    step, (params, opt), _ = CheckpointManager(str(tmp_path)).restore()
    assert step == 5
    want = flatten_paths(tp)
    for k, v in flatten_paths(params).items():
        assert v.dtype == want[k].dtype == torch.bfloat16, k
        assert torch.equal(v, want[k]), k
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 0
    conv = adam_state_from_numpy(jax.tree.map(np.asarray, jopt), "cpu")
    assert flatten_paths(conv["m"]).keys() == want.keys()
    assert isinstance(conv["m"]["blocks"], list)
    back = from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    assert all(torch.equal(v, want[k])
               for k, v in flatten_paths(back).items())


def test_trainer_recovers_from_injected_fault(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=5)
    hits = {"n": 0}

    def fault(step):
        if step == 5 and hits["n"] == 0:
            hits["n"] += 1
            raise RuntimeError("injected device failure")

    def step_fn(state, batch):
        return {"x": state["x"] + batch}, {"loss": float(state["x"])}

    tr = Trainer(TrainerConfig(max_steps=10, ckpt_every=2), cm, step_fn,
                 fault_hook=fault)
    final, hist = tr.run({"x": torch.zeros(())}, lambda step: 1.0)
    assert tr.restarts == 1
    assert float(final["x"]) == 10.0  # replayed from the step-4 checkpoint


def test_trainer_restore_replays_each_steps_batch(tmp_path):
    """The data is a function of the step, so the steps after an
    in-process restore take their own batches again: the faulted run ends
    where the run without a fault does (the reference's iterator would
    hand them the batches of the steps after the crash)."""
    def step_fn(state, batch):
        return {"x": state["x"] + batch}, {}

    def fault(step):
        if step == 5 and not hits:
            hits.append(step)
            raise RuntimeError("injected device failure")

    ends = {}
    for name, hook in (("faulted", fault), ("straight", None)):
        hits = []
        tr = Trainer(TrainerConfig(max_steps=10, ckpt_every=2),
                     CheckpointManager(str(tmp_path / name), keep=5),
                     step_fn, fault_hook=hook)
        ends[name] = float(tr.run({"x": torch.zeros(())},
                                  lambda step: float(step))[0]["x"])
        assert tr.restarts == (name == "faulted")
    assert ends["faulted"] == ends["straight"] == sum(range(10))


def test_trainer_exceeds_max_restarts(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=5)

    def fault(step):
        raise RuntimeError("permanently broken host")

    tr = Trainer(TrainerConfig(max_steps=5, max_restarts=2), cm,
                 lambda s, b: (s, {}), fault_hook=fault)
    with pytest.raises(RuntimeError, match="max_restarts"):
        tr.run({"x": torch.zeros(())}, lambda step: 1.0)


def test_trainer_straggler_detection(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)

    def step_fn(state, batch):
        time.sleep(1.0 if batch > 0.5 else 0.01)   # one slow step
        return {"x": state["x"] + 1}, {}

    data = [0.0] * 6 + [1.0] + [0.0] * 3
    tr = Trainer(TrainerConfig(max_steps=10, ckpt_every=100,
                               straggler_factor=3.0), cm, step_fn)
    tr.run({"x": torch.zeros(())}, data.__getitem__)
    assert 7 in tr.straggler_steps()


def test_trainer_preemption_stop_saves(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    tr = Trainer(TrainerConfig(max_steps=100, ckpt_every=1000), cm,
                 lambda s, b: ({"x": s["x"] + 1}, {}))
    calls = {"n": 0}

    def data(step):
        calls["n"] += 1
        if calls["n"] == 4:
            tr.request_stop()  # simulated SIGTERM
        return 1.0

    final, hist = tr.run({"x": torch.zeros(())}, data)
    assert len(hist) <= 5
    assert cm.latest_step() == len(hist)
    assert float(cm.restore()[1]["x"]) == len(hist)


def test_zipf_tokens_shapes_determinism_and_copies():
    t1 = zipf_tokens(torch.Generator().manual_seed(0), 2, 32, 100)
    t2 = zipf_tokens(torch.Generator().manual_seed(0), 2, 32, 100)
    assert t1.shape == (2, 32) and torch.equal(t1, t2)
    assert int(t1.min()) >= 0 and int(t1.max()) < 100
    a = t1.numpy()
    idx = np.arange(32)
    mask = (idx % 4 == 0) & (idx >= 3)
    assert np.all(a[:, mask] == np.roll(a, 3, axis=1)[:, mask])
    # the draws follow p ~ 1/rank (positions that are not copies)
    big = next(token_batches(torch.Generator().manual_seed(1), 64, 400, 100))
    i = np.arange(400)
    ids = big[:, torch.from_numpy(~((i % 4 == 0) & (i >= 3)))]
    freq = np.bincount(ids.reshape(-1).numpy(), minlength=100) / ids.numel()
    p = 1.0 / np.arange(1, 101)
    np.testing.assert_allclose(freq, p / p.sum(), atol=0.01)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def run_launcher(ckpt_dir, steps):
    return ttrain.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                        "--steps", str(steps), "--batch", "2", "--seq", "16",
                        "--ckpt-every", "2", "--ckpt-dir", str(ckpt_dir)])


def test_resume_is_bit_exact(tmp_path):
    """4 steps, then the launcher restarted from that checkpoint to 8,
    against 8 steps straight: the same losses at steps 5-8 and the same
    parameters and Adam state, bit for bit (each step's batch has its own
    seed, so the resumed run sees the same batches)."""
    first = run_launcher(tmp_path / "a", 4)
    resumed = run_launcher(tmp_path / "a", 8)
    straight = run_launcher(tmp_path / "b", 8)
    assert first["start"] == 0 and resumed["start"] == 4
    assert [r.step for r in resumed["history"]] == [5, 6, 7, 8]
    assert resumed["losses"] == straight["losses"][4:]
    assert first["losses"] == straight["losses"][:4]
    for a, b in zip(tree_leaves(resumed["state"]),
                    tree_leaves(straight["state"])):
        assert torch.equal(a, b)
    assert resumed["restarts"] == straight["restarts"] == 0


def test_launcher_crash_restore_is_bit_exact(tmp_path, monkeypatch):
    """A step that raises inside the launcher's run (after the step-2
    checkpoint) is contained: the trainer restores step 2 and goes on, and
    the run ends on the parameters and Adam state of the run without the
    fault, bit for bit (each step's batch is drawn by its step)."""
    class Faulted(ttrain.Trainer):
        def __init__(self, *a, **kw):
            hits = []

            def fault(step):
                if step == 3 and not hits:
                    hits.append(step)
                    raise RuntimeError("injected device failure")
            super().__init__(*a, fault_hook=fault, **kw)

    straight = run_launcher(tmp_path / "a", 6)
    monkeypatch.setattr(ttrain, "Trainer", Faulted)
    faulted = run_launcher(tmp_path / "b", 6)
    assert faulted["restarts"] == 1 and straight["restarts"] == 0
    assert [r.step for r in faulted["history"]] == [1, 2, 3, 3, 4, 5, 6]
    assert faulted["losses"][3:] == straight["losses"][2:]
    for a, b in zip(tree_leaves(faulted["state"]),
                    tree_leaves(straight["state"])):
        assert torch.equal(a, b)


def test_launcher_refuses_mesh_flags():
    """A mesh the world cannot hold raises, naming what it needs (this
    process is a world of one rank); none is quietly dropped."""
    for flags, needs in ((["--production-mesh"], "256 ranks"),
                         (["--production-mesh", "--multi-pod"], "512 ranks"),
                         (["--model-parallel", "2"], "world of 1 ranks")):
        with pytest.raises(ValueError, match=needs):
            ttrain.main(["--arch", "smollm-135m", "--smoke", "--device",
                         "cpu", *flags])
    assert not torch.distributed.is_initialized()


def test_launcher_end_to_end(tmp_path):
    """``python -m repro_torch.launch.train --arch smollm-135m --smoke
    --device cpu`` in a process of its own (a few steps), with its
    checkpoints under --ckpt-dir."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-135m", "--smoke", "--device", "cpu", "--steps", "3",
         "--ckpt-dir", str(tmp_path)], capture_output=True, text=True,
        env=env, timeout=300, check=True).stdout
    assert "arch=smollm-135m-smoke steps=3 loss[0]=" in out
    assert "restarts 0" in out
    assert CheckpointManager(str(tmp_path / "smollm-135m-smoke")).steps() \
        == [3]
