"""The port's training core against the JAX package's on the CPU:
schedules (train/schedules.py), the optimizer (the Trainer's clip + AdamW
against optax.chain(clip_by_global_norm, adamw)), the Trainer over three
steps of the vqvae and gpt families, checkpoints (exact resume, rotation,
filter_restore), EMA and remat.

Tolerances: schedules within 1e-7 relative of JAX's at steps 0-50, the
cosine's within that plus two float32 ulps of its cosine term (XLA's fused
cos is not correctly rounded, and 1 + cos cancels toward the end); one
optimizer update from carried optax state and identical gradients within
1e-6 relative (atol 1e-12); three Trainer steps (f32, cosine with warmup
2): losses within 1e-4 relative, parameters within 1% of the largest
possible move (atol = 3 lr 1e-2); exact resume and remat bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from xtts_tpu.core import checkpoint as jckpt  # noqa: E402
from xtts_tpu.core.config import (DVAEConfig, GPTConfig,  # noqa: E402
                                  TrainConfig)
from xtts_tpu.models import dvae as jdv, gpt as jgpt  # noqa: E402
from xtts_tpu.train import (ema as jema, schedules as jsch,  # noqa: E402
                            steps as jsteps, trainer as jtr)
from xtts_tpu_torch.core import checkpoint as tckpt  # noqa: E402
from xtts_tpu_torch.core import config as tcfg  # noqa: E402
from xtts_tpu_torch.models import dvae as tdv, gpt as tgpt  # noqa: E402
from xtts_tpu_torch.train import (ema as tema, schedules as tsch,  # noqa: E402
                                  steps as tsteps, trainer as ttr)
from xtts_tpu_torch.utils import convert  # noqa: E402
from test_torch_port_e2e import one_torch_thread  # noqa: E402,F401

MB = 8
DVAE_CFG = DVAEConfig(channels=MB, num_tokens=30, hidden_dim=16,
                      num_resnet_blocks=1, codebook_dim=16, num_layers=2)
GPT_CFG = GPTConfig(layers=2, model_dim=32, heads=2, max_mel_tokens=24,
                    max_text_tokens=16, number_text_tokens=16,
                    start_text_token=15, number_mel_codes=32,
                    start_mel_token=30, stop_mel_token=31, mel_bins=MB,
                    cond_attn_blocks=1)
TRAIN = TrainConfig(accum_grad=1, lr=1e-3, warmup_steps=2, train_steps=50,
                    lr_schedule="cosine", dtype="float32")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# schedules


@pytest.mark.parametrize("kind", ["cosine", "linear", "exponential",
                                  "constant"])
def test_schedules_equal(kind):
    for lr, warm, total in ((1e-3, 5, 40), (3e-4, 1, 50), (2e-4, 0, 30)):
        if kind == "linear" and warm == 0:
            continue
        jf = jax.jit(jsch.make_schedule(kind, lr, warm, total, 0.1))
        tf = tsch.make_schedule(kind, lr, warm, total, 0.1)
        cos_ulps = (1 - 0.1) * lr * 0.5 * 2.0 ** -22 if kind == "cosine" else 0
        for step in range(51):
            want = float(jf(jnp.int32(step)))
            got = tf(step)
            assert abs(got - want) <= 1e-7 * abs(want) + cos_ulps, (
                kind, step, got, want)


# ---------------------------------------------------------------------------
# optimizer


class _Params(torch.nn.Module):
    """Parameters named "<module>.<leaf>" after a two-level JAX tree."""

    def __init__(self, tree):
        super().__init__()
        for mod, leaves in tree.items():
            sub = torch.nn.Module()
            for k, v in leaves.items():
                sub.register_parameter(k, torch.nn.Parameter(
                    torch.tensor(np.asarray(v))))
            self.add_module(mod, sub)


def _flat(tree):
    return {f"{m}.{k}": np.asarray(v) for m, leaves in tree.items()
            for k, v in leaves.items()}


@pytest.mark.parametrize("grad_scale", [0.1, "at", 30.0])
def test_optimizer_update_equal(grad_scale):
    """From optax state after 3 updates, one more update from identical
    gradients: below, at and above the clip's max_norm."""
    rng = np.random.default_rng(0)
    tree = {"dense": {"kernel": rng.standard_normal((6, 5)),
                      "bias": rng.standard_normal(5)},
            "norm": {"scale": 1 + 0.1 * rng.standard_normal(7)}}
    tree = jax.tree_util.tree_map(lambda x: np.float32(x), tree)
    cfg = TrainConfig(lr=1e-2, warmup_steps=2, train_steps=20,
                      weight_decay=0.05, grad_clip=1.0)
    jt = jtr.Trainer(lambda *a: None, cfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt = jt.tx.init(params)
    for i in range(3):
        g = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape),
                                  jnp.float32), params)
        upd, opt = jt.tx.update(g, opt, params)
        params = optax.apply_updates(params, upd)
    if grad_scale == "at":
        grads = jax.tree_util.tree_map(np.zeros_like, _np(params))
        grads["dense"]["kernel"][2, 3] = np.float32(cfg.grad_clip)
    else:
        grads = jax.tree_util.tree_map(
            lambda x: np.float32(grad_scale) * rng.standard_normal(
                x.shape).astype(np.float32), _np(params))
    upd, opt2 = jt.tx.update(jax.tree_util.tree_map(jnp.asarray, grads), opt,
                             params)
    want = _flat(_np(optax.apply_updates(params, upd)))

    model = _Params(_np(params))
    tt = ttr.Trainer(model, None, cfg)
    state = tt.init_state()
    state.opt_state = convert.adamw_state_from_jax(_np(opt), _flat,
                                                   list(state.params), "cpu")
    assert state.opt_state.count == 3
    flat_g = _flat(grads)
    gnorm = tt.apply_gradients(state, [torch.tensor(flat_g[n])
                                       for n in state.params])
    np.testing.assert_allclose(float(gnorm), float(optax.global_norm(grads)),
                               rtol=1e-6)
    for n, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=1e-6,
                                   atol=1e-12, err_msg=n)
    adam = convert._find_adam(_np(opt2))
    for n in state.params:
        np.testing.assert_allclose(state.opt_state.mu[n].numpy(),
                                   _flat(adam.mu)[n], rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(state.opt_state.nu[n].numpy(),
                                   _flat(adam.nu)[n], rtol=1e-6, atol=1e-12)
    assert state.opt_state.count == int(adam.count) == 4


def test_ema_equal():
    rng = np.random.default_rng(1)
    p = {"a": rng.standard_normal((3, 4)).astype(np.float32)}
    q = {"a": rng.standard_normal((3, 4)).astype(np.float32)}
    for step in (0, 3, 500):
        d = jema.ema_warmup_decay(jnp.int32(step), 0.999)
        assert tema.ema_warmup_decay(step, 0.999) == float(d)
        want = np.asarray(jema.ema_update(jema.ema_init(p), q, d)["a"])
        got = tema.ema_update(tema.ema_init({"a": torch.tensor(p["a"])}),
                              {"a": torch.tensor(q["a"])},
                              tema.ema_warmup_decay(step, 0.999))["a"]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=1e-7)


# ---------------------------------------------------------------------------
# the Trainer: three steps of each family, JAX against the port


def _dvae_pair():
    jm = jdv.DVAE(DVAE_CFG)
    jv = _np(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, MB, 32))))
    tm = tdv.DVAE(tcfg.DVAEConfig.from_dict(DVAE_CFG.to_dict()))
    to_sd = lambda t: convert.dvae_from_jax(t, DVAE_CFG.num_layers,
                                            DVAE_CFG.num_resnet_blocks)
    return jm, jv, tm, to_sd


def _gpt_pair():
    jm = jgpt.UnifiedVoice(GPT_CFG)
    jv = _np(jax.jit(jm.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, MB, 16)),
        jnp.zeros((1, 8), jnp.int32), jnp.array([8]),
        jnp.zeros((1, 8), jnp.int32), jnp.array([8 * 1024])))
    tm = tgpt.UnifiedVoice(tcfg.GPTConfig.from_dict(GPT_CFG.to_dict()))
    to_sd = lambda t: convert.unified_voice_from_jax(
        t, GPT_CFG.layers, GPT_CFG.cond_attn_blocks)
    return jm, jv, tm, to_sd


def _batches(family, n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if family == "vqvae":
            out.append({"mel": rng.standard_normal((3, MB, 32)).astype(
                np.float32)})
            continue
        out.append({
            "cond_mel": rng.standard_normal((2, MB, 20)).astype(np.float32),
            "text": rng.integers(2, 14, (2, 8)).astype(np.int32),
            "text_lengths": np.array([8, 5], np.int32),
            "mel": rng.standard_normal((2, MB, 64)).astype(np.float32),
            "wav_lengths": np.array([16 * 1024, 11 * 1024 - 7], np.int32)})
    return out


def _torch_batch(b):
    return {k: (torch.from_numpy(v).long() if v.dtype == np.int32
                else torch.from_numpy(v)) for k, v in b.items()}


@pytest.fixture(scope="module")
def families():
    """Per family: (JAX loss, JAX variables, port module, to_sd, port loss,
    its frozen DVAE or None)."""
    jdm, jdvars, tdm, dvae_sd = _dvae_pair()
    tdm.load_state_dict(convert.to_torch(dvae_sd(jdvars), "cpu"))
    out = {"vqvae": (jsteps.make_dvae_loss(jdm), jdvars, tdm, dvae_sd,
                     tsteps.make_dvae_loss(tdm))}
    jgm, jgvars, tgm, gpt_sd = _gpt_pair()
    frozen = tdv.DVAE(tcfg.DVAEConfig.from_dict(DVAE_CFG.to_dict())).eval()
    frozen.load_state_dict(convert.to_torch(dvae_sd(jdvars), "cpu"))
    tgm.load_state_dict(convert.to_torch(gpt_sd(jgvars), "cpu"))
    out["gpt"] = (jsteps.make_gpt_loss(jgm, jdm, jdvars), jgvars, tgm, gpt_sd,
                  tsteps.make_gpt_loss(tgm, frozen))
    return out


@pytest.mark.parametrize("family", ["vqvae", "gpt"])
def test_trainer_three_steps_equal(families, family):
    jloss, jvars, tmod, to_sd, tloss = families[family]
    cols = ({"codebook": dict(jvars["codebook"])} if family == "vqvae"
            else {})
    jt = jtr.Trainer(jloss, TRAIN, accum_steps=1,
                     frozen=getattr(jloss, "frozen", None))
    jstate = jt.init_state(jax.tree_util.tree_map(jnp.asarray,
                                                  jvars["params"]), cols)
    tt = ttr.Trainer(tmod, tloss, TRAIN, accum_steps=1)
    tstate = convert.train_state_from_jax(_np(jstate), tt, to_sd, "cpu")
    for b in _batches(family, 3):
        jstate, jm = jt.step(jstate, jax.tree_util.tree_map(jnp.asarray, b),
                             jax.random.PRNGKey(0))
        tstate, tm = tt.step(tstate, _torch_batch(b))
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=k)
    assert tstate.step == int(jstate.step) == 3
    want = to_sd({"params": _np(jstate.params),
                  **_np(jstate.state_cols)})
    atol = 3 * TRAIN.lr * 1e-2
    for n, p in tstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0,
                                   atol=atol, err_msg=n)
    for n, c in tstate.state_cols.items():
        np.testing.assert_allclose(c.numpy(), want[n], rtol=1e-5, atol=1e-6,
                                   err_msg=n)


def test_trainer_accumulation_threads_the_codebook(families):
    """accum 2: gradients summed and divided once, the codebook updated
    after each microbatch (JAX's lax.scan over microbatches)."""
    jloss, jvars, _, to_sd, _ = families["vqvae"]
    _, _, tmod, _ = _dvae_pair()
    tmod.load_state_dict(convert.to_torch(to_sd(jvars), "cpu"))
    cfg = TRAIN.replace(lr_schedule="constant")
    jt = jtr.Trainer(jloss, cfg, accum_steps=2)
    jstate = jt.init_state(jax.tree_util.tree_map(jnp.asarray,
                                                  jvars["params"]),
                           {"codebook": dict(jvars["codebook"])})
    tt = ttr.Trainer(tmod, tsteps.make_dvae_loss(tmod), cfg, accum_steps=2)
    tstate = convert.train_state_from_jax(_np(jstate), tt, to_sd, "cpu")
    mel = np.stack([b["mel"] for b in _batches("vqvae", 2, seed=4)])
    jstate, jm = jt.step(jstate, {"mel": jnp.asarray(mel)},
                         jax.random.PRNGKey(0))
    tstate, tm = tt.step(tstate, {"mel": torch.from_numpy(mel)})
    for k in ("loss", "grad_norm", "recon", "commitment"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    want = to_sd({"params": _np(jstate.params), **_np(jstate.state_cols)})
    for n, c in tstate.state_cols.items():
        np.testing.assert_allclose(c.numpy(), want[n], rtol=1e-5, atol=1e-6,
                                   err_msg=n)


# ---------------------------------------------------------------------------
# checkpoints


def _fresh_gpt(families):
    _, jvars, _, to_sd, _ = families["gpt"]
    m = tgpt.UnifiedVoice(tcfg.GPTConfig.from_dict(GPT_CFG.to_dict()))
    m.load_state_dict(convert.to_torch(to_sd(jvars), "cpu"))
    frozen = tdv.DVAE(tcfg.DVAEConfig.from_dict(DVAE_CFG.to_dict())).eval()
    frozen.load_state_dict(families["vqvae"][2].state_dict())
    return m, tsteps.make_gpt_loss(m, frozen)


def _snapshot(state):
    return ({k: v.detach().clone() for k, v in state.params.items()},
            {k: v.clone() for k, v in state.opt_state.mu.items()},
            {k: v.clone() for k, v in state.opt_state.nu.items()},
            state.opt_state.count, state.step)


@pytest.mark.parametrize("ema", [None, 0.99])
def test_exact_resume(families, tmp_path, ema):
    batches = [_torch_batch(b) for b in _batches("gpt", 4, seed=2)]
    m, loss = _fresh_gpt(families)
    tt = ttr.Trainer(m, loss, TRAIN, accum_steps=1, ema_decay=ema)
    st = tt.init_state()
    for b in batches:
        st, _ = tt.step(st, b)
    straight = _snapshot(st), {k: v.clone() for k, v in st.state_cols.items()}

    m, loss = _fresh_gpt(families)
    tt = ttr.Trainer(m, loss, TRAIN, accum_steps=1, ema_decay=ema,
                     checkpoint_dir=str(tmp_path / "ckpt"))
    st = tt.init_state()
    for b in batches[:2]:
        st, _ = tt.step(st, b)
    assert tt.save(st, wait=True)
    m, loss = _fresh_gpt(families)          # a new process's model
    tt = ttr.Trainer(m, loss, TRAIN, accum_steps=1, ema_decay=ema,
                     checkpoint_dir=str(tmp_path / "ckpt"))
    st = tt.restore(tt.init_state())
    assert st.step == 2 and st.opt_state.count == 2
    for b in batches[2:]:
        st, _ = tt.step(st, b)
    resumed = _snapshot(st), st.state_cols
    for a, b in zip(straight[0][:3] + (straight[1],),
                    resumed[0][:3] + (resumed[1],)):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert straight[0][3:] == resumed[0][3:] == (4, 4)


def test_rotation_and_restore_target(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path / "c"), keep=2)
    for step in (1, 2, 3, 4):
        assert mgr.save(step, {"w": torch.full((3,), float(step)),
                               "step": step})
    mgr.wait()
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    assert not mgr.save(4, {"w": torch.zeros(3)})
    out = mgr.restore(target={"w": torch.zeros(3, dtype=torch.float64),
                              "step": 0})
    assert out["w"].dtype == torch.float64 and out["w"].tolist() == [4.0] * 3
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(3, target={"w": torch.zeros(2), "step": 0})
    assert not [p for p in (tmp_path / "c").iterdir()
                if p.suffix == ".tmp"]
    with pytest.raises(FileNotFoundError):
        tckpt.CheckpointManager(str(tmp_path / "empty")).restore()


def test_filter_restore_agrees_with_jax():
    rng = np.random.default_rng(5)
    init = {"enc": {"conv": rng.standard_normal(3), "res0": {
        "w": rng.standard_normal((2, 2))}},
        "dec": {"conv": rng.standard_normal(4),
                "head": rng.standard_normal(5)}}
    rest = jax.tree_util.tree_map(lambda x: x + 1.0, init)
    rest["dec"]["head"] = np.zeros(6)               # shape mismatch: kept
    for inc, exc in (((), ()), (("^enc",), ()), ((), ("res",)),
                     (("conv",), ("^dec",))):
        want = jckpt._flatten(jckpt.filter_restore(rest, init, inc, exc))
        got = tckpt.filter_restore(rest, init, inc, exc)
        assert sorted(want) == sorted(k.replace(".", "/") for k in got)
        for k, v in got.items():
            np.testing.assert_array_equal(v, want[k.replace(".", "/")])


def test_restore_pretrain_filters(families, tmp_path):
    m, loss = _fresh_gpt(families)
    tt = ttr.Trainer(m, loss, TRAIN, checkpoint_dir=str(tmp_path / "c"))
    st = tt.init_state()
    st, _ = tt.step(st, _torch_batch(_batches("gpt", 1, seed=3)[0]))
    st, _ = tt.step(st, _torch_batch(_batches("gpt", 1, seed=4)[0]))
    trained = {k: v.detach().clone() for k, v in st.params.items()}
    tt.save(st, wait=True)
    m2, loss2 = _fresh_gpt(families)
    tt2 = ttr.Trainer(m2, loss2, TRAIN, checkpoint_dir=str(tmp_path / "c"))
    init = {k: v.detach().clone() for k, v in m2.named_parameters()}
    st2 = tt2.restore_pretrain(tt2.init_state(), exclude=("^mel_head",))
    assert st2.step == 0 and st2.opt_state.count == 0
    for k, v in st2.params.items():
        assert torch.equal(v, init[k] if k.startswith("mel_head")
                           else trained[k]), k


# ---------------------------------------------------------------------------
# remat


@pytest.mark.parametrize("policy", ["full", "dots", "dots_no_batch"])
def test_remat_gradients_equal(families, policy):
    """Gradients of the GPT loss under a remat policy equal the unremat'd
    ones bit for bit, and the policy does recompute (the first block runs
    twice: forward and backward)."""
    _, jvars, _, to_sd, _ = families["gpt"]
    batch = _torch_batch(_batches("gpt", 1, seed=6)[0])
    codes = torch.randint(0, 30, (2, 16), generator=torch.Generator()
                          .manual_seed(0))
    grads, calls = [], []
    for name in ("none", policy):
        cfg = tcfg.GPTConfig.from_dict(GPT_CFG.replace(remat=name).to_dict())
        m = tgpt.UnifiedVoice(cfg)
        m.load_state_dict(convert.to_torch(to_sd(jvars), "cpu"))
        n = [0]
        m.gpt.h[0].register_forward_pre_hook(
            lambda *a: n.__setitem__(0, n[0] + 1))
        lt, lm = m(batch["cond_mel"], batch["text"], batch["text_lengths"],
                   codes, batch["wav_lengths"])
        (0.01 * lt + lm).backward()
        grads.append({k: p.grad.clone() for k, p in m.named_parameters()})
        calls.append(n[0])
    assert calls == [1, 2]
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k
    with pytest.raises(ValueError, match="remat policy"):
        tgpt.UnifiedVoice(tcfg.GPTConfig.from_dict(
            GPT_CFG.replace(remat="some").to_dict()))
