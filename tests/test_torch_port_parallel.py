"""The port's data- and tensor-parallel training (parallel/mesh.py, the
Trainer and GANTrainer on a mesh, checkpoints across world sizes) and its
multi-device serving (TextToSpeech.place_on_mesh), on the CPU.

Four gloo ranks, spawned once for the module (parallel.launch.run_ranks,
with a hard timeout: a rank that fails or hangs fails the fixture, and
every test that reads it), lay a 2 x 2 (data x model) mesh and take one
optimizer step of each family from seeded weights, with unequal text and
mel lengths across the data ranks:
* gpt at dp 2 x tp 2 (GPT_PARAM_RULES) and vqvae at dp 2 (the EMA
  statistics summed over the data group): held against JAX's Trainer on a
  2 x 2 mesh of its CPU devices (conftest gives JAX 8), with the weights
  carried by xtts_tpu.utils.convert, at the tolerances of JAX's
  dryrun_multichip (loss rtol 3e-5; parameters rtol 3e-4 / atol 3e-5 after
  a step at its TrainConfig, whose warmup starts at lr 0) and the Adam
  moments, which carry the clipped gradient (first moment rtol 3e-4 /
  atol 1e-7, second rtol 3e-4 / atol 1e-10);
* diffusion (loss_second_moment), clvp, classifier and hifigan (a small
  generator: the GANTrainer's two updates are what run in parallel) at dp
  2, and gpt and vqvae too, and gpt_ema (gpt at dp 2 x tp 2 with EMA
  weights, whose copies shard with their parameters): held against the
  port's one-rank step on the global batch (itself held against JAX by test_torch_port_train_core /
  _train_diffusion / _train_gan): metrics and parameters at the same
  tolerances, the sampler's history and counts equal.
The gpt_ema trainer's state (EMA copies included) written at world size
4 restores at world size 1 bit for bit, and one written at world size 1
restores sharded at world size 4. The rules: the port's shard the same
parameters along the same dimension as JAX's partition_spec_tree on a
tiny GPT, names mapped. place_on_mesh over two CPU devices: a wave of 3
requests (padded to 4) gives the unplaced wave's codes and waveforms,
near-greedy against the 3-row wave (as JAX's test) and sampled against
the wave padded to the same 4 rows.
"""
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xtts_tpu_torch.core import config as tcfg  # noqa: E402
from xtts_tpu_torch.nn.blocks import init_flax_like  # noqa: E402
from xtts_tpu_torch.parallel import mesh as pm  # noqa: E402
from xtts_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from xtts_tpu_torch.train import trainer as ttr  # noqa: E402

WORLD, N_DATA, N_MODEL = 4, 2, 2
TIMEOUT = 240
MB = 8
B = 4                       # global batch: 2 rows a data rank
LOSS_RTOL = 3e-5
PARAM_TOL = dict(rtol=3e-4, atol=3e-5)
MU_TOL = dict(rtol=3e-4, atol=1e-7)
NU_TOL = dict(rtol=3e-4, atol=1e-10)
FAMILIES = ("gpt", "gpt_ema", "vqvae", "diffusion", "clvp", "classifier",
            "hifigan")
EMA_DECAY = 0.999           # the gpt_ema family: gpt with EMA weights
# the dryrun's TrainConfig (__graft_entry__.dryrun_multichip)
TRAIN = tcfg.TrainConfig(accum_grad=1, warmup_steps=2, train_steps=10)
# a moving step for the families held against the port's own one-rank step
MOVING = tcfg.TrainConfig(accum_grad=1, lr=1e-3, warmup_steps=0,
                          train_steps=10, lr_schedule="constant")

DVAE_CFG = tcfg.DVAEConfig(channels=MB, num_tokens=30, hidden_dim=16,
                           num_resnet_blocks=1, codebook_dim=16,
                           num_layers=2)
GPT_CFG = tcfg.GPTConfig(layers=2, model_dim=32, heads=4, max_mel_tokens=24,
                         max_text_tokens=16, number_text_tokens=16,
                         start_text_token=15, number_mel_codes=32,
                         start_mel_token=30, stop_mel_token=31, mel_bins=MB,
                         cond_attn_blocks=1)
DIFF_CFG = tcfg.DiffusionModelConfig(
    in_channels=MB, out_channels=2 * MB, model_channels=16,
    num_res_blocks=1, channel_mult=(1,), num_heads=2, context_dim=16,
    in_latent_channels=GPT_CFG.model_dim,
    clip=tcfg.CLIPRefConfig(embed_dim=16, width=16, layers=1, head_width=8,
                            patch_size=4, in_channels=MB, max_patches=64))
CLVP_CFG = tcfg.CLVPConfig(dim_text=16, dim_speech=16, dim_latent=16,
                           num_text_tokens=32, text_enc_depth=1,
                           text_seq_len=16, text_heads=2,
                           num_speech_tokens=64, speech_enc_depth=1,
                           speech_heads=2)
CLF_CFG = tcfg.ClassifierConfig(spec_dim=MB, embedding_dim=16, depth=2,
                                base_channels=4, resnet_blocks=1,
                                attn_blocks=1, num_attn_heads=2)
STFT_RES = ((256,), (64,), (128,))


def _seeded(module, seed):
    init_flax_like(module, torch.Generator().manual_seed(seed))
    return module


def gpt_dvae():
    from xtts_tpu_torch.models.dvae import DVAE
    from xtts_tpu_torch.models.gpt import UnifiedVoice
    return _seeded(UnifiedVoice(GPT_CFG), 1), _seeded(DVAE(DVAE_CFG), 0)


def batches():
    """Each family's global batch (numpy), lengths unequal across the data
    ranks' rows."""
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "gpt": {"cond_mel": f32(B, MB, 40),
                "text": rng.integers(2, 14, (B, 8)),
                "text_lengths": np.array([8, 6, 3, 2]),
                "mel": f32(B, MB, 32),
                "wav_lengths": np.array([7, 8, 2, 3]) * 1024 - 5},
        "vqvae": {"mel": f32(B, MB, 32)},
        "diffusion": {"mel": f32(B, MB, 32), "refer_mel": f32(B, MB, 24),
                      "text": rng.integers(2, 14, (B, 8)),
                      "text_lengths": np.array([8, 7, 4, 3]),
                      "wav_lengths": np.array([8, 6, 3, 2]) * 1024}
        ,
        "clvp": {"text": rng.integers(0, 30, (B, 6)),
                 "codes": rng.integers(0, 60, (B, 8)),
                 "text_mask": (np.arange(6)[None] < np.array(
                     [[6], [5], [3], [2]])).astype(np.int64),
                 "code_mask": (np.arange(8)[None] < np.array(
                     [[8], [7], [4], [2]])).astype(np.int64)},
        "classifier": {"mel": f32(B, 64, MB),
                       "label": np.array([0, 1, 1, 0])},
        "hifigan": {"wav": 0.3 * f32(B, 1024), "latent": f32(B, 16, 16)},
    }


def torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _gan(mesh):
    """A GANTrainer over a small generator (Linear + tanh onto the wav) and
    a one-period discriminator; the gen_fn has no frozen half."""
    from xtts_tpu_torch.models.hifigan_discriminator import \
        HifiganDiscriminator
    from xtts_tpu_torch.train.gan import GANTrainer
    lin = torch.nn.Linear(16, 64)
    g = torch.Generator().manual_seed(10)
    with torch.no_grad():
        lin.weight.normal_(0.0, 0.3, generator=g)
        lin.bias.normal_(0.0, 0.1, generator=g)
    disc = _seeded(HifiganDiscriminator(periods=(2,), scales=0), 9)

    def gen(b, latent=None):
        out = torch.tanh(lin(b["latent"]))
        return out.reshape(out.shape[0], -1)[:, :b["wav"].shape[1]]
    gen.latent_of = lambda b: None
    return GANTrainer(lin, disc, gen, g_lr=1e-3, d_lr=1e-3, grad_clip=1.0,
                      stft_resolutions=STFT_RES, mesh=mesh)


def family_trainer(family, mesh, ckpt=None):
    """(trainer, generator or None) of a family, built from seeded weights
    for `mesh` (None: one rank)."""
    from xtts_tpu_torch.train import steps
    if family == "hifigan":
        return _gan(mesh), None
    rules = pm.GPT_PARAM_RULES if family.startswith("gpt") else ()
    # the gpt families step at TRAIN's lr 0, as JAX's dryrun does: a moving
    # first Adam step turns on the sign of c_attn's key-bias gradients,
    # which are zero but for rounding
    cfg = TRAIN if family in ("gpt", "gpt_ema", "vqvae") else MOVING
    if family.startswith("gpt"):
        model, dvae = gpt_dvae()
        loss = steps.make_gpt_loss(model, dvae.eval(), mesh=mesh)
    elif family == "vqvae":
        _, model = gpt_dvae()
        loss = steps.make_dvae_loss(model, mesh=mesh)
    elif family == "diffusion":
        from xtts_tpu_torch.diffusion.gaussian import (
            GaussianDiffusion, get_named_beta_schedule)
        from xtts_tpu_torch.models.aa_diffusion import AADiffusion
        gpt, dvae = gpt_dvae()
        model = _seeded(AADiffusion(DIFF_CFG), 4)
        gd = GaussianDiffusion(betas=get_named_beta_schedule("linear", 100))
        loss = steps.make_diffusion_loss(
            model, gd, gpt.eval(), dvae.eval(),
            timestep_sampler="loss_second_moment", mesh=mesh)
    elif family == "clvp":
        from xtts_tpu_torch.models.clvp import CLVP, make_clvp_loss
        model = _seeded(CLVP(CLVP_CFG), 6)
        loss = make_clvp_loss(model, mesh=mesh)
    else:
        from xtts_tpu_torch.models.classifier import (AudioClassifier,
                                                      make_classifier_loss)
        model = _seeded(AudioClassifier(CLF_CFG), 7)
        loss = make_classifier_loss(model, mesh=mesh)
    tr = ttr.Trainer(model, loss, cfg, mesh=mesh, param_rules=rules,
                     checkpoint_dir=ckpt,
                     ema_decay=EMA_DECAY if family == "gpt_ema" else None)
    return tr, torch.Generator().manual_seed(5)


def _np_tree(d):
    return {k: v.detach().cpu().numpy().copy() for k, v in d.items()}


def one_step(family, mesh, ckpt=None):
    """One step of a family on `mesh`; its metrics, whole parameters,
    moments and state columns (numpy), and the trainer and state."""
    tr, g = family_trainer(family, mesh, ckpt)
    batch = torch_batch(batches()[family.replace("_ema", "")])
    if family == "hifigan":
        st = tr.init_state()
        st, m = tr.step(st, pm.shard_batch(batch, mesh))
        return {"metrics": {k: float(v) for k, v in m.items()},
                "params": {**_np_tree({"g." + k: v for k, v in
                                       st.g_params.items()}),
                           **_np_tree({"d." + k: v for k, v in
                                       st.d_params.items()})}}, tr, st
    st = tr.shard_state(tr.init_state())
    st, m = tr.step(st, tr.shard_batch(batch), g)
    full = tr.full_payload(st)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": _np_tree(full["params"]),
            "mu": _np_tree(full["opt_state"]["mu"]),
            "nu": _np_tree(full["opt_state"]["nu"]),
            "cols": _np_tree(full["state_cols"])}, tr, st


def rank_main(rank, tmp):
    """One rank of the 2 x 2 mesh: every family's step, the gpt_ema state
    saved at world size 4, and the world-size-1 checkpoint restored
    sharded. Rank 0 returns the results."""
    mesh = pm.make_mesh(N_DATA, N_MODEL)
    out = {}
    for fam in FAMILIES:
        ckpt = os.path.join(tmp, "ckpt4") if fam == "gpt_ema" else None
        out[fam], tr, st = one_step(fam, mesh, ckpt)
        if fam == "gpt_ema":
            tr.save(st, wait=True)
    tr, _ = family_trainer("gpt_ema", mesh, os.path.join(tmp, "ckpt1"))
    st = tr.restore(tr.shard_state(tr.init_state()))
    full = tr.full_payload(st)
    out["restored"] = {"params": _np_tree(full["params"]),
                       "mu": _np_tree(full["opt_state"]["mu"]),
                       "cols": _np_tree(full["state_cols"]),
                       "step": st.step,
                       "shard_shapes": {k: tuple(v.shape) for k, v in
                                        st.params.items()}}
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def runs():
    """The one-rank steps (the world-size-1 gpt checkpoint among them),
    then the four ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        single = {}
        for fam in FAMILIES:
            ckpt = os.path.join(tmp, "ckpt1") if fam == "gpt_ema" else None
            single[fam], tr, st = one_step(fam, None, ckpt)
            if fam == "gpt_ema":
                tr.save(st, wait=True)
        ranks = run_ranks(rank_main, WORLD, (tmp,), timeout=TIMEOUT)[0]
        tr, _ = family_trainer("gpt_ema", None, os.path.join(tmp, "ckpt4"))
        st = tr.restore(tr.init_state())
        restored4 = {"params": _np_tree(st.params),
                     "mu": _np_tree(st.opt_state.mu),
                     "cols": _np_tree(st.state_cols), "step": st.step}
    torch.set_num_threads(n)
    return {"single": single, "ranks": ranks, "restored4": restored4}


def _close(got, want, tol, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=f"{what} {k}",
                                   **tol)


@pytest.mark.parametrize("family", FAMILIES)
def test_data_parallel_equals_one_rank(runs, family):
    got, want = runs["ranks"][family], runs["single"][family]
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    _close(got["params"], want["params"], PARAM_TOL, "params")
    if "mu" in want:
        _close(got["mu"], want["mu"], MU_TOL, "mu")
        _close(got["nu"], want["nu"], NU_TOL, "nu")
        for k in want["cols"]:
            if "t_sampler" in k:
                np.testing.assert_array_equal(got["cols"][k],
                                              want["cols"][k], err_msg=k)
            elif k.startswith("ema."):      # mixes the stepped parameters
                np.testing.assert_allclose(got["cols"][k], want["cols"][k],
                                           err_msg=k, **PARAM_TOL)
            else:
                np.testing.assert_allclose(got["cols"][k], want["cols"][k],
                                           rtol=1e-5, atol=1e-6, err_msg=k)


def test_tensor_parallel_shards_by_heads(runs):
    """The ranks held c_attn by whole heads of q, k and v, and every ruled
    parameter at its n_model-th."""
    shapes = runs["ranks"]["restored"]["shard_shapes"]
    d = GPT_CFG.model_dim
    assert shapes["gpt.h.0.attn.c_attn.weight"] == (d, 3 * d // N_MODEL)
    assert shapes["gpt.h.0.mlp.c_proj.weight"] == (4 * d // N_MODEL, d)
    assert shapes["mel_embedding.weight"] == (
        GPT_CFG.number_mel_codes // N_MODEL, d)
    assert shapes["mel_head.weight"] == (GPT_CFG.number_mel_codes // N_MODEL,
                                         d)
    assert shapes["text_head.weight"] == (GPT_CFG.number_text_tokens + 1, d)


@pytest.mark.parametrize("direction", ["4->1", "1->4"])
def test_checkpoint_across_world_sizes(runs, direction):
    if direction == "4->1":
        got, want = runs["restored4"], runs["ranks"]["gpt_ema"]
    else:
        got, want = runs["ranks"]["restored"], runs["single"]["gpt_ema"]
    assert got["step"] == 1
    assert any(k.startswith("ema.") for k in want["cols"])
    for part in ("params", "mu", "cols"):
        assert set(got[part]) == set(want[part])
        for k in want[part]:
            np.testing.assert_array_equal(got[part][k], want[part][k],
                                          err_msg=f"{part} {k}")


# ---------------------------------------------------------------------------
# against JAX's sharded Trainer


def _jax_mesh():
    import jax
    from xtts_tpu.parallel.mesh import make_mesh
    return make_mesh(N_DATA, N_MODEL, devices=jax.devices()[:WORLD])


def _jax_pair():
    """JAX's GPT and DVAE with the port's seeded weights."""
    from xtts_tpu.core.config import DVAEConfig, GPTConfig
    from xtts_tpu.models.dvae import DVAE
    from xtts_tpu.models.gpt import UnifiedVoice
    from xtts_tpu.utils import convert as jconv
    gpt, dvae = gpt_dvae()
    gsd = {k: v.numpy() for k, v in gpt.state_dict().items()}
    dsd = {k: v.numpy() for k, v in dvae.state_dict().items()}
    jg = UnifiedVoice(GPTConfig.from_dict(GPT_CFG.to_dict()))
    jd = DVAE(DVAEConfig.from_dict(DVAE_CFG.to_dict()))
    gvars = {"params": jconv.unified_voice_from_reference(
        gsd, GPT_CFG.layers, GPT_CFG.cond_attn_blocks)}
    dvars = jconv.dvae_from_reference(dsd, DVAE_CFG.num_layers,
                                      DVAE_CFG.num_resnet_blocks)
    return jg, gvars, jd, dvars


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's Trainer, one step of gpt (GPT_PARAM_RULES) and vqvae on a
    2 x 2 mesh, the results as the port's state dicts."""
    import jax
    import jax.numpy as jnp
    from xtts_tpu.core.config import TrainConfig
    from xtts_tpu.parallel.mesh import GPT_PARAM_RULES
    from xtts_tpu.train.steps import make_dvae_loss, make_gpt_loss
    from xtts_tpu.train.trainer import Trainer
    from xtts_tpu_torch.utils import convert
    jg, gvars, jd, dvars = _jax_pair()
    mesh = _jax_mesh()
    tc = TrainConfig(accum_grad=1, warmup_steps=2, train_steps=10)
    bat = batches()
    to_j = lambda b: {k: jnp.asarray(v.astype(np.int32) if v.dtype.kind  # noqa: E731
                                     == "i" else v) for k, v in b.items()}
    out = {}
    for fam, loss, params, cols, rules, to_sd in (
            ("gpt", make_gpt_loss(jg, jd, dvars), gvars["params"], None,
             GPT_PARAM_RULES,
             lambda t: convert.unified_voice_from_jax(
                 t, GPT_CFG.layers, GPT_CFG.cond_attn_blocks)),
            ("vqvae", make_dvae_loss(jd), dvars["params"],
             {"codebook": dict(dvars["codebook"])}, (),
             lambda t: convert.dvae_from_jax(t, DVAE_CFG.num_layers,
                                             DVAE_CFG.num_resnet_blocks))):
        tr = Trainer(loss, tc, mesh=mesh, param_rules=rules,
                     frozen=getattr(loss, "frozen", None))
        st = tr.shard_state(tr.init_state(
            jax.tree_util.tree_map(jnp.asarray, params), cols))
        st, m = tr.step(st, tr.shard_batch(to_j(bat[fam])),
                        jax.random.PRNGKey(2))
        np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        jcols = np_(st.state_cols)
        adam = convert._find_adam(np_(st.opt_state))
        out[fam] = {"metrics": {k: float(v) for k, v in m.items()},
                    "params": to_sd({"params": np_(st.params), **jcols}),
                    "mu": to_sd({"params": adam.mu, **jcols}),
                    "nu": to_sd({"params": adam.nu, **jcols})}
    return out


@pytest.mark.parametrize("family", ["gpt", "vqvae"])
def test_sharded_step_equals_jax(runs, jax_runs, family):
    got, want = runs["ranks"][family], jax_runs[family]
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   rtol=LOSS_RTOL, err_msg=k)
    names = set(got["params"])
    for part, tol in (("params", PARAM_TOL), ("mu", MU_TOL),
                      ("nu", NU_TOL)):
        for k in names:
            np.testing.assert_allclose(got[part][k], want[part][k],
                                       err_msg=f"{part} {k}", **tol)
    if family == "vqvae":
        for k in ("codebook.embed", "codebook.cluster_size",
                  "codebook.embed_avg"):
            np.testing.assert_allclose(got["cols"][k], want["params"][k],
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_rules_match_jax():
    """Every parameter that JAX's GPT_PARAM_RULES shards on a tiny GPT, the
    port's rules shard along the same dimension (names and layouts mapped
    through xtts_tpu.utils.convert: each port tensor holds arange values,
    so its JAX counterpart is itself or its transpose), and no other."""
    import jax
    from xtts_tpu.parallel.mesh import (GPT_PARAM_RULES,
                                        partition_spec_tree)
    from xtts_tpu.utils import convert as jconv
    gpt, _ = gpt_dvae()
    sd = {k: np.arange(v.numel(), dtype=np.float64).reshape(v.shape)
          + 1e6 * i for i, (k, v) in enumerate(gpt.state_dict().items())}
    tree = jconv.unified_voice_from_reference(sd, GPT_CFG.layers,
                                              GPT_CFG.cond_attn_blocks)
    jspecs = partition_spec_tree(tree, GPT_PARAM_RULES)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    specs = dict(jax.tree_util.tree_leaves_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    by_first = {float(np.asarray(leaf).min()): (path, leaf)
                for path, leaf in flat}
    port = pm.partition_spec_tree(gpt.state_dict(), pm.GPT_PARAM_RULES)
    n_sharded = 0
    for name, arr in sd.items():
        path, leaf = by_first[float(arr.min())]
        leaf = np.asarray(leaf)
        spec = specs[path]
        jdim = next((i for i, s in enumerate(spec) if s is not None), None)
        if jdim is None:
            assert port[name] is pm.REPLICATED, name
            continue
        n_sharded += 1
        if leaf.shape == arr.shape and np.array_equal(leaf, arr):
            want = jdim
        else:
            assert np.array_equal(leaf, arr.T), name
            want = 1 - jdim
        assert port[name] == want, (name, port[name], want)
    assert n_sharded == 6 * GPT_CFG.layers + 3


# ---------------------------------------------------------------------------
# multi-device serving


def _placed_and_unplaced(settings, buckets, use_diffusion):
    """One wave of 3 requests on the tiny model, unplaced (rows padded to
    `buckets`), then over two CPU replicas (padded to 4): each run's
    (waveforms, codes) and the replicas."""
    from test_torch_port_e2e import TINY_T as TINY
    from xtts_tpu_torch.infer.api import TextToSpeech
    from xtts_tpu_torch.infer.serving import SynthesisRequest, _synthesize
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tts = TextToSpeech(TINY, device="cpu", quantized_decode=True,
                           generator=torch.Generator().manual_seed(3))
        rng = np.random.default_rng(4)
        cond = torch.from_numpy(rng.standard_normal(
            (1, TINY.gpt.mel_bins, 40)).astype(np.float32))
        reqs = [SynthesisRequest(np.array(t)) for t in
                ([1, 3, 4, 2], [1, 5, 2], [1, 6, 7, 2])]
        runs = []
        for devices in (None, ["cpu", "cpu"]):
            tts.place_on_mesh(devices)
            wavs, codes = _synthesize(
                tts, reqs, cond, settings, use_diffusion=use_diffusion,
                generator=torch.Generator().manual_seed(4),
                batch_buckets=buckets if devices is None else None)
            runs.append((wavs, [c.numpy() for c in codes]))
        replicas = tts.replicas
    finally:
        torch.set_num_threads(n)
    return runs, replicas


def test_place_on_mesh_equals_unplaced():
    """B=3 over two CPU replicas (padded to 4 with request 0), near-greedy
    as in JAX's test: codes and shortcut-rendered waveforms equal the
    unplaced B=3 wave's."""
    from xtts_tpu_torch.infer.api import TTSSettings
    (base, placed), reps = _placed_and_unplaced(
        TTSSettings(max_mel_tokens=8, temperature=1e-4), None, False)
    assert len(placed[0]) == 3 and len(reps) == 2
    for a, b in zip(base[1], placed[1]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(base[0], placed[0]):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_place_on_mesh_sampled_draws_equal_unplaced():
    """Sampled at the default settings (temperature 0.8, top_p 0.8)
    through the diffusion render: the replicas
    draw the whole wave's numbers for their rows (parallel.mesh.row_block),
    so codes and waveforms equal the unplaced wave's over the same padded
    rows (batch_buckets=(4,))."""
    from xtts_tpu_torch.infer.api import TTSSettings
    (base, placed), _ = _placed_and_unplaced(
        TTSSettings(max_mel_tokens=8, diffusion_steps=2), (4,), True)
    assert len(placed[0]) == 3
    for a, b in zip(base[1], placed[1]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(base[0], placed[0]):
        np.testing.assert_allclose(a, b, atol=1e-5)
