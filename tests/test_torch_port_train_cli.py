"""The port's training CLI (xtts_tpu_torch/train/cli.py) end to end on the
CPU: `main` for vqvae, then gpt with --dvae-weights set to the vqvae
export, on a 3-wav corpus, 2 steps each with --val-filelist; a --resume run
continues from the checkpoint. The exports carry to the JAX package:
its load_model reads <family>.pth and gives the port's DVAE codes (equal)
and the port's GPT losses (within 1e-5 relative) on the same inputs; the
port's TextToSpeech.from_pretrained loads them.

Then the other four families on a config with tiny diffusion, CLVP,
classifier and HiFi-GAN sections, on the vqvae and gpt exports: diffusion
(its eval render through a Vocos export; with loss_second_moment, resumed
from its checkpoint with the sampler's history bit for bit), clvp (on the
cached codes), classifier (clean and noise lists) and hifigan (2048-sample
crops, 0.5 s speaker references and a discriminator of periods 2 and 3
alone, for the CPU's sake; resumed), each 2 steps with an eval, a checkpoint and an export
that the registry loads back equal."""
import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xtts_tpu.core.config import (DVAEConfig, GPTConfig,  # noqa: E402
                                  MelConfig, TrainConfig, XTTSConfig)
from xtts_tpu.utils import registry as jreg  # noqa: E402
from xtts_tpu_torch.core import config as tcfg  # noqa: E402
from xtts_tpu_torch.data import datasets as tdata  # noqa: E402
from xtts_tpu_torch.data.audio import save_wav  # noqa: E402
from xtts_tpu_torch.train import cli  # noqa: E402
from test_torch_port_e2e import one_torch_thread  # noqa: E402,F401

MB = 8
CFG = XTTSConfig(
    mel=MelConfig(n_mels=MB),
    vqvae=DVAEConfig(channels=MB, num_tokens=30, hidden_dim=16,
                     num_resnet_blocks=1, codebook_dim=16, num_layers=2),
    gpt=GPTConfig(layers=2, model_dim=32, heads=2, max_mel_tokens=64,
                  max_text_tokens=32, number_mel_codes=200,
                  start_mel_token=198, stop_mel_token=199, mel_bins=MB,
                  cond_attn_blocks=1),
    train=TrainConfig(batch_size=2, accum_grad=1, lr_schedule="constant",
                      val_freq=1, save_freq=1, keep_ckpts=2,
                      dtype="float32"))


# the families after gpt: tiny sections over the same vqvae and gpt
CFG2 = tcfg.XTTSConfig.from_dict(CFG.to_dict()).replace(
    diffusion=tcfg.DiffusionModelConfig(
        in_channels=MB, out_channels=2 * MB, model_channels=32,
        num_res_blocks=1, channel_mult=(1,), num_heads=2, context_dim=32,
        in_latent_channels=32, clip=tcfg.CLIPRefConfig(
            width=32, layers=1, head_width=16, patch_size=8, in_channels=MB,
            max_patches=64)),
    diffusion_process=tcfg.DiffusionProcessConfig(timesteps=100),
    vocos=tcfg.VocosConfig(input_channels=MB, dim=16, intermediate_dim=32,
                           num_layers=1, n_fft=64, hop_length=256),
    clvp=tcfg.CLVPConfig(dim_text=32, dim_speech=32, dim_latent=16,
                         num_text_tokens=256, text_enc_depth=1,
                         text_seq_len=64, text_heads=2,
                         num_speech_tokens=64, speech_enc_depth=1,
                         speech_heads=2),
    classifier=tcfg.ClassifierConfig(spec_dim=MB, base_channels=16, depth=2,
                                     resnet_blocks=1, attn_blocks=1,
                                     num_attn_heads=2, embedding_dim=32),
    hifigan=tcfg.HiFiGANConfig(decoder_input_dim=32,
                               upsample_initial_channel=32,
                               resblock_kernel_sizes=(3,),
                               resblock_dilation_sizes=((1, 3),),
                               d_vector_dim=16))
NEW = ("diffusion", "clvp", "classifier", "hifigan")


class Tok:
    """A stand-in tokenizer (no `tokenizers` needed): characters -> ids
    3-250."""

    vocab_size = 251

    def encode(self, s):
        return [3 + ord(c) % 248 for c in s]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    lines = []
    for i in range(3):
        t = np.arange(int(24000 * (1.0 + 0.4 * i))) / 24000
        w = (0.3 * np.sin(2 * np.pi * (180 + 40 * i) * t)
             + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
        save_wav(str(d / f"c{i}.wav"), w)
        lines.append(f"c{i}|{d}/c{i}.wav|spk|zh|raw|ni3 hao3 {i}")
    (d / "list.txt").write_text("\n".join(lines) + "\n")
    tcfg.XTTSConfig.from_dict(CFG.to_dict()).to_json(str(d / "cfg.json"))
    common = ["-c", str(d / "cfg.json"), "--filelist", str(d / "list.txt"),
              "--val-filelist", str(d / "list.txt"), "--device", "cpu"]
    vq = cli.main(["vqvae", "-m", str(d / "vq"), "--steps", "2"] + common)
    gpt_args = ["gpt", "-m", str(d / "gpt"),
                "--dvae-weights", str(d / "vq" / "vqvae.pth")] + common
    gpt = cli.main(gpt_args + ["--steps", "2"], tokenizer=Tok())
    resumed = cli.main(gpt_args + ["--steps", "3", "--resume"],
                       tokenizer=Tok())
    return d, vq, gpt, resumed


@pytest.fixture(scope="module")
def new_runs(runs):
    """The four families after gpt, 2 steps each through cli.main on CFG2;
    diffusion (loss_second_moment) and hifigan resumed to step 3."""
    from xtts_tpu_torch.core.logging import MetricLogger
    from xtts_tpu_torch.data.prepare import cache_mels, cache_vq_codes
    from xtts_tpu_torch.dsp.mel import MelFrontend
    from xtts_tpu_torch.utils import registry
    d = runs[0]
    media = []       # (log dir, tag, shape) of each eval image and wav
    spy = lambda self, step, tag, x, **kw: media.append(
        (os.path.basename(os.path.dirname(self.log_dir)), tag, x.shape))
    mp = pytest.MonkeyPatch()
    mp.setattr(MetricLogger, "image_mel", spy)
    mp.setattr(MetricLogger, "audio", spy)
    CFG2.to_json(str(d / "cfg2.json"))
    wavs = [str(d / f"c{i}.wav") for i in range(3)]
    (d / "clean.txt").write_text("\n".join(wavs) + "\n")
    (d / "noise.txt").write_text("\n".join(wavs[1:]) + "\n")
    cache_mels(wavs, MelFrontend(CFG2.mel, "cpu"))
    cache_vq_codes(wavs, registry.load_model(
        "vqvae", CFG2, str(d / "vq" / "vqvae.pth"), device="cpu"))
    voc = registry.load_model("vocos", CFG2, device="cpu")
    torch.save(voc.state_dict(), d / "vocos.pth")
    common = ["-c", str(d / "cfg2.json"), "--filelist", str(d / "list.txt"),
              "--val-filelist", str(d / "list.txt"), "--device", "cpu",
              "--dvae-weights", str(d / "vq" / "vqvae.pth"),
              "--gpt-weights", str(d / "gpt" / "gpt.pth")]
    diff = ["diffusion", "-m", str(d / "diffusion"), "--vocos-weights",
            str(d / "vocos.pth"), "--timestep-sampler",
            "loss_second_moment"] + common
    out = {"diffusion": [cli.main(diff + ["--steps", "2"], tokenizer=Tok())]}
    out["diffusion"].append(cli.main(diff + ["--steps", "3", "--resume"],
                                     tokenizer=Tok()))
    out["clvp"] = [cli.main(["clvp", "-m", str(d / "clvp"), "--steps", "2"]
                            + common, tokenizer=Tok())]
    out["classifier"] = [cli.main(
        ["classifier", "-m", str(d / "classifier"), "--steps", "2", "-c",
         str(d / "cfg2.json"), "--filelist", str(d / "clean.txt"),
         "--noise-filelist", str(d / "noise.txt"), "--val-filelist",
         str(d / "clean.txt"), "--device", "cpu"])]
    hifi = ["hifigan", "-m", str(d / "hifigan")] + common
    from xtts_tpu_torch.models.hifigan_discriminator import (
        HifiganDiscriminator)
    mp.setattr(tdata, "HifiGANDataset", functools.partial(
        tdata.HifiGANDataset, crop_samples=2048, refer_sec=0.5))
    mp.setitem(registry.MODELS["hifigan_discriminator"], "build",
               lambda cfg, dt: HifiganDiscriminator((2, 3), 0, dt))
    try:
        out["hifigan"] = [cli.main(hifi + ["--steps", "2"], tokenizer=Tok()),
                          cli.main(hifi + ["--steps", "3", "--resume"],
                                   tokenizer=Tok())]
    finally:
        mp.undo()
    return d, out, media


def _records(path):
    return [json.loads(x) for x in path.read_text().splitlines()]


def test_new_families_train_eval_checkpoint_and_export(new_runs):
    from xtts_tpu_torch.utils.registry import load_model
    d, out = new_runs[:2]
    for fam in NEW:
        recs = _records(d / fam / "logs" / "metrics.jsonl")
        key = "g_loss" if fam == "hifigan" else "loss"
        train = [r for r in recs if key in r]
        assert [r["step"] for r in train] == [1, 2] + (
            [3] if fam in ("diffusion", "hifigan") else []), fam
        assert all(np.isfinite(r[key]) for r in train), fam
        if fam != "hifigan":
            evals = [r for r in recs if "eval/loss" in r]
            assert evals and all(np.isfinite(r["eval/loss"]) for r in evals)
        path = d / fam / f"{fam}.pth"
        module = load_model(fam, CFG2, str(path), device="cpu")
        saved = torch.load(path, weights_only=True)
        for k, v in module.state_dict().items():
            assert torch.equal(v, saved[k]), (fam, k)
    assert (d / "hifigan" / "ckpt" / "3.pt").exists()
    # the eval renders: the diffusion family's DDIM mel and its wav through
    # the Vocos export at each of its 3 evals, the hifigan family's wav
    media = new_runs[2]
    tags = lambda fam: [m[1] for m in media if m[0] == fam]
    assert tags("diffusion").count("eval/mel_diffusion") == 3
    assert tags("diffusion").count("eval/wav") == 3
    assert tags("hifigan").count("eval/wav_gen") == 3


def test_resume_carries_the_timestep_sampler_and_the_gan_state(new_runs):
    """The diffusion run's loss_second_moment history and counts at step 2
    equal its checkpoint's bit for bit, and the resumed run went on from
    them (3 steps of 2 draws counted); the GAN checkpoint holds both
    parameter sets and both optimizer states, and the resumed run's step
    and counts continue from it."""
    d, out = new_runs[:2]
    first, resumed = out["diffusion"]
    saved = torch.load(d / "diffusion" / "ckpt" / "2.pt", weights_only=True)
    for k in ("t_sampler.history", "t_sampler.counts"):
        assert torch.equal(first.state_cols[k], saved["state_cols"][k]), k
    assert int(saved["state_cols"]["t_sampler.counts"].sum()) == 4
    assert int(resumed.state_cols["t_sampler.counts"].sum()) == 6
    assert resumed.step == 3 and resumed.opt_state.count == 3
    g1, g2 = out["hifigan"]
    gan = torch.load(d / "hifigan" / "ckpt" / "3.pt", weights_only=True)
    assert sorted(gan) == ["d", "d_opt", "g", "g_opt", "step"]
    assert g1.step == 2 and g2.step == gan["step"] == 3
    assert g2.g_opt.count == g2.d_opt.count == 3
    for k, v in g2.g_params.items():
        assert torch.equal(v, gan["g"][k]), k


def test_runs_write_checkpoints_logs_and_exports(runs):
    d, vq, gpt, resumed = runs
    assert vq.step == gpt.step == 2 and resumed.step == 3
    for fam in ("vq", "gpt"):
        assert (d / fam / ("vqvae.pth" if fam == "vq" else "gpt.pth")).exists()
        recs = [json.loads(l) for l in
                (d / fam / "logs" / "metrics.jsonl").read_text().splitlines()]
        train = [r for r in recs if "loss" in r]
        evals = [r for r in recs if "eval/loss" in r]
        assert [r["step"] for r in train][:2] == [1, 2]
        assert evals and all(np.isfinite(r["eval/loss"]) for r in evals)
        assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0
                   for r in train)
    # keep_ckpts 2: the gpt run's checkpoints 2 and 3 remain
    assert sorted(os.listdir(d / "gpt" / "ckpt")) == ["2.pt", "3.pt"]
    assert "loss_text" in train[0] and "loss_mel" in train[0]


def test_exports_load_in_jax_and_from_pretrained(runs):
    d, _, _, _ = runs
    from xtts_tpu_torch.infer.api import TextToSpeech
    from xtts_tpu_torch.utils.registry import load_model
    tc = tcfg.XTTSConfig.from_dict(CFG.to_dict())
    mel = np.random.default_rng(1).standard_normal(
        (2, MB, 48)).astype(np.float32)
    tdv = load_model("vqvae", tc, str(d / "vq" / "vqvae.pth"), device="cpu")
    jm, jv = jreg.load_model("vqvae", CFG,
                             weights_path=str(d / "vq" / "vqvae.pth"))
    want = jax.jit(lambda v, m: jm.apply(
        v, m, method=jm.get_codebook_indices))(jv, mel)
    codes = tdv.get_codebook_indices(torch.from_numpy(mel))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want))

    tg = load_model("gpt", tc, str(d / "gpt" / "gpt.pth"), device="cpu")
    jg, jgv = jreg.load_model("gpt", CFG,
                              weights_path=str(d / "gpt" / "gpt.pth"))
    rng = np.random.default_rng(2)
    cond = rng.standard_normal((2, MB, 20)).astype(np.float32)
    text = rng.integers(3, 250, (2, 10)).astype(np.int32)
    tl = np.array([10, 6], np.int32)
    wl = np.array([12 * 1024, 7 * 1024], np.int32)
    jl = jax.jit(lambda v: jg.apply(v, cond, text, tl, np.asarray(want), wl))(
        jgv)
    with torch.no_grad():
        got = tg(torch.from_numpy(cond), torch.from_numpy(text).long(),
                 torch.from_numpy(tl).long(), codes,
                 torch.from_numpy(wl).long())
    np.testing.assert_allclose([float(g) for g in got],
                               [float(j) for j in jl], rtol=1e-5)

    pre = d / "pretrained"
    pre.mkdir()
    for src in (d / "vq" / "vqvae.pth", d / "gpt" / "gpt.pth"):
        (pre / src.name).write_bytes(src.read_bytes())
    tts = TextToSpeech.from_pretrained(str(pre), tc, device="cpu")
    for k, v in tg.state_dict().items():
        assert torch.equal(tts.gpt.state_dict()[k], v), k
    assert torch.equal(tts.dvae.codebook.embed, tdv.codebook.embed)


@pytest.mark.parametrize("family", ["diffusion", "clvp", "hifigan",
                                    "classifier"])
def test_unported_families_are_refused(new_runs, family):
    """The four families the CLI refused before they were ported now
    train: each run through cli.main reached its steps (no refusal)."""
    assert family in cli.FAMILIES and not hasattr(cli, "refuse")
    assert all(st.step >= 2 for st in new_runs[1][family])


def test_the_card_is_the_default(runs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    d = runs[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["vqvae", "-m", str(d / "x"), "--filelist",
                  str(d / "list.txt")])


def test_save_npz_round_trip(tmp_path):
    """registry.save_npz writes the JAX package's flat layout: JAX's
    unflatten_npz reads the tree back, and the port's load_model(.npz)
    gives JAX's codes."""
    from xtts_tpu_torch.utils.registry import load_model, save_npz
    jm, jv = jreg.load_model("vqvae", CFG)
    tree = jax.tree_util.tree_map(np.asarray, jv)
    path = str(tmp_path / "vqvae.npz")
    save_npz(path, {"params": tree["params"],
                    "codebook": {k: torch.from_numpy(np.array(v))
                                 for k, v in tree["codebook"].items()}})
    back = jreg.unflatten_npz(np.load(path))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    mel = np.random.default_rng(3).standard_normal(
        (1, MB, 40)).astype(np.float32)
    want = jax.jit(lambda v, m: jm.apply(
        v, m, method=jm.get_codebook_indices))(jv, mel)
    port = load_model("vqvae", tcfg.XTTSConfig.from_dict(CFG.to_dict()),
                      path, device="cpu")
    np.testing.assert_array_equal(
        port.get_codebook_indices(torch.from_numpy(mel)).numpy(),
        np.asarray(want))
