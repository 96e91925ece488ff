"""The port's training CLI (xtts_tpu_torch/train/cli.py) end to end on the
CPU: `main` for vqvae, then gpt with --dvae-weights set to the vqvae
export, on a 3-wav corpus, 2 steps each with --val-filelist; a --resume run
continues from the checkpoint. The exports carry to the JAX package:
its load_model reads <family>.pth and gives the port's DVAE codes (equal)
and the port's GPT losses (within 1e-5 relative) on the same inputs; the
port's TextToSpeech.from_pretrained loads them."""
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
def test_unported_families_are_refused(runs, family):
    d = runs[0]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main([family, "-m", str(d / family), "--filelist",
                  str(d / "list.txt"), "--device", "cpu"])


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
