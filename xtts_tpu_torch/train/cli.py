"""Training CLI — `python -m xtts_tpu_torch.train.cli <model> -c cfg.json -m
expdir --filelist train.txt` (port of xtts_tpu/train/cli.py; the reference
recipe's stages, ttts/train_step.py:1-6):

  python -m xtts_tpu_torch.train.cli vqvae -c cfg.json -m exp/vqvae \\
      --filelist train.txt
  python -m xtts_tpu_torch.train.cli gpt -c cfg.json -m exp/gpt \\
      --filelist train.txt --tokenizer tokenizer.json \\
      --dvae-weights exp/vqvae/vqvae.pth
  python -m xtts_tpu_torch.train.cli diffusion -c cfg.json -m exp/diff \\
      --filelist train.txt --tokenizer tokenizer.json \\
      --dvae-weights exp/vqvae/vqvae.pth --gpt-weights exp/gpt/gpt.pth \\
      [--vocos-weights vocos.pth] [--timestep-sampler loss_second_moment]
  python -m xtts_tpu_torch.train.cli clvp -c cfg.json -m exp/clvp \\
      --filelist train.txt --tokenizer tokenizer.json   # reads .melvq.npy
  python -m xtts_tpu_torch.train.cli classifier -c cfg.json -m exp/cls \\
      --filelist clean.txt --noise-filelist noise.txt   # wav-path lists
  python -m xtts_tpu_torch.train.cli hifigan -c cfg.json -m exp/hifigan \\
      --filelist train.txt --tokenizer tokenizer.json \\
      --dvae-weights exp/vqvae/vqvae.pth --gpt-weights exp/gpt/gpt.pth

Each family reads a bucketed dataset (data/datasets.py), trains with the
generic Trainer (clip, AdamW, schedule; the hifigan family with the
GANTrainer, train/gan.py), keeps rotated checkpoints of the whole state
under <expdir>/ckpt (--resume continues exactly), logs JSONL (and
TensorBoard where it imports) under <expdir>/logs, evaluates on
--val-filelist every train.val_freq steps (the hifigan family renders an
eval wav every train.val_freq steps), and exports <expdir>/<family>.pth: a
state dict under the reference's names, buffers included, which
--dvae-weights / --gpt-weights and TextToSpeech.from_pretrained read.
Training runs on the card unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from xtts_tpu_torch.core.config import XTTSConfig

FAMILIES = ("vqvae", "gpt", "diffusion", "clvp", "hifigan", "classifier")
# the families whose datasets read text through the tokenizer
TEXT_FAMILIES = ("gpt", "diffusion", "clvp", "hifigan")


def _wav_paths(path: str):
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def _clvp_code_cap(cfg: XTTSConfig) -> int:
    cap = min(430, cfg.clvp.speech_seq_len)
    if not cfg.clvp.use_xformers:
        # the live tower's speech position table is sized num_speech_tokens
        # (ttts/clvp/model.py:98)
        cap = min(cap, cfg.clvp.num_speech_tokens)
    return cap


def build_dataset(model: str, cfg: XTTSConfig, filelist: str, tokenizer,
                  seed: int, device="cuda", noise_filelist: str = None):
    """The family's dataset over a 6-field filelist (the classifier: a
    clean and a noise list of wav paths); mels from the `.mel.npy` beside
    each wav, else the MelFrontend on `device`."""
    from xtts_tpu_torch.data.datasets import (ClassifierDataset, CLVPDataset,
                                              DiffusionDataset, GptTTSDataset,
                                              MelCache, VQVAEMelDataset,
                                              read_filelist)
    from xtts_tpu_torch.dsp.mel import MelFrontend
    mel_cache = MelCache(MelFrontend(cfg.mel, device), cfg.mel.sample_rate)
    if model == "classifier":
        if noise_filelist is None:
            raise ValueError("the classifier trains on --filelist (clean "
                             "wav paths) and --noise-filelist (noisy ones)")
        return ClassifierDataset(_wav_paths(filelist),
                                 _wav_paths(noise_filelist), mel_cache,
                                 seed=seed)
    entries = read_filelist(filelist)
    if model == "vqvae":
        return VQVAEMelDataset(entries, mel_cache, seed=seed)
    # token ids at or past the cap would index the text embedding out of
    # range or collide with the reserved specials (the shipped vocab 255 /
    # number_text_tokens 256)
    cap = (cfg.clvp.num_text_tokens if model == "clvp"
           else cfg.gpt.start_text_token)
    vocab = tokenizer.vocab_size
    vocab = vocab() if callable(vocab) else vocab
    if vocab > cap:
        what = ("CLVP text-embedding size" if model == "clvp"
                else "GPT id range (start_text_token)")
        raise ValueError(
            f"tokenizer vocab {vocab} exceeds the {what} {cap}: ids past it "
            f"would index the embedding out of range or collide with "
            f"reserved specials. Retrain the tokenizer smaller or raise the "
            f"config.")
    # the reference's reject limits (text > 300, mel > 2000,
    # ttts/gpt/dataset.py:72-74), never past the position tables
    if model == "gpt":
        return GptTTSDataset(entries, mel_cache, tokenizer,
                             max_text=min(300, cfg.gpt.max_text_tokens),
                             max_mel=min(2000, 4 * cfg.gpt.max_mel_tokens),
                             mel_hop=cfg.mel.hop_length, seed=seed)
    if model == "diffusion":
        return DiffusionDataset(
            entries, mel_cache, tokenizer,
            max_mel=min(400, 4 * cfg.gpt.max_mel_tokens),
            max_refer=min(300, 4 * cfg.gpt.max_mel_tokens),
            mel_hop=cfg.mel.hop_length, seed=seed)
    if model == "clvp":
        return CLVPDataset(entries, tokenizer,
                           max_text=min(350, cfg.clvp.text_seq_len),
                           max_codes=_clvp_code_cap(cfg))
    raise ValueError(f"no Trainer dataset for {model!r}")


def build_collate(model: str, cfg: Optional[XTTSConfig] = None):
    from xtts_tpu_torch.data.datasets import (MEL_BUCKETS, TEXT_BUCKETS,
                                              collate_bucketed)
    if model == "classifier":
        def collate(samples):
            samples = [s for s in samples if s is not None]
            if not samples:
                return None
            return {"mel": np.stack([s["mel"].T for s in samples]),
                    "label": np.stack([s["label"] for s in samples])}
        return collate

    def clamp(buckets, cap):
        """A bucket ladder that never pads past the model's capacity `cap`
        (a rung above a position table would index it out of range)."""
        if cap is None:
            return buckets
        return tuple(b for b in buckets if b < cap) + (cap,)

    t_cap = cfg.gpt.max_text_tokens if cfg else None
    m_cap = 4 * cfg.gpt.max_mel_tokens if cfg else None
    text_b = clamp(TEXT_BUCKETS, t_cap)
    mel_b = clamp(MEL_BUCKETS, m_cap)
    c_cap = None
    if cfg and model == "clvp":
        c_cap = _clvp_code_cap(cfg)
        text_b = clamp(TEXT_BUCKETS, cfg.clvp.text_seq_len)
    pads = {
        "vqvae": ({}, {}),
        "gpt": ({"text": 0, "mel": 1, "cond_mel": 1},
                {"text": text_b, "mel": mel_b, "cond_mel": MEL_BUCKETS}),
        "diffusion": ({"text": 0, "mel": 1, "refer_mel": 1},
                      {"text": text_b, "mel": mel_b, "refer_mel": mel_b}),
        "clvp": ({"text": 0, "codes": 0},
                 {"text": text_b, "codes": clamp((128, 256, 430), c_cap)}),
    }[model]
    return lambda samples: collate_bucketed(samples, pads[0], pads[1])


def adapt_batch(model: str, batch):
    """A collated numpy batch -> the field names each loss_fn takes."""
    if batch is None:
        return None
    if model == "gpt":
        return {"cond_mel": batch["cond_mel"], "text": batch["text"],
                "text_lengths": batch["text_length"], "mel": batch["mel"],
                "wav_lengths": batch["wav_length"]}
    if model == "diffusion":
        return {"mel": batch["mel"], "refer_mel": batch["refer_mel"],
                "text": batch["text"], "text_lengths": batch["text_length"],
                "wav_lengths": batch["wav_length"]}
    if model == "clvp":
        t, c = batch["text"], batch["codes"]
        return {"text": t, "codes": c,
                "text_mask": (np.arange(t.shape[1])[None]
                              < batch["text_length"][:, None]
                              ).astype(np.int32),
                "code_mask": (np.arange(c.shape[1])[None]
                              < batch["codes_length"][:, None]
                              ).astype(np.int32)}
    return batch


def to_device(batch, device):
    """numpy fields -> tensors on `device` (integer fields as int64)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


def train_dtype(cfg: XTTSConfig) -> torch.dtype:
    """Compute dtype of the TRAINED model (TrainConfig.dtype; parameters
    stay f32). Frozen models (the DVAE's codes, the GPT's latents) stay
    f32: the reference runs them under no_grad outside autocast
    (ttts/gpt/train_ms.py:216-218, ttts/diffusion/train_ms.py:311), and
    the VQ argmin and the latents feed targets."""
    table = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    if cfg.train.dtype not in table:
        raise ValueError(f"TrainConfig.dtype={cfg.train.dtype!r}: "
                         f"use one of {sorted(table)}")
    return table[cfg.train.dtype]


def _frozen(name: str, cfg: XTTSConfig, weights, device, g):
    """A frozen f32 module: eval mode, no parameter requiring grad."""
    from xtts_tpu_torch.utils.registry import load_model
    m = load_model(name, cfg, weights_path=weights, device=device,
                   generator=g).eval()
    return m.requires_grad_(False)


def build_loss(model: str, cfg: XTTSConfig, args, device="cuda"):
    """Returns (loss_fn, the trained module, ctx); ctx holds the modules the
    eval render reuses."""
    from xtts_tpu_torch.utils.registry import load_model
    dt = train_dtype(cfg)
    g = torch.Generator(device).manual_seed(0)
    if model == "vqvae":
        from xtts_tpu_torch.train.steps import make_dvae_loss
        m = load_model("vqvae", cfg, dtype=dt, device=device, generator=g)
        return make_dvae_loss(m, ema_decay=cfg.vqvae.ema_decay), m, {"dvae": m}
    if model == "gpt":
        from xtts_tpu_torch.train.steps import make_gpt_loss
        if cfg.train.remat != "none":
            cfg = cfg.replace(gpt=cfg.gpt.replace(remat=cfg.train.remat))
        gpt = load_model("gpt", cfg, dtype=dt, device=device, generator=g)
        dvae = _frozen("vqvae", cfg, args.dvae_weights, device, g)
        return (make_gpt_loss(gpt, dvae, cfg.train.text_weight,
                              cfg.train.mel_weight), gpt, {"dvae": dvae})
    if model == "diffusion":
        from xtts_tpu_torch.diffusion.gaussian import (GaussianDiffusion,
                                                       get_named_beta_schedule)
        from xtts_tpu_torch.train.steps import make_diffusion_loss
        if cfg.train.remat != "none":
            cfg = cfg.replace(
                diffusion=cfg.diffusion.replace(remat=cfg.train.remat))
        # flash=False (the default), as JAX's trainers keep it
        diff = load_model("diffusion", cfg, dtype=dt, device=device,
                          generator=g)
        gpt = _frozen("gpt", cfg, args.gpt_weights, device, g)
        dvae = _frozen("vqvae", cfg, args.dvae_weights, device, g)
        dp = cfg.diffusion_process
        gd = GaussianDiffusion(betas=get_named_beta_schedule(dp.schedule,
                                                             dp.timesteps))
        loss_fn = make_diffusion_loss(
            diff, gd, gpt, dvae, cfg.diffusion.unconditioned_percentage,
            getattr(args, "timestep_sampler", "uniform"))
        return loss_fn, diff, {"diff": diff, "gpt": gpt, "dvae": dvae}
    if model == "clvp":
        from xtts_tpu_torch.models.clvp import make_clvp_loss
        m = load_model("clvp", cfg, dtype=dt, device=device, generator=g)
        return make_clvp_loss(m), m, {}
    if model == "classifier":
        from xtts_tpu_torch.models.classifier import make_classifier_loss
        m = load_model("classifier", cfg, dtype=dt, device=device,
                       generator=g)
        return make_classifier_loss(m), m, {}
    raise ValueError(f"no Trainer loss for {model!r}")


def build_eval_render(model: str, cfg: XTTSConfig, args, ctx, device="cuda"):
    """The family's held-out render for the eval loop (the reference's
    TensorBoard eval: ttts/vqvae/inference.py:31-115 recon mels,
    ttts/diffusion/train.py:213-247 one eval sample through the diffusion
    model and vocos). Returns render(batch, ml, step) or None."""
    if model == "vqvae":
        dvae = ctx["dvae"]

        @torch.no_grad()
        def render_vqvae(batch, ml, step):
            mel = batch["mel"][:1]
            recon, _ = dvae.decode(dvae.get_codebook_indices(mel))
            ml.image_mel(step, "eval/mel_gt", mel[0].float().cpu().numpy())
            ml.image_mel(step, "eval/mel_recon",
                         recon[0].float().cpu().numpy())

        return render_vqvae

    if model == "diffusion":
        from xtts_tpu_torch.diffusion.gaussian import GaussianDiffusion
        from xtts_tpu_torch.models.aa_diffusion import (
            denormalize_tacotron_mel, normalize_tacotron_mel)
        from xtts_tpu_torch.train.steps import diffusion_latent_fn
        from xtts_tpu_torch.utils.registry import load_model
        diff = ctx["diff"]
        latent_of = diffusion_latent_fn(ctx["gpt"], ctx["dvae"])
        vocos = None
        if getattr(args, "vocos_weights", None):
            vocos = load_model("vocos", cfg, weights_path=args.vocos_weights,
                               device=device).eval()
        dp = cfg.diffusion_process
        steps = max(2, min(15, dp.timesteps))
        gd = GaussianDiffusion.spaced(dp.timesteps, steps,
                                      schedule=dp.schedule)

        @torch.no_grad()
        def render_diffusion(batch, ml, step):
            b1 = {k: v[:1] for k, v in batch.items()}
            latent = latent_of(b1)
            refer = normalize_tacotron_mel(b1["refer_mel"])
            shape = (1, cfg.diffusion.in_channels, 4 * latent.shape[-1])
            out = gd.sample_loop(
                lambda x, t: diff(x, t, latent, refer), shape,
                generator=torch.Generator(device).manual_seed(step),
                sampler="ddim", device=device)
            mel = denormalize_tacotron_mel(out)
            ml.image_mel(step, "eval/mel_gt", b1["mel"][0].cpu().numpy())
            ml.image_mel(step, "eval/mel_diffusion",
                         mel[0].float().cpu().numpy())
            if vocos is not None:
                wav = vocos(mel)
                ml.audio(step, "eval/wav", wav[0].float().cpu().numpy(),
                         sample_rate=cfg.mel.sample_rate)

        return render_diffusion
    return None


def export_weights(model_dir: str, family: str, module, logger) -> str:
    """<model_dir>/<family>.pth: the module's state dict (the reference's
    names, buffers included), written atomically."""
    path = os.path.join(model_dir, f"{family}.pth")
    tmp = path + ".tmp"
    torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()},
               tmp)
    os.replace(tmp, path)
    logger.info("exported %s", path)
    return path


def build_gan_trainer(cfg: XTTSConfig, gpt_weights=None, dvae_weights=None,
                      device="cuda"):
    """The HiFi-GAN GANTrainer over the HifiDecoder (trained in the config's
    dtype) and the HifiganDiscriminator, with the frozen GPT and DVAE
    (ttts/hifigan/train_ms.py:62-121). Returns (trainer, state, gen_fn)."""
    from xtts_tpu_torch.train.gan import GANTrainer, make_hifigan_generator_fn
    from xtts_tpu_torch.utils.registry import load_model
    dt = train_dtype(cfg)
    g = torch.Generator(device).manual_seed(cfg.train.seed)
    decoder = load_model("hifigan", cfg, dtype=dt, device=device, generator=g)
    disc = load_model("hifigan_discriminator", cfg, dtype=dt, device=device,
                      generator=g)
    gpt = _frozen("gpt", cfg, gpt_weights, device, g)
    dvae = _frozen("vqvae", cfg, dvae_weights, device, g)
    gen_fn = make_hifigan_generator_fn(decoder, gpt, dvae)
    trainer = GANTrainer(decoder, disc, gen_fn, g_lr=cfg.train.lr,
                         d_lr=cfg.train.lr, grad_clip=cfg.train.grad_clip)
    return trainer, trainer.init_state(), gen_fn


def _train_hifigan(args, cfg: XTTSConfig, tokenizer, logger, device):
    """The GAN loop: the HifiDecoder against MPD + MSD on code-aligned
    crops, latents from the frozen GPT and DVAE each step; checkpoints
    {g, d, g_opt, d_opt, step}; an eval wav every val_freq steps;
    <expdir>/hifigan.pth."""
    from xtts_tpu_torch.core.checkpoint import CheckpointManager
    from xtts_tpu_torch.core.logging import MetricLogger, StepTimer
    from xtts_tpu_torch.data.datasets import (HifiGANDataset, batch_iterator,
                                              collate_bucketed, read_filelist)
    from xtts_tpu_torch.dsp.mel import SPEAKER_ENCODER_MEL_CONFIG, MelFrontend
    from xtts_tpu_torch.train.gan import GANTrainer

    # the speaker encoder's 16 kHz 64-bin log-mel (hifigan_vocoder.py:
    # 671-678), the constant the inference API uses
    dataset = HifiGANDataset(read_filelist(args.filelist), tokenizer,
                             MelFrontend(cfg.mel, device),
                             MelFrontend(SPEAKER_ENCODER_MEL_CONFIG, device),
                             sample_rate=cfg.mel.sample_rate,
                             seed=cfg.train.seed)
    logger.info("hifigan dataset: %d samples", len(dataset))
    trainer, state, gen_fn = build_gan_trainer(
        cfg, args.gpt_weights, args.dvae_weights, device)
    ckpt = CheckpointManager(os.path.join(args.model_dir, "ckpt"),
                             keep=cfg.train.keep_ckpts)
    if args.resume and ckpt.latest_step() is not None:
        GANTrainer.load_payload(state, ckpt.restore(
            target=GANTrainer.payload(state)))
        logger.info("hifigan resumed at step %d", state.step)
    ml = MetricLogger(os.path.join(args.model_dir, "logs"), console_every=10)
    timer = StepTimer()
    collate = lambda ss: collate_bucketed(
        ss, {"text": 0, "refer_mel16": 0},
        {"text": (64, 128, 304), "refer_mel16": (100, 200, 300)})
    it = batch_iterator(dataset, cfg.train.batch_size, collate,
                        seed=cfg.train.seed,
                        prefetch=getattr(args, "prefetch", 0))
    for batch in it:
        if batch is None:
            continue
        batch.pop("text", None)
        batch.pop("text_length", None)
        batch = to_device(batch, device)
        state, metrics = trainer.step(state, batch)
        step = state.step
        dt = timer.tick()
        ml.scalars(step, {**metrics, "step_time": timer.mean,
                          **({"step_s": dt} if dt is not None else {})})
        if step % cfg.train.val_freq == 0:
            # the generator on the batch's first crop (the reference's
            # eval spot-check audio, train.py:213-247)
            with torch.no_grad():
                wav_hat = gen_fn({k: v[:1] for k, v in batch.items()})
            ml.audio(step, "eval/wav_gen", wav_hat[0].cpu().numpy(),
                     sample_rate=cfg.mel.sample_rate)
            ml.audio(step, "eval/wav_gt", batch["wav"][0].cpu().numpy(),
                     sample_rate=cfg.mel.sample_rate)
        if step % cfg.train.save_freq == 0:
            ckpt.save(step, GANTrainer.payload(state))
        if step >= cfg.train.train_steps:
            break
    ckpt.save(state.step, GANTrainer.payload(state), wait=True)
    export_weights(args.model_dir, "hifigan", trainer.generator, logger)
    ml.close()
    logger.info("hifigan done at step %d", state.step)
    return state


def train(args, cfg: XTTSConfig, tokenizer=None):
    """Train `args.model` as the parsed arguments say. tokenizer: any
    object with encode(str) -> list of ids and vocab_size, for the families
    that read text (None: a VoiceBpeTokenizer from --tokenizer). Returns
    the final TrainState (the hifigan family: its GANState)."""
    from xtts_tpu_torch.core.logging import MetricLogger, StepTimer, get_logger
    from xtts_tpu_torch.data.datasets import batch_iterator
    from xtts_tpu_torch.train.trainer import Trainer
    from xtts_tpu_torch.utils.registry import require_device

    device = require_device(getattr(args, "device", "cuda"),
                            "the training CLI")
    if args.steps is not None:
        cfg = cfg.replace(train=cfg.train.replace(train_steps=args.steps))
    os.makedirs(args.model_dir, exist_ok=True)
    logger = get_logger("xtts_tpu_torch.cli",
                        os.path.join(args.model_dir, "train.log"))
    if tokenizer is None and args.model in TEXT_FAMILIES:
        from xtts_tpu_torch.text.tokenizer import VoiceBpeTokenizer
        tokenizer = VoiceBpeTokenizer(args.tokenizer)
    if args.model == "hifigan":
        return _train_hifigan(args, cfg, tokenizer, logger, device)
    noise = getattr(args, "noise_filelist", None)
    dataset = build_dataset(args.model, cfg, args.filelist, tokenizer,
                            cfg.train.seed, device, noise)
    logger.info("dataset: %d samples", len(dataset))

    loss_fn, module, ctx = build_loss(args.model, cfg, args, device)
    trainer = Trainer(module, loss_fn, cfg.train, accum_steps=1,
                      checkpoint_dir=os.path.join(args.model_dir, "ckpt"))
    state = trainer.init_state()
    if args.resume:
        state = trainer.restore(state)
        logger.info("resumed at step %d", state.step)

    ml = MetricLogger(os.path.join(args.model_dir, "logs"), console_every=10)
    timer = StepTimer()
    collate = build_collate(args.model, cfg)
    it = batch_iterator(dataset, cfg.train.batch_size, collate,
                        seed=cfg.train.seed,
                        prefetch=getattr(args, "prefetch", 0))
    generator = torch.Generator(device).manual_seed(cfg.train.seed)

    val_batches, render_fn = [], None
    if args.val_filelist:
        render_fn = build_eval_render(args.model, cfg, args, ctx, device)
        val_ds = build_dataset(args.model, cfg, args.val_filelist, tokenizer,
                               cfg.train.seed + 1, device, noise)
        val_batches = [to_device(adapt_batch(args.model, b), device)
                       for b in batch_iterator(val_ds, cfg.train.batch_size,
                                               collate, shuffle=False,
                                               epochs=1)
                       if b is not None][:8]
        logger.info("eval: %d held-out batches", len(val_batches))

    for batch in it:
        batch = adapt_batch(args.model, batch)
        if batch is None:
            continue
        state, metrics = trainer.step(state, to_device(batch, device),
                                      generator)
        step = state.step
        dt = timer.tick()        # this step's wall time, the loader's included
        ml.scalars(step, {**metrics, "step_time": timer.mean,
                          **({"step_s": dt} if dt is not None else {})})
        if val_batches and step % cfg.train.val_freq == 0:
            with torch.no_grad():
                losses = [float(loss_fn(vb, torch.Generator(device)
                                        .manual_seed(0))[0])
                          for vb in val_batches]
            ml.scalars(step, {"loss": float(np.mean(losses))},
                       prefix="eval/")
            if render_fn is not None:
                render_fn(val_batches[0], ml, step)
        if step % cfg.train.save_freq == 0:
            trainer.save(state)
            logger.info("checkpoint @ %d", step)
        if step >= cfg.train.train_steps:
            break
    trainer.save(state, wait=True)
    trainer.wait()
    export_weights(args.model_dir, args.model, module, logger)
    ml.close()
    logger.info("done at step %d", state.step)
    return state


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("model", choices=FAMILIES)
    ap.add_argument("-c", "--config", default=None,
                    help="XTTSConfig JSON (defaults to the shipped config)")
    ap.add_argument("-m", "--model-dir", required=True,
                    help="experiment dir (checkpoints, logs, export)")
    ap.add_argument("--filelist", required=True,
                    help="6-field filelist; for classifier: the CLEAN "
                         "wav-path list")
    ap.add_argument("--noise-filelist", default=None,
                    help="classifier only: the noisy wav-path list")
    ap.add_argument("--val-filelist", default=None,
                    help="held-out filelist; eval loss every train.val_freq "
                         "steps (ttts/gpt/train_ms.py:162-186)")
    ap.add_argument("--tokenizer", default=None,
                    help="tokenizer.json for the families that read text")
    ap.add_argument("--dvae-weights", default=None,
                    help="gpt, diffusion, hifigan: the frozen DVAE (.pth "
                         "export or JAX .npz)")
    ap.add_argument("--gpt-weights", default=None,
                    help="diffusion, hifigan: the frozen GPT")
    ap.add_argument("--vocos-weights", default=None,
                    help="diffusion: render the eval mel to audio through "
                         "this vocoder (ttts/diffusion/train.py:226-233)")
    ap.add_argument("--timestep-sampler", default="uniform",
                    choices=("uniform", "loss_second_moment"),
                    help="diffusion: the training timestep sampler "
                         "(diffusion/resample.py)")
    ap.add_argument("--steps", type=int, default=None,
                    help="override train.train_steps")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="background-thread batch prefetch depth (0 = off)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv: Optional[list] = None, tokenizer=None):
    args = parser().parse_args(argv)
    cfg = XTTSConfig.from_json(args.config) if args.config else XTTSConfig()
    return train(args, cfg, tokenizer)


if __name__ == "__main__":
    main()
