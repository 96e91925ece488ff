"""Training CLI — `python -m xtts_tpu_torch.train.cli <model> -c cfg.json -m
expdir --filelist train.txt` (port of xtts_tpu/train/cli.py for the first
two stages of the reference recipe, ttts/train_step.py:1-6):

  python -m xtts_tpu_torch.train.cli vqvae -c cfg.json -m exp/vqvae \\
      --filelist train.txt
  python -m xtts_tpu_torch.train.cli gpt -c cfg.json -m exp/gpt \\
      --filelist train.txt --tokenizer tokenizer.json \\
      --dvae-weights exp/vqvae/vqvae.pth

Each family reads a bucketed dataset (data/datasets.py), trains with the
generic Trainer (clip, AdamW, schedule), keeps rotated checkpoints of the
whole state under <expdir>/ckpt (--resume continues exactly), logs JSONL
(and TensorBoard where it imports) under <expdir>/logs, evaluates on
--val-filelist every train.val_freq steps, and exports <expdir>/<family>.pth:
a state dict under the reference's names, the DVAE's codebook buffers
included, which --dvae-weights and TextToSpeech.from_pretrained read.
Training runs on the card unless --device cpu is given. The diffusion,
clvp, classifier and hifigan families are not ported yet and are refused.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from xtts_tpu_torch.core.config import XTTSConfig

FAMILIES = ("vqvae", "gpt", "diffusion", "clvp", "hifigan", "classifier")
PORTED = ("vqvae", "gpt")
# the ROADMAP queue 1 items that bring the families not ported yet
_LATER = {"diffusion": "queue 1 item 2, the diffusion trainer",
          "clvp": "queue 1 item 3, the CLVP loss and the classifier",
          "classifier": "queue 1 item 3, the CLVP loss and the classifier",
          "hifigan": "queue 1 item 4, the GAN trainer"}


def refuse(model: str) -> None:
    if model not in PORTED:
        raise NotImplementedError(
            f"the {model} trainer is not ported yet (ROADMAP "
            f"{_LATER.get(model, 'queue 1')}); ported: {PORTED}")


def build_dataset(model: str, cfg: XTTSConfig, filelist: str, tokenizer,
                  seed: int, device="cuda"):
    """The family's dataset over a 6-field filelist; mels from the
    `.mel.npy` beside each wav, else the MelFrontend on `device`."""
    from xtts_tpu_torch.data.datasets import (GptTTSDataset, MelCache,
                                              VQVAEMelDataset, read_filelist)
    from xtts_tpu_torch.dsp.mel import MelFrontend
    refuse(model)
    mel_cache = MelCache(MelFrontend(cfg.mel, device), cfg.mel.sample_rate)
    entries = read_filelist(filelist)
    if model == "vqvae":
        return VQVAEMelDataset(entries, mel_cache, seed=seed)
    # token ids at or past start_text_token would collide with the
    # reserved specials (the shipped vocab 255 / number_text_tokens 256)
    cap = cfg.gpt.start_text_token
    vocab = tokenizer.vocab_size
    vocab = vocab() if callable(vocab) else vocab
    if vocab > cap:
        raise ValueError(
            f"tokenizer vocab {vocab} exceeds the GPT id range "
            f"(start_text_token) {cap}: ids past it would index the text "
            f"embedding out of range or collide with reserved specials. "
            f"Retrain the tokenizer smaller or raise the config.")
    # the reference's reject limits (text > 300, mel > 2000,
    # ttts/gpt/dataset.py:72-74), never past the position tables
    return GptTTSDataset(entries, mel_cache, tokenizer,
                         max_text=min(300, cfg.gpt.max_text_tokens),
                         max_mel=min(2000, 4 * cfg.gpt.max_mel_tokens),
                         mel_hop=cfg.mel.hop_length, seed=seed)


def build_collate(model: str, cfg: Optional[XTTSConfig] = None):
    from xtts_tpu_torch.data.datasets import (MEL_BUCKETS, TEXT_BUCKETS,
                                              collate_bucketed)
    refuse(model)

    def clamp(buckets, cap):
        """A bucket ladder that never pads past the model's capacity `cap`
        (a rung above a position table would index it out of range)."""
        if cap is None:
            return buckets
        return tuple(b for b in buckets if b < cap) + (cap,)

    t_cap = cfg.gpt.max_text_tokens if cfg else None
    m_cap = 4 * cfg.gpt.max_mel_tokens if cfg else None
    pads = {
        "vqvae": ({}, {}),
        "gpt": ({"text": 0, "mel": 1, "cond_mel": 1},
                {"text": clamp(TEXT_BUCKETS, t_cap),
                 "mel": clamp(MEL_BUCKETS, m_cap), "cond_mel": MEL_BUCKETS}),
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
    stay f32). Frozen models (the GPT trainer's DVAE) stay f32: the
    reference runs them under no_grad outside autocast
    (ttts/gpt/train_ms.py:216-218), and the VQ argmin feeds targets."""
    table = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    if cfg.train.dtype not in table:
        raise ValueError(f"TrainConfig.dtype={cfg.train.dtype!r}: "
                         f"use one of {sorted(table)}")
    return table[cfg.train.dtype]


def build_loss(model: str, cfg: XTTSConfig, args, device="cuda"):
    """Returns (loss_fn, the trained module, ctx); ctx holds the modules the
    eval render reuses."""
    from xtts_tpu_torch.utils.registry import load_model
    refuse(model)
    dt = train_dtype(cfg)
    g = torch.Generator(device).manual_seed(0)
    if model == "vqvae":
        from xtts_tpu_torch.train.steps import make_dvae_loss
        m = load_model("vqvae", cfg, dtype=dt, device=device, generator=g)
        return make_dvae_loss(m, ema_decay=cfg.vqvae.ema_decay), m, {"dvae": m}
    from xtts_tpu_torch.train.steps import make_gpt_loss
    if cfg.train.remat != "none":
        cfg = cfg.replace(gpt=cfg.gpt.replace(remat=cfg.train.remat))
    gpt = load_model("gpt", cfg, dtype=dt, device=device, generator=g)
    dvae = load_model("vqvae", cfg, weights_path=args.dvae_weights,
                      device=device, generator=g).eval()
    dvae.requires_grad_(False)
    return (make_gpt_loss(gpt, dvae, cfg.train.text_weight,
                          cfg.train.mel_weight), gpt, {"dvae": dvae})


def build_eval_render(model: str, cfg: XTTSConfig, args, ctx):
    """The family's held-out render for the eval loop (the reference's
    TensorBoard recon mels, ttts/vqvae/inference.py:31-115): the vqvae
    family's codes of the first eval mel decoded back. Returns
    render(batch, ml, step) or None."""
    if model != "vqvae":
        return None
    dvae = ctx["dvae"]

    @torch.no_grad()
    def render_vqvae(batch, ml, step):
        mel = batch["mel"][:1]
        recon, _ = dvae.decode(dvae.get_codebook_indices(mel))
        ml.image_mel(step, "eval/mel_gt", mel[0].float().cpu().numpy())
        ml.image_mel(step, "eval/mel_recon", recon[0].float().cpu().numpy())

    return render_vqvae


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


def train(args, cfg: XTTSConfig, tokenizer=None):
    """Train `args.model` as the parsed arguments say. tokenizer: any
    object with encode(str) -> list of ids and vocab_size, for the families
    that read text (None: a VoiceBpeTokenizer from --tokenizer). Returns
    the final TrainState."""
    from xtts_tpu_torch.core.logging import MetricLogger, StepTimer, get_logger
    from xtts_tpu_torch.data.datasets import batch_iterator
    from xtts_tpu_torch.train.trainer import Trainer
    from xtts_tpu_torch.utils.registry import require_device

    refuse(args.model)
    device = require_device(getattr(args, "device", "cuda"),
                            "the training CLI")
    if args.steps is not None:
        cfg = cfg.replace(train=cfg.train.replace(train_steps=args.steps))
    os.makedirs(args.model_dir, exist_ok=True)
    logger = get_logger("xtts_tpu_torch.cli",
                        os.path.join(args.model_dir, "train.log"))
    if tokenizer is None and args.model == "gpt":
        from xtts_tpu_torch.text.tokenizer import VoiceBpeTokenizer
        tokenizer = VoiceBpeTokenizer(args.tokenizer)
    dataset = build_dataset(args.model, cfg, args.filelist, tokenizer,
                            cfg.train.seed, device)
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
        render_fn = build_eval_render(args.model, cfg, args, ctx)
        val_ds = build_dataset(args.model, cfg, args.val_filelist, tokenizer,
                               cfg.train.seed + 1, device)
        val_batches = [to_device(adapt_batch(args.model, b), device)
                       for b in batch_iterator(val_ds, cfg.train.batch_size,
                                               collate, shuffle=False,
                                               epochs=1)][:8]
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
    ap.add_argument("--filelist", required=True, help="6-field filelist")
    ap.add_argument("--val-filelist", default=None,
                    help="held-out filelist; eval loss every train.val_freq "
                         "steps (ttts/gpt/train_ms.py:162-186)")
    ap.add_argument("--tokenizer", default=None,
                    help="tokenizer.json for the families that read text")
    ap.add_argument("--dvae-weights", default=None,
                    help="gpt: the frozen DVAE (.pth export or JAX .npz)")
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
