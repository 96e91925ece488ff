"""Per-family loss functions for the Trainer (port of
xtts_tpu/train/steps.py).

* DVAE: smooth_l1 + 0.5 SSIM + 0.25 commitment, and the EMA codebook
  update computed from the batch under the old codebook
  (ttts/vqvae/train_ms.py:163-166, ttts/gpt/config.json "vqvae");
* GPT: 0.01 text CE + 1.0 mel CE over the codes of a frozen f32 DVAE
  (ttts/gpt/train_ms.py:216-222);
* diffusion: MSE(eps) + vb on the tacotron-normalised mel, the hint the
  frozen GPT's latents with their padding zeroed, 10% of the rows
  unconditioned, PatchDropout in the CLIP encoder
  (ttts/diffusion/train_ms.py:276-325, aa_model.py:320-328).

Each returns `loss_fn(batch, generator) -> (loss, aux)`. The nearest-code
search of each is K3 on the card: the DVAE's own quantizer, and the frozen
DVAE that turns target mels into the GPT's targets and the diffusion
model's hint.

Built with `mesh=` (parallel/mesh.py), a loss_fn takes this data rank's
rows and returns its share of the global batch's loss and metrics (the
Trainer sums them over the data group): means over rows are divided by
the data ranks, the GPT's cross-entropies divide by the global count of
valid targets, the DVAE's EMA statistics are summed over the data group
before the update (xtts_dvae.py:108-110), and the diffusion draws are made
for the global batch on every rank, each taking its rows.
"""
from __future__ import annotations

from typing import Optional

import torch

from xtts_tpu_torch.diffusion.gaussian import GaussianDiffusion
from xtts_tpu_torch.models.aa_diffusion import (AADiffusion,
                                                normalize_tacotron_mel)
from xtts_tpu_torch.models.dvae import (DVAE, BalanceState, balance_codebook,
                                        ema_codebook_update)
from xtts_tpu_torch.models.gpt import UnifiedVoice
from xtts_tpu_torch.parallel import mesh as pmesh


def make_dvae_loss(model: DVAE, commitment_weight: float = 0.25,
                   ema_decay: float = 0.99, mesh=None):
    """batch: {'mel': (B, bins, T)}. aux["new_state_cols"] holds the
    codebook buffers after the EMA update (and the balancing heuristic
    where the config turns it on), which the Trainer writes after the
    backward pass."""

    def loss_fn(batch, generator: Optional[torch.Generator] = None):
        recon, ssim_l, commit, _, (osum, esum) = model(batch["mel"])
        loss = recon + ssim_l + commitment_weight * commit
        osum = pmesh.data_total(osum, mesh)
        esum = pmesh.data_total(esum, mesh)
        new_cb = ema_codebook_update(model.codebook_state(), osum, esum,
                                     decay=ema_decay, eps=model.cfg.ema_eps)
        cb = model.codebook
        if hasattr(cb, "bal_hist"):
            # balancing heuristic (xtts_dvae.py:53-85)
            new_cb, bal, _ = balance_codebook(
                new_cb, BalanceState(cb.bal_hist, cb.bal_total), osum,
                generator, window=model.cfg.balance_window)
        new_cols = {"codebook.embed": new_cb.embed,
                    "codebook.cluster_size": new_cb.cluster_size,
                    "codebook.embed_avg": new_cb.embed_avg}
        if hasattr(cb, "bal_hist"):
            new_cols.update({"codebook.bal_hist": bal.hist,
                             "codebook.bal_total": bal.total})
        share = lambda x: pmesh.mean_share(x, mesh)      # noqa: E731
        aux = {"recon": share(recon.detach()), "ssim": share(ssim_l.detach()),
               "commitment": share(commit.detach()),
               "new_state_cols": new_cols}
        return share(loss), aux

    loss_fn.mesh = mesh
    return loss_fn


def make_gpt_loss(gpt: UnifiedVoice, dvae: DVAE, text_weight: float = 0.01,
                  mel_weight: float = 1.0, mesh=None):
    """batch: {'cond_mel', 'text', 'text_lengths', 'mel', 'wav_lengths'};
    the mel codes come from the frozen DVAE under no_grad, online, as
    ttts/gpt/train_ms.py:216-217 does."""

    def loss_fn(batch, generator: Optional[torch.Generator] = None):
        codes = dvae.get_codebook_indices(batch["mel"])
        total = (None if mesh is None
                 else lambda c: pmesh.data_total(c, mesh))
        loss_text, loss_mel = gpt(batch["cond_mel"], batch["text"],
                                  batch["text_lengths"], codes,
                                  batch["wav_lengths"], count_total=total)
        loss = text_weight * loss_text + mel_weight * loss_mel
        return loss, {"loss_text": loss_text.detach(),
                      "loss_mel": loss_mel.detach()}

    loss_fn.mesh = mesh
    return loss_fn


def diffusion_latent_fn(gpt: UnifiedVoice, dvae: DVAE):
    """The frozen half of the diffusion step: mel -> the frozen DVAE's
    codes (K3) -> the frozen GPT's teacher-forced latents (B, D, N), zero
    past ceil(wav_len / mel_length_compression) + 1 codes
    (ttts/diffusion/train_ms.py:311-319). Under no_grad, in the frozen
    models' own dtype (f32 in the CLI: the reference runs them outside
    autocast)."""

    @torch.no_grad()
    def latent_of(batch) -> torch.Tensor:
        codes = dvae.get_codebook_indices(batch["mel"])
        latent = gpt(batch["refer_mel"], batch["text"],
                     batch["text_lengths"], codes, batch["wav_lengths"],
                     return_latent=True).transpose(1, 2)
        n = latent.shape[-1]
        code_lens = torch.ceil(batch["wav_lengths"]
                               / gpt.cfg.mel_length_compression).long() + 1
        mask = (torch.arange(n, device=latent.device)[None, :]
                < code_lens[:, None])
        return latent * mask[:, None, :]

    return latent_of


def diffusion_draws(diff: AADiffusion, gd: GaussianDiffusion, x_start,
                    refer, generator: Optional[torch.Generator],
                    unconditioned_percentage: float, sampler=None,
                    sampler_state=None, mesh=None):
    """The step's random draws, on the generator's device and moved to the
    batch's: t and its loss weights (`sampler`, else uniform), the noise,
    the unconditioned rows and the PatchDropout ranking. On a mesh they
    are drawn for the global batch and this rank's rows kept ("t_global":
    every row's t, which the timestep sampler's history takes)."""
    from xtts_tpu_torch.diffusion.resample import UniformSampler
    n_data = 1 if mesh is None else mesh.n_data
    b, dev = x_start.shape[0] * n_data, x_start.device
    x_shape = (b,) + tuple(x_start.shape[1:])
    gdev = generator.device if generator is not None else dev
    if sampler is None:
        t, w = UniformSampler(gd.num_timesteps).sample(generator, b, gdev)
    else:
        t, w = sampler.sample(generator, b, sampler_state)
    uncond = torch.rand((b,), generator=generator, device=gdev) \
        < unconditioned_percentage
    noise = torch.randn(x_shape, generator=generator, device=gdev)
    n = diff.refer_enc.num_patches(refer.shape[-1])
    patch_rand = torch.randn((b, n), generator=generator, device=gdev)
    rows = pmesh.data_rows(mesh, b)
    out = {k: v[rows].to(dev) for k, v in dict(
        t=t, w=w, uncond=uncond, noise=noise, patch_rand=patch_rand).items()}
    out["t_global"] = t.to(dev)
    return out


def make_diffusion_loss(diff: AADiffusion, gd: GaussianDiffusion,
                        gpt: UnifiedVoice, dvae: DVAE,
                        unconditioned_percentage: float = 0.1,
                        timestep_sampler: str = "uniform", mesh=None):
    """batch: {'mel', 'refer_mel', 'text', 'text_lengths', 'wav_lengths'}.
    Each step recomputes the frozen codes and latents
    (diffusion_latent_fn), then takes the diffusion loss on the
    tacotron-normalised mel with the model in training mode (the
    unconditioned rows' hint replaced, PatchDropout on).

    timestep_sampler: 'uniform' or 'loss_second_moment' (importance
    sampling over the loss history, diffusion/resample.py); the latter's
    state is `loss_fn.state_cols`, which the Trainer keeps in its state
    columns and which aux["new_state_cols"] updates after each step.

    loss_fn(batch, generator, draws=None): `draws` fixes the step's draws
    (diffusion_draws' keys), as the parity checks do. On a mesh the
    sampler's history takes every rank's rows' losses."""
    sampler, cols = None, {}
    if timestep_sampler == "loss_second_moment":
        from xtts_tpu_torch.diffusion.resample import (
            LossAwareState, LossSecondMomentResampler)
        sampler = LossSecondMomentResampler(gd.num_timesteps)
        dev = next(diff.parameters()).device
        st = sampler.init_state(dev)
        cols = {"t_sampler.history": st.history,
                "t_sampler.counts": st.counts}
    elif timestep_sampler != "uniform":
        raise ValueError(f"timestep_sampler {timestep_sampler!r}: 'uniform' "
                         f"or 'loss_second_moment'")
    latent_of = diffusion_latent_fn(gpt, dvae)

    def loss_fn(batch, generator: Optional[torch.Generator] = None,
                draws=None):
        latent = latent_of(batch)
        x_start = normalize_tacotron_mel(batch["mel"])
        refer = normalize_tacotron_mel(batch["refer_mel"])
        state = (LossAwareState(cols["t_sampler.history"],
                                cols["t_sampler.counts"])
                 if sampler is not None else None)
        if draws is None:
            draws = diffusion_draws(diff, gd, x_start, refer, generator,
                                    unconditioned_percentage, sampler, state,
                                    mesh)

        def model_fn(x_t, t_orig):
            return diff(x_t, t_orig, latent, refer,
                        uncond_mask=draws["uncond"], train=True,
                        patch_rand=draws["patch_rand"])

        terms = gd.training_losses(model_fn, x_start, draws["t"],
                                   draws["noise"])
        share = lambda x: pmesh.mean_share(x.mean(), mesh)  # noqa: E731
        loss = share(terms["loss"] * draws["w"])
        aux = {"mse": share(terms["mse"]).detach(),
               "vb": share(terms["vb"]).detach()}
        if sampler is not None:
            t_all = draws.get("t_global", draws["t"])
            new = sampler.update(state, t_all, pmesh.gather_rows(
                terms["loss"].detach(), mesh))
            aux["new_state_cols"] = {"t_sampler.history": new.history,
                                     "t_sampler.counts": new.counts}
        return loss, aux

    loss_fn.state_cols = cols
    loss_fn.mesh = mesh
    return loss_fn
