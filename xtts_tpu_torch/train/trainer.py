"""Generic trainer (port of xtts_tpu/train/trainer.py).

One Trainer serves every family (the reference's five copy-pasted
trainers, ttts/{vqvae,gpt,diffusion,clvp,hifigan}/train_ms.py):

* a family supplies `loss_fn(batch, generator) -> (loss, aux)`, a closure
  over its model(s); aux may carry "new_state_cols", the model's buffers
  after this batch (the DVAE's EMA codebook), computed in the forward
  under the old ones and written after the backward pass, as JAX applies
  aux["new_state_cols"] after the gradient (xtts_tpu/train/trainer.py:
  122-126); a loss_fn's own `state_cols` (the diffusion timestep
  sampler's history) join the model's buffers in the state;
* the Trainer owns what optax.chain(clip_by_global_norm, adamw) computes,
  written out over the parameter list (ttts/gpt/train_ms.py:97-113,231):
  the global-norm clip scales by max_norm / norm only when norm >=
  max_norm; AdamW(b1 0.9, b2 0.999, eps 1e-8) decays every parameter,
  biases and norms included, with optax's bias correction and eps outside
  the square root; update n takes schedule(n), n counted from 0;
* accumulation over `accum` microbatches (the batch's leading axis): the
  gradients sum over them and divide once, and the state collections
  thread through them; EMA of the weights; checkpoints of the whole state.

Parameters stay f32; each family's modules compute in their own dtype.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from xtts_tpu_torch.core.config import TrainConfig
from xtts_tpu_torch.train.schedules import make_schedule

B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclass
class AdamWState:
    """optax ScaleByAdamState: the update count and the two moments."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclass
class TrainState:
    """params: the model's trainable parameters (its own tensors, updated
    in place); state_cols: its persistent buffers (its own tensors) and,
    under EMA, the "ema.<name>" copies; step: optimizer steps taken."""

    params: Dict[str, torch.Tensor]
    opt_state: AdamWState
    state_cols: Dict[str, torch.Tensor]
    step: int


LossFn = Callable[[Dict[str, torch.Tensor], Optional[torch.Generator]], Any]


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum over tensors of their sums of squares."""
    return torch.sqrt(sum((t * t).sum() for t in tensors))


@torch.no_grad()
def clip_adamw_(params: Dict[str, torch.Tensor], grads, opt: "AdamWState",
                lr: float, max_norm: float, weight_decay: float,
                b1: float = B1, b2: float = B2) -> torch.Tensor:
    """optax.chain(clip_by_global_norm(max_norm), adamw(lr, b1, b2, eps
    1e-8, weight_decay)) on `params` and the moments of `opt`, in place;
    `grads` lists the gradients in the order of `params`; opt.count
    advances. Returns the unclipped global norm."""
    names = list(params)
    mu = [opt.mu[n] for n in names]
    nu = [opt.nu[n] for n in names]
    params = [params[n] for n in names]
    gnorm = global_norm(grads)
    if not bool(gnorm < max_norm):           # optax: t / norm * max
        grads = torch._foreach_div(grads, gnorm)
        torch._foreach_mul_(grads, max_norm)
    # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
    torch._foreach_mul_(nu, b2)
    sq = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(sq, 1 - b2)
    torch._foreach_add_(nu, sq)
    opt.count += 1
    dev = params[0].device
    f32 = np.float32
    bc1 = torch.tensor(f32(1) - f32(b1) ** f32(opt.count), device=dev)
    bc2 = torch.tensor(f32(1) - f32(b2) ** f32(opt.count), device=dev)
    upd = torch._foreach_div(mu, bc1)
    den = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, EPS)
    torch._foreach_div_(upd, den)
    torch._foreach_add_(upd, torch._foreach_mul(params, weight_decay))
    torch._foreach_mul_(upd, -lr)
    torch._foreach_add_(params, upd)
    return gnorm


def _microbatch(batch, i: int):
    return {k: v[i] for k, v in batch.items()}


class Trainer:
    def __init__(self, model: torch.nn.Module, loss_fn: LossFn,
                 cfg: TrainConfig = TrainConfig(),
                 accum_steps: Optional[int] = None,
                 ema_decay: Optional[float] = None,
                 checkpoint_dir: Optional[str] = None):
        self.model = model
        self.loss_fn = loss_fn
        self.cfg = cfg
        self.accum = accum_steps if accum_steps is not None else cfg.accum_grad
        self.ema_decay = ema_decay
        self.schedule = make_schedule(cfg.lr_schedule, cfg.lr,
                                      cfg.warmup_steps, cfg.train_steps,
                                      cfg.min_lr_ratio)
        self._ckpt = None
        if checkpoint_dir is not None:
            from xtts_tpu_torch.core.checkpoint import CheckpointManager
            self._ckpt = CheckpointManager(checkpoint_dir,
                                           keep=cfg.keep_ckpts)

    # ------------------------------------------------------------------

    def init_state(self) -> TrainState:
        params = {n: p for n, p in self.model.named_parameters()
                  if p.requires_grad}
        keys = set(self.model.state_dict())
        cols = {n: b for n, b in self.model.named_buffers() if n in keys}
        cols.update(getattr(self.loss_fn, "state_cols", {}))
        if self.ema_decay is not None:
            from xtts_tpu_torch.train.ema import ema_init
            cols.update({"ema." + k: v for k, v in ema_init(params).items()})
        return TrainState(params, self.init_opt_state(params), cols, 0)

    @staticmethod
    def init_opt_state(params) -> AdamWState:
        def zeros():
            return {k: torch.zeros_like(p) for k, p in params.items()}
        return AdamWState(0, zeros(), zeros())

    # ------------------------------------------------------------------

    def _grads(self, state: TrainState, batch, generator):
        """Loss, aux and the gradients averaged over the microbatches."""
        names = list(state.params)
        for p in state.params.values():
            p.grad = None
        mbs = ([batch] if self.accum <= 1
               else [_microbatch(batch, i) for i in range(self.accum)])
        losses, auxes = [], []
        for mb in mbs:
            loss, aux = self.loss_fn(mb, generator)
            aux = dict(aux or {})
            new_cols = aux.pop("new_state_cols", None)
            loss.backward()
            if new_cols:
                with torch.no_grad():
                    for k, v in new_cols.items():
                        state.state_cols[k].copy_(v)
            losses.append(loss.detach())
            auxes.append({k: torch.as_tensor(v).detach()
                          for k, v in aux.items()})
        grads = [state.params[n].grad if state.params[n].grad is not None
                 else torch.zeros_like(state.params[n]) for n in names]
        for p in state.params.values():
            p.grad = None
        if len(mbs) == 1:
            return losses[0], auxes[0], grads
        grads = torch._foreach_div(grads, float(len(mbs)))
        loss = torch.stack(losses).sum() / len(mbs)
        aux = {k: torch.stack([a[k] for a in auxes]).mean()
               for k in auxes[0]}
        return loss, aux, grads

    def apply_gradients(self, state: TrainState, grads) -> torch.Tensor:
        """clip_by_global_norm then AdamW on the schedule, in place on
        state.params and state.opt_state. Returns the unclipped norm."""
        return clip_adamw_(state.params, grads, state.opt_state,
                           self.schedule(state.opt_state.count),
                           self.cfg.grad_clip, self.cfg.weight_decay)

    def step(self, state: TrainState, batch,
             generator: Optional[torch.Generator] = None):
        """One optimizer step over `accum` microbatches (the batch's leading
        axis when accum > 1). Updates `state` in place and returns (state,
        metrics): loss, grad_norm (before the clip), lr and the aux."""
        loss, aux, grads = self._grads(state, batch, generator)
        gnorm = self.apply_gradients(state, grads)
        if self.ema_decay is not None:
            from xtts_tpu_torch.train.ema import ema_update, ema_warmup_decay
            ema = {k[4:]: v for k, v in state.state_cols.items()
                   if k.startswith("ema.")}
            ema_update(ema, state.params,
                       ema_warmup_decay(state.step, self.ema_decay))
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr": self.schedule(state.step), **aux}
        state.step += 1
        return state, metrics

    # ------------------------------------------------------------------
    # checkpoints (the whole state: params, moments, collections, step)

    @staticmethod
    def payload(state: TrainState) -> Dict[str, Any]:
        return {"params": state.params,
                "opt_state": {"count": state.opt_state.count,
                              "mu": state.opt_state.mu,
                              "nu": state.opt_state.nu},
                "state_cols": state.state_cols, "step": state.step}

    def _require_ckpt(self):
        if self._ckpt is None:
            raise ValueError("Trainer built without checkpoint_dir")
        return self._ckpt

    def save(self, state: TrainState, wait: bool = False) -> bool:
        return self._require_ckpt().save(state.step, self.payload(state),
                                         wait=wait)

    def wait(self) -> None:
        if self._ckpt is not None:
            self._ckpt.wait()

    @torch.no_grad()
    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Exact resume: the checkpoint's parameters, moments, count,
        collections and step, copied into `state`'s own tensors."""
        out = self._require_ckpt().restore(step, target=self.payload(state))
        for group in ("params", "state_cols"):
            for k, v in getattr(state, group).items():
                v.copy_(out[group][k])
        for k in state.params:
            state.opt_state.mu[k].copy_(out["opt_state"]["mu"][k])
            state.opt_state.nu[k].copy_(out["opt_state"]["nu"][k])
        state.opt_state.count = int(out["opt_state"]["count"])
        state.step = int(out["step"])
        return state

    @torch.no_grad()
    def restore_pretrain(self, state: TrainState, step=None, include=(),
                         exclude=()) -> TrainState:
        """Weights-only, module-filtered restore for finetuning
        (ttts/utils/checkpoint.py:64-103): the filtered parameters are
        copied in; the optimizer state and the step restart."""
        from xtts_tpu_torch.core.checkpoint import filter_restore
        out = self._require_ckpt().restore(step)
        params = filter_restore(out["params"], state.params, include=include,
                                exclude=exclude)
        for k, v in state.params.items():
            v.copy_(params[k])
        state.opt_state = self.init_opt_state(state.params)
        state.step = 0
        return state
