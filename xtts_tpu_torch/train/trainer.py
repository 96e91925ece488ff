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
  thread through them; EMA of the weights; checkpoints of the whole state;
* data and tensor parallelism over a parallel.mesh.Mesh (`mesh`,
  `param_rules`; xtts_tpu/train/trainer.py:62,172-212): shard_batch gives
  each data rank its rows, the loss_fn (built with the same mesh) returns
  the rank's share of the global batch's loss, the gradients and metrics
  are summed over the data group, the clip's norm sums the sharded
  parameters' squares over the model group, rank 0 writes the whole state
  and every rank restores its shard. One step equals the single-device
  step on the global batch.

Parameters stay f32; each family's modules compute in their own dtype.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from xtts_tpu_torch.core.config import TrainConfig
from xtts_tpu_torch.parallel import mesh as pmesh
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


def sharded_global_norm(names, grads, specs, mesh) -> torch.Tensor:
    """The global norm of a parameter set held across a mesh: replicated
    gradients once, the sharded ones' squares summed over the model
    group."""
    sq = [(g * g).sum() for n, g in zip(names, grads) if n not in specs]
    shq = [(g * g).sum() for n, g in zip(names, grads) if n in specs]
    total = sum(sq) if sq else torch.zeros((), device=grads[0].device)
    if shq:
        total = total + pmesh.all_reduce(sum(shq), mesh.model_group)
    return torch.sqrt(total)


@torch.no_grad()
def clip_adamw_(params: Dict[str, torch.Tensor], grads, opt: "AdamWState",
                lr: float, max_norm: float, weight_decay: float,
                b1: float = B1, b2: float = B2,
                gnorm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """optax.chain(clip_by_global_norm(max_norm), adamw(lr, b1, b2, eps
    1e-8, weight_decay)) on `params` and the moments of `opt`, in place;
    `grads` lists the gradients in the order of `params`; opt.count
    advances. gnorm: the global norm where the parameters are sharded
    (sharded_global_norm). Returns the unclipped global norm."""
    names = list(params)
    mu = [opt.mu[n] for n in names]
    nu = [opt.nu[n] for n in names]
    params = [params[n] for n in names]
    if gnorm is None:
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
                 mesh: Optional[pmesh.Mesh] = None, param_rules=(),
                 accum_steps: Optional[int] = None,
                 ema_decay: Optional[float] = None,
                 checkpoint_dir: Optional[str] = None):
        """mesh: a parallel.mesh.Mesh, with loss_fn built for it (the loss
        factories' `mesh=`); param_rules: the tensor-parallel rules that
        shard_state applies (parallel.mesh.GPT_PARAM_RULES)."""
        if mesh is not None and getattr(loss_fn, "mesh", None) is not mesh:
            raise ValueError("a Trainer on a mesh needs a loss_fn built for "
                             "that mesh (its factory's mesh=)")
        self.model = model
        self.loss_fn = loss_fn
        self.cfg = cfg
        self.mesh = mesh
        self.param_rules = list(param_rules)
        self.specs: Dict[str, pmesh.ShardSpec] = {}
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

    def shard_state(self, state: TrainState) -> TrainState:
        """Cut the parameters to this rank's shards by the partition rules
        (replicated by default) and re-derive the moments from them, as
        JAX's shard_state does; the EMA copies ("ema.<name>") take their
        parameter's shard, and the other collections stay replicated."""
        if self.mesh is None:
            return state
        self.specs = pmesh.shard_params(self.model, self.mesh,
                                        self.param_rules)
        state.opt_state = self.init_opt_state(state.params)
        for k in list(state.state_cols):
            state.state_cols[k] = self._shard_of(k, state.state_cols[k])
        return state

    def shard_batch(self, batch):
        """This data rank's rows of the global batch (axis 1 under
        accumulation, whose microbatches lead)."""
        return pmesh.shard_batch(batch, self.mesh,
                                 axis=1 if self.accum > 1 else 0)

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
        gnorm = None
        if self.mesh is not None:
            gnorm = sharded_global_norm(list(state.params), grads,
                                        self.specs, self.mesh)
        return clip_adamw_(state.params, grads, state.opt_state,
                           self.schedule(state.opt_state.count),
                           self.cfg.grad_clip, self.cfg.weight_decay,
                           gnorm=gnorm)

    def _reduce(self, loss, aux, grads):
        """Shares summed over the data group: the gradients, the loss and
        the metrics of the global batch."""
        grads = pmesh.all_reduce_flat(grads, self.mesh.data_group)
        keys = sorted(aux)
        vals = pmesh.all_reduce_flat(
            [loss.float().reshape(1)]
            + [aux[k].float().reshape(1) for k in keys],
            self.mesh.data_group)
        return vals[0][0], {k: v[0] for k, v in zip(keys, vals[1:])}, grads

    def step(self, state: TrainState, batch,
             generator: Optional[torch.Generator] = None):
        """One optimizer step over `accum` microbatches (the batch's leading
        axis when accum > 1; on a mesh, this rank's rows: shard_batch).
        Updates `state` in place and returns (state, metrics): loss,
        grad_norm (before the clip), lr and the aux, of the global batch."""
        loss, aux, grads = self._grads(state, batch, generator)
        if self.mesh is not None:
            loss, aux, grads = self._reduce(loss, aux, grads)
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

    def full_payload(self, state: TrainState) -> Dict[str, Any]:
        """The payload with every sharded parameter and moment gathered
        whole (every rank of the model group takes part)."""
        out = self.payload(state)
        if not self.specs:
            return out

        def whole(d):
            out = {}
            for k, v in d.items():
                spec = self._spec(k)
                out[k] = (v if spec is None else pmesh.gather_shard(
                    v, spec.dim, spec.groups, self.mesh))
            return out
        out["params"] = whole(out["params"])
        out["state_cols"] = whole(out["state_cols"])
        out["opt_state"] = dict(out["opt_state"],
                                mu=whole(out["opt_state"]["mu"]),
                                nu=whole(out["opt_state"]["nu"]))
        return out

    def save(self, state: TrainState, wait: bool = False) -> bool:
        """Every rank calls it; rank 0 writes the whole state (the shards
        gathered), so any world size restores it. False where the step is
        already saved, and on the other ranks, which write nothing."""
        payload = self.full_payload(state)
        wrote = False
        if self.mesh is None or self.mesh.rank == 0:
            wrote = self._require_ckpt().save(state.step, payload, wait=wait)
        if (self.mesh is not None and wait
                and torch.distributed.is_initialized()):
            torch.distributed.barrier()
        return wrote

    def wait(self) -> None:
        if self._ckpt is not None:
            self._ckpt.wait()

    def _spec(self, name: str) -> Optional[pmesh.ShardSpec]:
        """A parameter's spec; an EMA copy shares its parameter's."""
        return self.specs.get(name[4:] if name.startswith("ema.") else name)

    def _shard_of(self, name: str, full: torch.Tensor) -> torch.Tensor:
        spec = self._spec(name)
        if spec is None:
            return full
        return pmesh.take_shard(full, spec.dim, spec.groups,
                                self.mesh.n_model, self.mesh.model_index)

    def _load(self, dst: torch.Tensor, name: str, full: torch.Tensor):
        src = self._shard_of(name, full)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"checkpoint {name}: shape {tuple(src.shape)} "
                             f"!= {tuple(dst.shape)}")
        dst.copy_(src)

    @torch.no_grad()
    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Exact resume: the checkpoint's parameters, moments, count,
        collections and step, copied into `state`'s own tensors; on a mesh
        each rank takes its shard of the whole tensors written."""
        out = self._require_ckpt().restore(step)
        for group in ("params", "state_cols"):
            for k, v in getattr(state, group).items():
                if k not in out[group]:
                    raise KeyError(f"checkpoint lacks {group} {k}")
                self._load(v, k, out[group][k])
        for k in state.params:
            self._load(state.opt_state.mu[k], k, out["opt_state"]["mu"][k])
            self._load(state.opt_state.nu[k], k, out["opt_state"]["nu"][k])
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
        params = filter_restore({k: self._shard_of(k, v)
                                 for k, v in out["params"].items()},
                                state.params, include=include,
                                exclude=exclude)
        for k, v in state.params.items():
            v.copy_(params[k])
        state.opt_state = self.init_opt_state(state.params)
        state.step = 0
        return state
