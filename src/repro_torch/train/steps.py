"""The train step: micro-batch gradient accumulation, remat, mixed
precision and AdamW, the reference's ``train/steps.py`` in PyTorch.

A state is ``{"model", "params", "opt", "step"}``: the family's
:class:`~repro_torch.models.common.Model` (its parameters require grad),
its parameters in the reference's tree (:func:`~repro_torch.models.common.param_tree`,
the tensors themselves), the AdamW moments of that tree and the 0-d int32
step count.  The step runs eagerly and updates the state in place."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import get_family, lm_loss, param_tree
from repro_torch.nn.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.tree import leaves, unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    accum_steps: int = 1
    opt: adamw.AdamWConfig = dataclasses.field(default_factory=adamw.AdamWConfig)


def init_state(cfg: ModelConfig, model):
    """The train state of ``model``, whose parameters are switched to
    require grad (``Model.requires_grad_``): f32 moments of zeros and step
    0, on the parameters' device."""
    model.requires_grad_(True)
    params = param_tree(model)
    dev = leaves(params)[0].device
    return {"model": model, "params": params, "opt": adamw.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _microbatch(batch: dict, i: int, accum: int) -> dict:
    """Micro-batch i: rows ``[i * mb, (i + 1) * mb)`` of every entry."""
    def f(x):
        mb = x.shape[0] // accum
        return x[i * mb:(i + 1) * mb]
    return {k: f(v) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """-> ``train_step(state, batch)`` -> metrics ``{"loss", "grad_norm",
    "lr"}`` (0-d tensors on the device; nothing syncs the host).  The batch
    holds ``tokens`` and ``labels`` (B, S) and, for the enc-dec and VLM
    families, ``media``; with ``accum_steps`` > 1 it is cut into that many
    micro-batches on the leading dim, their gradients summed in the f32
    parameters' ``.grad`` and divided by ``accum_steps``, and the loss
    averaged, as the reference's scan does."""
    fam = get_family(cfg)

    def loss_fn(model, batch):
        # under grad the layers read every parameter cast to cfg.cdtype()
        # inside the graph (Params.grad_dtype), the reference's cast of
        # the parameter tree before the forward
        logits = fam.forward(model, cfg, batch["tokens"],
                             media=batch.get("media"))
        return lm_loss(logits, batch["labels"])

    def train_step(state, batch):
        model, params = state["model"], leaves(state["params"])
        for p in params:
            p.grad = None
        n = tcfg.accum_steps
        loss = 0.0
        for i in range(n):
            mb = batch if n == 1 else _microbatch(batch, i, n)
            l = loss_fn(model, mb)
            l.backward()
            loss = loss + l.detach()
        grads = [p.grad if n == 1 else p.grad / n for p in params]
        if n > 1:
            loss = loss / n
        metrics = adamw.update(tcfg.opt, state["params"],
                               unflatten(state["params"], grads),
                               state["opt"], state["step"])
        for p in params:
            p.grad = None
        model.drop_casts()
        state["step"] += 1
        return {"loss": loss, **metrics}

    return train_step
