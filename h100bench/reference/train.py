"""Plain reference of a training step: the published loss (per-class BCE
with a positive weight from a running positive fraction, model/main.py),
its gradient by autograd through `pesto.Model`, and Adam written out."""

import math

import torch
import torch.nn.functional as F

from . import pesto


def loss(logits: list, labels: list, pos_ratios: torch.Tensor, step: int, pos_weight_factor=0.5,
         keep=None):
    """(loss, new pos_ratios) of one batch: logits and labels [n_res_i, C]
    per structure; pos_ratios [C] before the step; step counts from 1.
    keep (a [n_res_i] bool per structure) takes only those residues."""
    if keep is not None:
        logits = [z[k] for z, k in zip(logits, keep)]
        labels = [y[k] for y, k in zip(labels, keep)]
    z, y = torch.cat(logits), torch.cat(labels)
    n_res = max(z.shape[0], 1)
    pos = pos_ratios + (y.sum(0) / n_res - pos_ratios) / (1.0 + math.sqrt(step))
    pw = pos_weight_factor * (1.0 - pos) / (pos + 1e-6)
    per = pw * y * F.softplus(-z) + (1.0 - y) * F.softplus(z)
    return ((pos / pos.sum()) * per / n_res).sum(), pos


class Adam:
    """Adam as published (Kingma and Ba, 2015): betas 0.9 / 0.999, eps 1e-8."""

    def __init__(self, params: dict, lr: float, betas=(0.9, 0.999), eps=1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict):
        self.t += 1
        b1, b2 = self.betas
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            mhat = self.m[k] / (1 - b1 ** self.t)
            vhat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(self.lr * mhat / (vhat.sqrt() + self.eps))


def steps(cfg: dict, weights: dict, batches: list, lr: float, device, kind="float32",
          pos_weight_factor=0.5, drop_half=False, dtype=torch.float32):
    """Train the reference from `weights` over `batches` (each a list of
    structures (X, ids, q, res, n_res, y)). Returns (losses per step, the
    first step's gradient norms by leaf, the weights' change norms by leaf
    after the last step). drop_half leaves every second residue out of each
    loss (a fault, for the check's own readings); dtype float64 makes the
    witness of a float32 run."""
    dev = torch.device(device)
    model = pesto.Model(cfg).to(dev, dtype)
    model.load_state_dict(weights)
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = Adam(params, lr)
    pos = torch.full((cfg["dm_n2"],), 0.5, device=dev, dtype=dtype)
    losses, grad_norms = [], None
    with pesto.precision(kind):
        for t, batch in enumerate(batches, 1):
            zs = [pesto.logits_of(model, X, ids, q, res, n_res, dev, checkpoint=True)
                  for X, ids, q, res, n_res, _ in batch]
            ys = [torch.as_tensor(s[5]).to(dev, dtype) for s in batch]
            keep = [torch.arange(len(y), device=dev) % 2 == 0 for y in ys] if drop_half else None
            total, pos = loss(zs, ys, pos, t, pos_weight_factor, keep)
            grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
            if grad_norms is None:
                grad_norms = {k: float(g.double().norm()) for k, g in grads.items()}
            losses.append(float(total.detach()))
            pos = pos.detach()
            opt.step(grads)
    change = {k: float((p.detach() - start[k]).double().norm()) for k, p in params.items()}
    return losses, grad_norms, change
