"""Training driver: train a zoo model on synthetic LM batches (port of
``repro.launch.train``, without its mesh: lane sharding is a later
slice, so one card holds the whole model).

Each step draws a batch from ``lm_batches``, runs ``train_loss`` through
the zoo's teacher-forced forward (attention, MoE and SSD on the port's
kernels on the card, each differentiated through its plain twin),
``loss.backward()``, and one ``adamw`` step (the reference's defaults:
b2 0.95, weight decay 0.1, clip 1.0); the parameters are drawn from a
``torch.Generator`` seeded by ``seed`` on the training device.  A CROSS
model trains over zero frames or image embeddings, as in the reference.

Usage (the card by default; ``--device cpu`` runs on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --smoke --steps 50 --batch 8 --seq 256 --lr 1e-3 --ckpt build/ckpt \\
      --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import lm_batches
from repro_torch.device import resolve_device, sync
from repro_torch.models import transformer as tf_model
from repro_torch.optim import adamw
from repro_torch.tree import tree_map


def model_config(arch: str, smoke: bool = True,
                 layers: Optional[int] = None):
    """The smoke or published config of ``arch``; ``layers`` cuts its
    depth (a whole number of periods; widths never change)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if layers is None:
        return cfg
    if layers < 1 or layers % len(cfg.period):
        raise ValueError(f"layers must be a positive multiple of the "
                         f"period ({len(cfg.period)}), got {layers}")
    return dataclasses.replace(cfg, n_layers=layers)


def memory_stub(cfg, batch: int, seq: int, device):
    """The zero memory a CROSS model trains over: ``seq`` frames for an
    encoder-decoder, ``n_image_tokens`` image embeddings for the vision
    stub (the reference's sanctioned stubs); {} otherwise."""
    out = {}
    if cfg.encoder is not None:
        out["frames"] = torch.zeros((batch, seq, cfg.d_model),
                                    dtype=cfg.torch_dtype, device=device)
    if cfg.vision_stub:
        out["image_embeds"] = torch.zeros(
            (batch, cfg.n_image_tokens, cfg.d_model), dtype=cfg.torch_dtype,
            device=device)
    return out


def loss_and_grads(params, batch, cfg, remat: bool):
    """One teacher-forced step's (loss, metrics, grads): the loss and
    metrics detached, ``grads`` the parameter tree's ``.grad`` after
    ``loss.backward()`` (None where a leaf got no gradient)."""
    params = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = tf_model.train_loss(params, batch, cfg, remat=remat)
    loss.backward()
    grads = tree_map(lambda p: p.grad, params)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def train(arch: str, smoke: bool = True, steps: int = 50, batch: int = 8,
          seq: int = 256, lr: float = 1e-3, seed: int = 0,
          ckpt: Optional[str] = None, log_every: int = 10,
          remat: bool = False, device="cuda",
          layers: Optional[int] = None) -> List[float]:
    """Train a zoo model on synthetic LM batches; returns each step's
    loss.  ``device`` defaults to the card and raises without one;
    ``layers`` cuts the depth (``model_config``)."""
    dev = resolve_device(device)
    cfg = model_config(arch, smoke, layers)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = tf_model.init_params(gen, cfg)
    opt = adamw(lr)
    opt_state = opt.init(params)
    extras = memory_stub(cfg, batch, seq, dev)
    losses = []
    sync(dev)
    t0 = time.perf_counter()
    for i, b in enumerate(lm_batches(cfg.vocab, batch, seq, steps, seed)):
        arrs = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        arrs.update(extras)
        loss, _, grads = loss_and_grads(params, arrs, cfg, remat)
        with torch.no_grad():
            params, opt_state = opt.step(params, grads, opt_state)
        del grads
        losses.append(float(loss))
        if log_every and (i + 1) % log_every == 0:
            dt = (time.perf_counter() - t0) / (i + 1)
            print(f"step {i+1}/{steps} loss={losses[-1]:.4f} "
                  f"({dt:.2f}s/step, {1e3 * dt:.1f} ms a step, "
                  f"{batch * seq / dt:.1f} tokens/s)", flush=True)
    if ckpt:
        save_checkpoint(ckpt, {"params": params},
                        metadata={"arch": arch, "steps": steps,
                                  "final_loss": losses[-1]})
        print(f"checkpoint written to {ckpt}")
    return losses


def main():
    """CLI wrapper around ``train``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (widths kept)")
    args = ap.parse_args()
    losses = train(args.arch, smoke=args.smoke, steps=args.steps,
                   batch=args.batch, seq=args.seq, lr=args.lr,
                   seed=args.seed, ckpt=args.ckpt,
                   log_every=args.log_every, remat=args.remat,
                   device=args.device, layers=args.layers)
    print(f"first loss {losses[0]:.4f} -> final loss {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
