"""Faults planted underneath the timed path, for the benchmark's tests and
``calibrate.py``: each function returns a program (``benchmark.program``
with one call replaced) whose result the check must refuse.  The
benchmark's own runs never use them."""
from __future__ import annotations

import types

import torch

from benchmark import program as P


def program_with(**over):
    ns = types.SimpleNamespace(**{k: getattr(P, k) for k in dir(P) if not k.startswith("_")})
    ns.__dict__.update(over)
    return ns


def stale():
    """Every frame returns the previous call's image."""
    last = {}

    def render(scene, cfg, plan=None):
        img = P.render(scene, cfg, plan=plan)
        out = last.get("img", torch.zeros_like(img))
        last["img"] = img
        return out

    return program_with(render=render)


def block():
    """A block of pixels at the centre of every frame set to black: 64 × 64,
    or an eighth of the image's sides where that is smaller."""
    def render(scene, cfg, plan=None):
        img = P.render(scene, cfg, plan=plan).clone()
        h, w = img.shape[0] // 2, img.shape[1] // 2
        r = min(32, h // 4, w // 4)
        img[h - r:h + r, w - r:w + r] = 0.0
        return img

    return program_with(render=render)


def unchanged():
    """A step that returns its state unchanged (and the true loss)."""
    def make_train_step(cfg, plan=None, mesh=None):
        step = P.make_train_step(cfg, plan=plan, mesh=mesh)
        return lambda scene, target, lr: (scene, step(scene, target, lr)[1])

    return program_with(make_train_step=make_train_step)


def half():
    """A step whose loss and gradients leave out the lower half of the
    image's rows: the mean taken over the rest."""
    from tpurt_torch import render_and_grad
    from tpurt_torch.dist.train import sgd_update

    def make_train_step(cfg, plan=None, mesh=None):
        rows = cfg.height // 2

        def step(scene, target, lr):
            with torch.no_grad():
                (loss, _), grads = render_and_grad(
                    scene, lambda img: torch.mean((img[:rows] - target[:rows]) ** 2), cfg,
                    plan=plan)
                return sgd_update(scene, grads, lr), loss

        return step

    return program_with(make_train_step=make_train_step)


def no_exchange():
    """The mesh step with the exchange between ranks left out: each rank
    updates the scene with the gradients of its own rows alone."""
    import tpurt_torch.dist.train as T

    def make_train_step(cfg, plan=None, mesh=None):
        T.sum_in_rank_order = lambda grads, mesh: list(grads)
        return T.make_train_step(cfg, mesh=mesh, plan=plan)

    return program_with(make_train_step=make_train_step)
