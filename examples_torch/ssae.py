"""Spar-Sink auto-encoder (SSAE, paper Appendix D.2), miniature version, on
the PyTorch port.

Trains a 2-layer MLP auto-encoder on a synthetic two-moons-ish dataset with
reconstruction loss + a Sinkhorn-divergence regularizer S(f#p_X, p_Z)
pulling the latent distribution toward a standard Gaussian. The regularizer
is computed with Spar-Sink (Algorithm 3), the paper's SSAE recipe.

    PYTHONPATH=src python examples_torch/ssae.py [--device cpu] [--steps 150]

The counterpart of ``examples/ssae.py``, in float64 as the reference runs
it. One `torch.Generator` a step, seeded with the step number, draws the
batch, the prior sample and the three sketches in that order, where the
reference folds the step into a JAX key and splits it.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch._device import resolve_device
from repro_torch.core import ot_sampling_probs, s0, squared_euclidean_cost
from repro_torch.core.sparsify import sparsify_dense
from repro_torch.optim import adamw_init, adamw_update

LATENT = 2
BATCH = 256
GAMMA = 0.2
EPS = 0.05
SINK_ITERS = 60  # fixed => reverse-differentiable (paper's SSAE recipe)
DTYPE = torch.float64


def entropy_term(T):
    """``sum T (log T - 1)`` over ``T > 0``. The inner ``where`` keeps
    ``log`` away from 0: with ``where(T > 0, T * (log T - 1), 0)`` alone the
    gradient at a zero entry is 0 * (-inf) = NaN."""
    pos = T > 0
    return torch.sum(torch.where(pos, T * (torch.log(torch.where(pos, T, 1.0)) - 1), 0.0))


def _ot_eps_fixed(generator, x, y):
    """Differentiable Spar-Sink OT_eps with a fixed iteration count.
    The Poisson mask and the probabilities are constants (like dropout);
    kept kernel values carry gradients through C."""
    n = x.shape[0]
    a = torch.full((n,), 1.0 / n, dtype=x.dtype, device=x.device)
    C = squared_euclidean_cost(x, y)
    K = torch.exp(-C / EPS)
    probs = ot_sampling_probs(a, a).detach()
    Kt = sparsify_dense(generator, K, probs, 8 * s0(n))
    u, v = torch.ones_like(a), torch.ones_like(a)
    for _ in range(SINK_ITERS):
        u = a / torch.clamp_min(Kt @ v, 1e-30)
        v = a / torch.clamp_min(Kt.T @ u, 1e-30)
    T = u[:, None] * Kt * v[None, :]
    return torch.sum(T * C) + EPS * entropy_term(T)


def spar_sink_divergence_fixed(generator, x, y):
    return _ot_eps_fixed(generator, x, y) - 0.5 * (
        _ot_eps_fixed(generator, x, x) + _ot_eps_fixed(generator, y, y)
    )


def data_batch(generator, n):
    dev = generator.device
    t = torch.rand(n, dtype=DTYPE, device=dev, generator=generator) * 2 * torch.pi
    x = torch.stack([torch.cos(t), torch.sin(2 * t)], -1)
    return x + 0.05 * torch.randn((n, 2), dtype=DTYPE, device=dev, generator=generator)


def init_net(generator):
    def g(i, o):
        w = torch.randn((i, o), dtype=DTYPE, device=generator.device, generator=generator) * (i**-0.5)
        return w.requires_grad_()

    return {"enc1": g(2, 64), "enc2": g(64, LATENT), "dec1": g(LATENT, 64), "dec2": g(64, 2)}


def encode(p, x):
    return torch.tanh(x @ p["enc1"]) @ p["enc2"]


def decode(p, z):
    return torch.tanh(z @ p["dec1"]) @ p["dec2"]


def loss_fn(p, x, generator):
    z = encode(p, x)
    recon = torch.mean((decode(p, z) - x) ** 2)
    prior = torch.randn(z.shape, dtype=z.dtype, device=z.device, generator=generator)
    div = spar_sink_divergence_fixed(generator, z, prior)
    return recon + GAMMA * div, (recon, div)


def main(argv=None):
    ap = argparse.ArgumentParser(description="a miniature Spar-Sink auto-encoder")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=BATCH)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    def step_generator(step):
        return torch.Generator(device=device).manual_seed(step)

    params = init_net(torch.Generator(device=device).manual_seed(0))
    opt = adamw_init(params)
    names = sorted(params)
    last = args.steps - 1
    for step in range(args.steps):
        gen = step_generator(step)
        x = data_batch(gen, args.batch)
        loss, (recon, div) = loss_fn(params, x, gen)
        grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
        loss, recon, div = loss.detach(), recon.detach(), div.detach()
        params, opt, _ = adamw_update(grads, opt, params, lr=2e-3, weight_decay=0.0)
        if step % 30 == 0 or step == last:
            with torch.no_grad():
                z = encode(params, x)
            print(f"step {step:3d}  loss {float(loss):.4f}  recon {float(recon):.4f}  "
                  f"sink-div {float(div):+.4f}  latent std {float(z.std(correction=0)):.3f}")
    # the latent distribution should be about unit-scale and gaussian-ish
    with torch.no_grad():
        z = encode(params, data_batch(step_generator(999), 1024))
    print("final latent mean", z.mean(0).cpu().numpy().round(3),
          "std", z.std(0, correction=0).cpu().numpy().round(3))
    return {"loss": float(loss), "recon": float(recon), "div": float(div)}


if __name__ == "__main__":
    main()
