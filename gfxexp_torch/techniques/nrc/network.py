"""NRC network: encoding -> 64-wide ReLU MLP -> RGB radiance, trained online
with the RelativeL2Luminance loss, Adam and an EMA of the weights (port of
gfxexp_tpu/techniques/nrc/network.py).

The reference's tiny-cuda-nn setup: a fully fused MLP of 64 neurons, ReLU,
no output activation, `num_hidden_layers` hidden layers; the loss
RelativeL2Luminance; the optimizer EMA(0.99) over Adam(lr, b1 0.9, b2 0.99,
l2 1e-6, eps per encoding). Inference reads the EMA weights.

The matmuls mirror JAX's bf16 inputs with f32 results: activations and
weights are rounded to bf16 and multiplied in f32 (TF32 must be off, as
torch leaves it by default), and the hidden activations are rounded to
bf16 again after the ReLU. The optimizer is written out in the order of
optax's chain (weight decay, scale_by_adam with eps outside the square
root, scale by -lr), then the EMA.

State: {"params": {"weights": [...], "hash_table"?}, "ema": <params>,
"opt": {"count", "mu", "nu"}, "step"}, tensors on one device.

Tracing (utils/trace.py): train_on_frame is span `gfx.nrc.train`, each
step `gfx.nrc.train.step<k>` with its stages `.encode`, `.mlp`,
`.backward` and `.adam`; it counts `nrc.frames` (a frame trained),
`nrc.train_steps`, `nrc.train_rows` (the records through each step, the
masked ones too), `nrc.train_params` (the parameters each step updates)
and `nrc.train_macs` (the multiply-adds of each step's forward MLP), from
the tensors' shapes.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from gfxexp_torch.core.tree import (
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from gfxexp_torch.techniques.nrc import encoding as enc
from gfxexp_torch.utils import trace

# a query: position 3, direction 2, normal 2, roughness 1, diffuse 3,
# specular 3
NUM_INPUT_DIMS = 14
NUM_OUTPUT_DIMS = 3
WEIGHT_DECAY = 1e-6
ADAM_B1 = 0.9
ADAM_B2 = 0.99

POSITION_ENCODING_TRIANGLE_WAVE = "triangle_wave"
POSITION_ENCODING_HASH_GRID = "hash_grid"

NRCState = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class NRCConfig:
    # TriangleWave by default, as the JAX package; the reference defaults
    # to HashGrid, which -position-encoding hash_grid selects
    position_encoding: str = POSITION_ENCODING_TRIANGLE_WAVE
    num_hidden_layers: int = 2
    learning_rate: float = 1e-2
    ema_decay: float = 0.99
    width: int = 64

    @property
    def adam_eps(self):
        # the reference: 1e-8 for TriangleWave, 1e-15 for HashGrid
        return (1e-8 if self.position_encoding
                == POSITION_ENCODING_TRIANGLE_WAVE else 1e-15)

    @property
    def encoded_dims(self):
        if self.position_encoding == POSITION_ENCODING_TRIANGLE_WAVE:
            pos = 3 * enc.N_FREQUENCIES
        else:
            pos = enc.HASH_LEVELS * enc.HASH_FEATURES
        return pos + 5 * enc.ONE_BLOB_BINS + 6


def encode_query(params, query, cfg: NRCConfig):
    """query [..., 14] (pos xyz | dir phi, theta | normal phi, theta |
    roughness | diffuse rgb | specular rgb, all in [0, 1]) -> features."""
    pos = query[..., 0:3]
    if cfg.position_encoding == POSITION_ENCODING_TRIANGLE_WAVE:
        pos_feat = enc.triangle_wave_encoding(pos)
    else:
        pos_feat = enc.hash_grid_encoding(params["hash_table"], pos)
    return torch.cat([pos_feat, enc.one_blob_encoding(query[..., 3:8]),
                      query[..., 8:14]], dim=-1)


def init_nrc(generator: torch.Generator = None,
             cfg: NRCConfig = NRCConfig(), device="cuda") -> NRCState:
    """A fresh state on `device`: He-initialised hidden layers and a zero
    output layer (the fresh cache predicts 0), drawn from `generator` (on
    its own device, the CPU by default, so that every device starts from
    the same weights); EMA equal to the params; Adam's moments zero."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    gen_dev = generator.device
    dims = ([cfg.encoded_dims] + [cfg.width] * (cfg.num_hidden_layers + 1)
            + [NUM_OUTPUT_DIMS])
    params: Dict[str, Any] = {}
    if cfg.position_encoding == POSITION_ENCODING_HASH_GRID:
        params["hash_table"] = enc.init_hash_table(generator, device=device)
    ws = []
    for i in range(len(dims) - 1):
        w = torch.randn((dims[i], dims[i + 1]), generator=generator,
                        device=gen_dev) * (2.0 / dims[i]) ** 0.5
        if i == len(dims) - 2:
            w = torch.zeros_like(w)
        ws.append(w.to(device))
    params["weights"] = ws
    zeros = tree_map(torch.zeros_like, params)
    return {
        "params": params,
        "ema": tree_map(torch.clone, params),
        "opt": {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": zeros, "nu": tree_map(torch.zeros_like, params)},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _bf16(x):
    """Round to bf16 and back: the value JAX's bf16 operand holds."""
    return x.to(torch.bfloat16).to(torch.float32)


def _stage(stage, part):
    """Span `<stage>.<part>`, or nothing where no stage is named."""
    if stage is None:
        return contextlib.nullcontext()
    return trace.span(f"{stage}.{part}")


def apply(params, query, cfg: NRCConfig, stage: str = None):
    """Forward pass [B, 14] -> [B, 3]: bf16-rounded operands, f32
    products and sums (JAX's preferred_element_type=f32). With `stage`,
    the encoding and the MLP are spans `<stage>.encode` and
    `<stage>.mlp`."""
    with _stage(stage, "encode"):
        x = _bf16(encode_query(params, query, cfg))
    with _stage(stage, "mlp"):
        ws = params["weights"]
        zero = torch.zeros((), device=x.device)
        for i, w in enumerate(ws):
            x = torch.matmul(x, _bf16(w))
            if i < len(ws) - 1:
                # torch.maximum splits the gradient at 0 as jnp.maximum does
                x = _bf16(torch.maximum(x, zero))
    return x


def _relative_l2_luminance(pred, target):
    """tiny-cuda-nn's RelativeL2Luminance per record, (p - t)^2 /
    (lum(p)^2 + 0.01), with the normaliser detached."""
    lum = (0.2126 * pred[..., 0] + 0.7152 * pred[..., 1]
           + 0.0722 * pred[..., 2])
    denom = (lum * lum).detach() + 0.01
    return ((pred - target) ** 2).sum(dim=-1) / denom


def relative_l2_luminance_loss(pred, target):
    """The mean RelativeL2Luminance loss of predictions [..., 3]."""
    return _relative_l2_luminance(pred, target).mean()


def masked_loss_sum(params, query, target, mask, cfg: NRCConfig,
                    stage: str = None):
    """The RelativeL2Luminance loss summed over the records `mask` keeps
    (the data-parallel step sums it over the devices)."""
    per = _relative_l2_luminance(apply(params, query, cfg, stage), target)
    return torch.where(mask, per, 0.0).sum()


def masked_loss(params, query, target, mask, cfg: NRCConfig,
                stage: str = None):
    """masked_loss_sum over max(sum(mask), 1): the batch's mean loss, the
    masked records weighing 0."""
    return (masked_loss_sum(params, query, target, mask, cfg, stage)
            / torch.clamp(mask.sum().to(torch.float32), min=1.0))


def infer(state: NRCState, query, cfg: NRCConfig = NRCConfig()):
    """Cache lookup with the EMA weights."""
    with torch.no_grad():
        return apply(state["ema"], query, cfg)


def value_and_grads(fn, params, *args, stage: str = None):
    """(fn(params, *args), its gradients with the structure of
    `params`). With `stage`, the backward pass is span
    `<stage>.backward`."""
    leaves, structure = tree_flatten(params)
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        value = fn(tree_unflatten(structure, leaves), *args)
        with _stage(stage, "backward"):
            grads = torch.autograd.grad(value, leaves)
    return value.detach(), tree_unflatten(structure, list(grads))


def loss_and_grads(params, query, target, mask, cfg: NRCConfig,
                   stage: str = None):
    """(loss, grads with the structure of `params`)."""
    return value_and_grads(masked_loss, params, query, target, mask, cfg,
                           stage, stage=stage)


def apply_step(state: NRCState, grads, cfg: NRCConfig) -> NRCState:
    """The optimizer step from given gradients, in the order of optax's
    chain (add_decayed_weights(1e-6), scale_by_adam(b1 0.9, b2 0.99, bias
    correction, eps outside the square root), scale(-lr), apply), then the
    EMA of the weights."""
    opt = state["opt"]
    count = opt["count"] + 1
    cf = count.to(torch.float32)
    one = torch.ones((), device=cf.device)
    bc1 = 1.0 - torch.pow(one * ADAM_B1, cf)
    bc2 = 1.0 - torch.pow(one * ADAM_B2, cf)
    eps, lr, d = cfg.adam_eps, cfg.learning_rate, cfg.ema_decay
    new_p, new_mu, new_nu, new_ema = [], [], [], []
    for p, g, m, v, e in zip(*(tree_leaves(x) for x in (
            state["params"], grads, opt["mu"], opt["nu"], state["ema"]))):
        g = g + WEIGHT_DECAY * p
        m = (1 - ADAM_B1) * g + ADAM_B1 * m
        v = (1 - ADAM_B2) * (g * g) + ADAM_B2 * v
        p = p + (-lr) * ((m / bc1) / (torch.sqrt(v / bc2) + eps))
        new_p.append(p)
        new_mu.append(m)
        new_nu.append(v)
        new_ema.append(d * e + (1.0 - d) * p)
    _, structure = tree_flatten(state["params"])

    def tree(leaves):
        return tree_unflatten(structure, leaves)

    return {"params": tree(new_p), "ema": tree(new_ema),
            "opt": {"count": count, "mu": tree(new_mu), "nu": tree(new_nu)},
            "step": state["step"] + 1}


def train_step(state: NRCState, query, target, mask,
               cfg: NRCConfig = NRCConfig(), stage: str = None):
    """One Adam step on a batch (`mask` selects the valid records).
    Returns (new state, loss). With `stage`, its encoding, MLP, backward
    pass and optimizer are spans `<stage>.encode`, `.mlp`, `.backward`
    and `.adam`."""
    params = state["params"]
    trace.count("nrc.train_steps")
    trace.count("nrc.train_rows", query.shape[0])
    trace.count("nrc.train_params",
                sum(p.numel() for p in tree_flatten(params)[0]))
    trace.count("nrc.train_macs", query.shape[0] * sum(
        w.shape[0] * w.shape[1] for w in params["weights"]))
    loss, grads = loss_and_grads(params, query, target, mask, cfg, stage)
    with _stage(stage, "adam"):
        return apply_step(state, grads, cfg), loss


def train_on_frame(state: NRCState, query, target, mask,
                   cfg: NRCConfig = NRCConfig(), steps: int = 4,
                   generator: torch.Generator = None, perm=None):
    """One frame's training: `steps` Adam steps on disjoint slices of a
    permutation of the frame's records (the reference's loop of four
    steps a frame). The trailing n % steps records are dropped, and the
    loss is the mean of the steps' losses, a slice with no valid record
    included. The permutation comes from `generator` (a CPU generator
    seeded 0 by default, so that every device draws the same order), or
    is `perm` [n] as given. Returns (new state, mean loss)."""
    with trace.span("gfx.nrc.train"):
        trace.count("nrc.frames")
        return _train_on_frame(state, query, target, mask, cfg, steps,
                               generator, perm)


def _train_on_frame(state, query, target, mask, cfg, steps, generator,
                    perm):
    n = query.shape[0]
    m = (n // steps) * steps
    if perm is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        perm = torch.randperm(n, generator=generator,
                              device=generator.device)
    elif not isinstance(perm, torch.Tensor):
        perm = torch.tensor(np.asarray(perm))
    perm = perm.to(torch.int64)
    if perm.device != query.device:
        if query.device.type == "cuda":
            # pinned and asynchronous: no wait for the frame's kernels
            perm = perm.pin_memory().to(query.device, non_blocking=True)
        else:
            perm = perm.to(query.device)
    perm = perm[:m].reshape(steps, m // steps)
    losses = []
    for k in range(steps):
        stage = f"gfx.nrc.train.step{k}"
        with trace.span(stage):
            idx = perm[k]
            state, loss = train_step(state, query[idx], target[idx],
                                     mask[idx], cfg, stage)
        losses.append(loss)
    return state, torch.stack(losses).mean()


def nrc_state_from_jax(tree, device="cuda") -> NRCState:
    """The port's state from the JAX package's NRC state with numpy leaves
    (e.g. jax.tree_util.tree_map(np.asarray, state)): params and EMA
    ({"weights": [...], "hash_table"?}), optax's opt state
    (EmptyState, ScaleByAdamState(count, mu, nu), EmptyState) and the
    step. Reads the Adam state by field name: no optax import."""
    def t(x):
        return torch.tensor(np.asarray(x), device=device)

    def get(obj, name):
        return obj[name] if isinstance(obj, dict) else getattr(obj, name)

    adam = next(s for s in tree["opt"]
                if (isinstance(s, dict) and "mu" in s) or hasattr(s, "mu"))
    return {
        "params": tree_map(t, tree["params"]),
        "ema": tree_map(t, tree["ema"]),
        "opt": {"count": t(get(adam, "count")).to(torch.int32),
                "mu": tree_map(t, get(adam, "mu")),
                "nu": tree_map(t, get(adam, "nu"))},
        "step": t(tree["step"]).to(torch.int32),
    }
