"""The IV-surface network, as options_model_tpu/surface/network.py (a flax
module there): a 2 -> hidden projection with GELU, ``num_hidden_layers``
residual blocks of Dense -> LayerNorm -> GELU -> Dropout, a linear head, and
the output's leaky floor at ``epsilon``.

flax.linen's defaults, which torch's do not share, are kept:
- ``nn.gelu`` is the tanh approximation (F.gelu(approximate="tanh"));
- ``nn.LayerNorm`` takes epsilon 1e-6 and the variance as E[x^2] - E[x]^2
  (use_fast_variance), floored at 0 (FlaxLayerNorm);
- ``nn.Dropout`` keeps a unit with probability 1 - p and scales it by
  1 / (1 - p); here the mask comes from an explicit torch.Generator
  (GeneratorDropout), as torch.nn.Dropout takes none;
- Dense kernels start lecun_normal: a normal truncated at +-2 standard
  deviations, scaled to standard deviation sqrt(1 / fan_in); biases start
  at 0, LayerNorm at scale 1 and bias 0.

``iv_state_from_flax`` carries the JAX package's parameters across.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from options_model_tpu_torch.core.config import SurfaceTrainConfig

# Standard deviation of a unit normal truncated at +-2 (jax.nn.initializers'
# variance_scaling divides by it so the truncated draw has the asked-for std).
_TRUNC_STD = 0.87962566103423978


class FlaxLayerNorm(nn.Module):
    """flax.linen.LayerNorm: y = (x - mean) rsqrt(var + eps) scale + bias,
    var = max(E[x^2] - E[x]^2, 0), the statistics in at least float32."""

    def __init__(self, width: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = x.float()
        mean = xs.mean(-1, keepdim=True)
        var = torch.clamp_min((xs * xs).mean(-1, keepdim=True) - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps).to(x.dtype) * self.weight
        return (x - mean.to(x.dtype)) * mul + self.bias


class GeneratorDropout(nn.Module):
    """Dropout with the mask drawn from the generator the caller sets on
    ``generator`` (on its device, which should be the input's: a mask from
    the host would make each step wait on its copy): keep with probability
    1 - p, scale kept units by 1 / (1 - p). Inactive (the identity) when p
    is 0, in eval mode, or with no generator set."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.p <= 0.0 or not self.training or self.generator is None:
            return x
        u = torch.rand(x.shape, generator=self.generator, device=self.generator.device)
        keep = (u < 1.0 - self.p).to(x.device)
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype,
                                                                   device=x.device))


class IVNetwork(nn.Module):
    """sigma_IV(m_norm, tau_norm): (n, 2) -> (n, 1)."""

    def __init__(self, hidden_dim: int = 64, num_hidden_layers: int = 4,
                 dropout: float = 0.1, epsilon: float = 1e-4):
        super().__init__()
        self.epsilon = epsilon
        self.input = nn.Linear(2, hidden_dim)
        self.blocks = nn.ModuleList(nn.Linear(hidden_dim, hidden_dim)
                                    for _ in range(num_hidden_layers))
        self.norms = nn.ModuleList(FlaxLayerNorm(hidden_dim) for _ in range(num_hidden_layers))
        self.drops = nn.ModuleList(GeneratorDropout(dropout) for _ in range(num_hidden_layers))
        self.head = nn.Linear(hidden_dim, 1)

    def set_dropout_generator(self, generator: Optional[torch.Generator]) -> None:
        """The generator every dropout layer draws its masks from (None: no
        dropout, whatever the mode)."""
        for d in self.drops:
            d.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.input(x), approximate="tanh")
        for dense, norm, drop in zip(self.blocks, self.norms, self.drops):
            h = h + drop(F.gelu(norm(dense(h)), approximate="tanh"))
        out = self.head(h)
        # The leaky floor: ~epsilon below it, with a live gradient (slope
        # 0.01) so that early penalty steps cannot pin the net there. max
        # and min split a tie's gradient, as jnp.maximum and jnp.minimum do.
        eps = torch.full((), self.epsilon, dtype=out.dtype, device=out.device)
        return torch.maximum(out, eps) + 0.01 * torch.minimum(out - eps, torch.zeros_like(eps))


def make_network(cfg: SurfaceTrainConfig) -> IVNetwork:
    return IVNetwork(hidden_dim=cfg.hidden_dim, num_hidden_layers=cfg.num_hidden_layers,
                     dropout=cfg.dropout, epsilon=cfg.epsilon)


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    std = float(np.sqrt(1.0 / weight.shape[1])) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def init_params(cfg: SurfaceTrainConfig, generator: torch.Generator,
                target_mean_iv: float) -> IVNetwork:
    """A network of ``cfg`` on the generator's device with flax's init
    (lecun_normal kernels, zero biases, unit LayerNorm), the head kernel at
    0 and the head bias at the mean target IV, so the initial output is
    that mean exactly (the reference's init_params)."""
    net = make_network(cfg).to(generator.device)
    with torch.no_grad():
        for lin in [net.input, *net.blocks]:
            _lecun_normal_(lin.weight, generator)
            lin.bias.zero_()
        net.head.weight.zero_()
        net.head.bias.fill_(float(np.float32(target_mean_iv)))
    return net


def iv_state_from_flax(params) -> dict:
    """An IVNetwork state_dict from the JAX package's flax params ({"params":
    {...}} or the inner dict) as numpy arrays: Dense_0 the input projection,
    Dense_1..Dense_L the blocks, LayerNorm_i their norms (scale -> weight),
    head the head; each (in, out) kernel becomes the (out, in) weight."""
    inner = params.get("params", params)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    n_blocks = sum(1 for k in inner if k.startswith("LayerNorm_"))
    state = {"input.weight": t(inner["Dense_0"]["kernel"]).T.contiguous(),
             "input.bias": t(inner["Dense_0"]["bias"]),
             "head.weight": t(inner["head"]["kernel"]).T.contiguous(),
             "head.bias": t(inner["head"]["bias"])}
    for i in range(n_blocks):
        dense, norm = inner[f"Dense_{i + 1}"], inner[f"LayerNorm_{i}"]
        state[f"blocks.{i}.weight"] = t(dense["kernel"]).T.contiguous()
        state[f"blocks.{i}.bias"] = t(dense["bias"])
        state[f"norms.{i}.weight"] = t(norm["scale"])
        state[f"norms.{i}.bias"] = t(norm["bias"])
    return state
