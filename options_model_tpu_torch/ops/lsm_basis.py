"""The LSM regression features, as options_model_tpu/ops/lsm_basis.py.

The 7-feature basis of the NN-LSM's continuation network:

    x = S / K,  st = sqrt(max(tau, 1e-6))
    [1, x, x^2, x^3, max(x - 1, 0), st, x * st]
"""

from __future__ import annotations

import torch

NUM_FEATURES = 7


def regression_features(S: torch.Tensor, K, tau) -> torch.Tensor:
    """Features (..., 7) of spots S (...,); ``tau`` a scalar or a tensor
    that broadcasts against S."""
    x = S / K
    st = torch.sqrt(torch.clamp_min(torch.as_tensor(tau, dtype=x.dtype, device=x.device),
                                    1e-6))
    st = torch.broadcast_to(st, x.shape)
    return torch.stack([torch.ones_like(x), x, x**2, x**3, torch.clamp_min(x - 1.0, 0.0),
                        st, x * st], dim=-1)


def poly_features(S: torch.Tensor, K, tau=None, degree: int = 2) -> torch.Tensor:
    """Plain polynomial basis [1, x, ..., x^degree] in x = S / K (``tau``
    unused, kept for the reference's signature)."""
    x = S / K
    return torch.stack([x**d for d in range(degree + 1)], dim=-1)
