"""One error for every feature of the JAX package this port does not carry yet."""

from __future__ import annotations


def not_ported(feature: str, reference: str) -> NotImplementedError:
    """NotImplementedError naming the JAX function that implements ``feature``."""
    return NotImplementedError(
        f"{feature} is not ported to options_model_tpu_torch yet; the JAX "
        f"implementation is options_model_tpu.{reference}")
