"""Engine selection, as options_model_tpu/ops/engine.py.

Two engines, one random stream: "cuda" launches the hand-written kernels
(csrc/) on a CUDA device; "torch" runs their plain PyTorch versions, on the
CPU only. They give the same Philox bits (ops/philox.py), so a price depends
on the device only through f32 rounding. There is no interpret engine and no
fallback: a CUDA device always goes to the kernels or raises, and the CPU
runs only when the caller asks for it (``device="cpu"``).
"""

from __future__ import annotations

import torch

ENGINES = ("cuda", "torch")


def default_device() -> torch.device:
    """The card, whether or not torch can see one: a call without a device
    on a machine without CUDA raises where the kernels are reached
    (resolve_engine, _build.require_cuda), never prices on the CPU."""
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    return default_device() if device is None else torch.device(device)


def checked_device(device=None) -> torch.device:
    """resolve_device, raising for a device the port does not run on and for
    a CUDA device torch cannot reach: the entry points that compute with
    plain tensor ops (the closed forms, the Greeks) run on the card unless
    the caller asks for the CPU, as the kernels' entry points do."""
    dev = resolve_device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the port runs on a CPU or CUDA device, got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available to torch")
    return dev


def resolve_engine(engine: str, device=None) -> str:
    """'auto' -> 'cuda' on a CUDA device, 'torch' on the CPU. An explicit
    engine that does not fit the device raises."""
    if engine not in ENGINES + ("auto",):
        raise ValueError(f"engine must be 'auto', 'cuda' or 'torch', got {engine!r}")
    dev = checked_device(device)
    if engine == "auto":
        return "cuda" if dev.type == "cuda" else "torch"
    if (engine == "cuda") != (dev.type == "cuda"):
        raise ValueError(f"engine={engine!r} does not run on device {dev}: "
                         "'cuda' launches the kernels on a CUDA device, "
                         "'torch' runs their plain versions on the CPU")
    return engine
