"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default is ``"cuda"``, and asking for CUDA on a machine without a card
raises instead of quietly running on the CPU.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = "cuda"
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def disable_tf32() -> None:
    """float32 means real float32: TF32 keeps ~3 decimal digits, which
    would break parity with the reference's ``highest`` precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


_SCALARS: Dict[Tuple[str, torch.dtype, torch.device], torch.Tensor] = {}


def scalar(v, dtype: torch.dtype, device) -> torch.Tensor:
    """The 0-d constant ``torch.tensor(v, dtype=dtype, device=device)``,
    made once per (value, dtype, device) and shared by every caller, who
    never writes to it. On the card ``torch.tensor`` copies from pageable
    host memory and waits for the device's queue: made once, a constant
    costs the decode step no wait, and the step can be captured in a CUDA
    graph (``decode/greedy.py``). A constant is made before any capture
    that reads it; a first use inside one raises. It is never an inference
    tensor, so that training's autograd may save it for the backward."""
    device = torch.device(device)
    key = (repr(v), dtype, device)
    t = _SCALARS.get(key)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"the constant {v!r} ({dtype}) is first used inside a CUDA "
                "graph capture; make it before the capture")
        with torch.inference_mode(False):
            t = torch.tensor(v, dtype=dtype, device=device)
        t = _SCALARS.setdefault(key, t)
    return t
