"""The comparison that decides ``correct``: served tokens against the
plain reference, and the same comparison for the control.

For each sampled request the reference makes the mel from the request's
audio, encodes it, tokenizes the request's prompt itself, and runs the
decoder teacher-forced over the prompt and the served tokens; each served
token is judged by its gap (``rules.py``). The encoder runs in blocks of
``BLOCK`` windows and the decoder a row at a time, so that the reference
fits beside nothing: it runs after the program's state is freed.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .rules import row_gaps
from .tokens import Encoder, Layout, prompt_tokens
from .whisper import Reference, log_mel

BLOCK = 4


def _encode_all(ref: Reference, mels: List[np.ndarray], device):
    out = []
    for i in range(0, len(mels), BLOCK):
        m = torch.from_numpy(np.stack(mels[i:i + BLOCK])).to(device)
        out.extend(ref.encode(m))
    return out


def judge(tree: Dict, c: dict, lay: Layout, enc: Encoder, sample: List[dict],
          device, bits: Optional[int] = 8,
          control_bits: Optional[int] = None) -> Dict:
    """``sample``: dicts with ``audio``, ``vocabulary``, ``context``,
    ``prompt`` (the program's prompt ids, compared exactly) and ``served``
    (its tokens); ``bits``: the configuration's weights (8: int8, None:
    float). Returns the widest gap, the prompts that differ, and
    with ``control_bits`` the control's widest gap."""
    mels = [log_mel(r["audio"], c["num_mel_bins"]) for r in sample]
    ref = Reference(tree, c, bits=bits)
    xas = _encode_all(ref, mels, device)
    ctl = xcs = None
    if control_bits is not None:
        ctl = Reference(tree, c, bits=control_bits)
        xcs = _encode_all(ctl, mels, device)
    widest, widest_ctl, bad_prompts, gaps = 0.0, 0.0, 0, []
    for i, r in enumerate(sample):
        prompt = prompt_tokens(enc, lay, r["vocabulary"], r["context"])
        if r.get("prompt") is not None and list(r["prompt"]) != prompt:
            bad_prompts += 1
        served = list(r["served"])
        if not served:
            continue
        seq = prompt + served[:-1]
        lo = len(prompt) - 1
        lg = ref.logits(xas[i], seq)[lo:].cpu().numpy()
        g = row_gaps(lg, served, lay)
        gaps.append(max(g))
        widest = max(widest, max(g))
        if ctl is not None:
            lc = ctl.logits(xcs[i], seq)[lo:].cpu().numpy()
            widest_ctl = max(widest_ctl,
                             max(row_gaps(lg, served, lay, choices=lc)))
    out = {"widest_gap": widest, "prompts_differ": bad_prompts,
           "row_gaps": gaps, "tokens_judged": sum(len(r["served"])
                                                  for r in sample)}
    if ctl is not None:
        out["control_widest_gap"] = widest_ctl
    return out
