"""Random Whisper weights made on the device from the run's seed.

One ``torch.randn`` call in bfloat16 (the type the engine is served in)
fills every random leaf: each leaf is a view of that buffer, scaled in
place, then copied into a storage of its own. The tree has the program's
layout (per-layer weights stacked on a leading axis, linear weights
(d_in, d_out)), which the plain reference reads as well. The reference
makes the same tree again from the same seed rather than reading the
program's copy.

Biases and LayerNorm parameters are drawn too (small), so that a path
that dropped one would show. The end-of-text token is kept from winning:
the final LayerNorm's bias gets a component ``EOT_BIAS`` along a random
unit vector u, and the eot row of the token embedding is ``-EOT_NORM *
u``; eot's logit is then about ``-EOT_NORM * (EOT_BIAS + z)`` with z a
standard normal, near -32, while every other logit stays near a standard
normal. So every request decodes its whole ``sample_len``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

EOT_BIAS = 8.0
EOT_NORM = 4.0


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's encoder position table."""
    inc = math.log(10000) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def _leaves(c: dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], str,
                                   float]]:
    """(path, shape, kind, scale): kind "w" normal * scale, "g" 1 + normal
    * scale, "b" normal * scale."""
    d, m, v = c["d_model"], c["num_mel_bins"], c["vocab_size"]
    out = [(("encoder", "conv1_w"), (3, m, d), "w", (3 * m) ** -0.5),
           (("encoder", "conv1_b"), (d,), "b", 0.02),
           (("encoder", "conv2_w"), (3, d, d), "w", (3 * d) ** -0.5),
           (("encoder", "conv2_b"), (d,), "b", 0.02),
           (("encoder", "ln_post_g"), (d,), "g", 0.05),
           (("encoder", "ln_post_b"), (d,), "b", 0.02),
           (("decoder", "tok_emb"), (v, d), "w", d ** -0.5),
           (("decoder", "pos"), (c["max_target_positions"], d), "w", 0.01),
           (("decoder", "ln_g"), (d,), "g", 0.05),
           (("decoder", "ln_b"), (d,), "b", 0.02)]
    for part, n, cross in (("encoder", c["encoder_layers"], False),
                           ("decoder", c["decoder_layers"], True)):
        f = c[f"{part}_ffn_dim"]
        blk = [("ln1_g", (d,), "g", 0.05), ("ln1_b", (d,), "b", 0.02),
               ("q_w", (d, d), "w", d ** -0.5), ("q_b", (d,), "b", 0.02),
               ("k_w", (d, d), "w", d ** -0.5),
               ("v_w", (d, d), "w", d ** -0.5), ("v_b", (d,), "b", 0.02),
               ("o_w", (d, d), "w", d ** -0.5), ("o_b", (d,), "b", 0.02),
               ("ln2_g", (d,), "g", 0.05), ("ln2_b", (d,), "b", 0.02),
               ("fc1_w", (d, f), "w", d ** -0.5), ("fc1_b", (f,), "b", 0.02),
               ("fc2_w", (f, d), "w", f ** -0.5), ("fc2_b", (d,), "b", 0.02)]
        if cross:
            blk += [("lnx_g", (d,), "g", 0.05), ("lnx_b", (d,), "b", 0.02),
                    ("xq_w", (d, d), "w", d ** -0.5),
                    ("xq_b", (d,), "b", 0.02),
                    ("xk_w", (d, d), "w", d ** -0.5),
                    ("xv_w", (d, d), "w", d ** -0.5),
                    ("xv_b", (d,), "b", 0.02),
                    ("xo_w", (d, d), "w", d ** -0.5),
                    ("xo_b", (d,), "b", 0.02)]
        out += [((part, "blocks", k), (n, *s), kind, sc)
                for k, s, kind, sc in blk]
    return out


def make_tree(c: dict, seed: int, eot: int, device,
              dtype=torch.bfloat16) -> Dict:
    """The weight tree for the model file ``c`` (HF-style keys), made on
    ``device`` from ``seed``."""
    leaves = _leaves(c)
    total = sum(math.prod(s) for _, s, _, _ in leaves) + c["d_model"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    buf = torch.randn(total, generator=gen, device=device, dtype=dtype)
    tree: Dict = {"encoder": {"blocks": {}}, "decoder": {"blocks": {}}}
    at = 0
    for path, shape, kind, scale in leaves:
        n = math.prod(shape)
        t = buf[at:at + n].view(shape)
        at += n
        t.mul_(scale)
        if kind == "g":
            t.add_(1.0)
        node = tree
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = t
    d = c["d_model"]
    u = buf[at:at + d].float()
    u = u / u.norm()
    dec = tree["decoder"]
    dec["ln_b"].add_((EOT_BIAS * u).to(dtype))
    dec["tok_emb"][eot] = (-EOT_NORM * u).to(dtype)
    tree["encoder"]["pos"] = torch.from_numpy(
        sinusoids(c["max_source_positions"], d)).to(device=device,
                                                    dtype=dtype)
    # each leaf its own storage, so that the engine can free the float
    # weights it quantizes
    return _clone(tree)


def _clone(node):
    if isinstance(node, dict):
        return {k: _clone(v) for k, v in node.items()}
    return node.clone()
