"""The Uni-MoE family: a speech LM whose model file holds the language
model's published ``config.json`` keys (``hidden_size``,
``mlp_dynamic_*``, ...), ``endoftext`` and ``tower`` (the Whisper
encoder's keys), served by the program's ``UniMoEEngine`` (tower int8,
language model bf16) and judged by ``reference/uni_moe.py``. The
functions are the interface ``harness.py`` lists.

Weights are made on the card from the seed, one generator a tensor name
(:func:`_gen`), so that the judge makes one layer again on its own: every
matrix normal x (its input width) ** -0.5, the embedding's input a one-hot
row (scale 1), norms 1 + 0.05 normal, biases 0.02 normal; the tower's
leaves as ``benchmark/weights.py`` draws Whisper's. The head's columns of
the two stop ids are zero, so that their logit is 0 while the best of
152,064 others is near +4: every request decodes its whole
``sample_len``. The gate is drawn as every matrix is; the routing it gives
is reported, not chosen.

The judgement (:func:`judge`) has two parts, both over each sampled
request's prompt and served tokens, teacher-forced:

(a) The decisions. The program's routing of each sampled request is found
    on its tracer (``GLOBAL_PROFILER.routing_records``) by its prompt and
    served tokens; the pool repeats chunks, so every matching record is
    judged. The reference routes each token of each layer itself; a
    decision whose margin to a boundary exceeds ``DELTA`` must equal the
    program's. ``DELTA`` bounds the gate's probability error from the
    program's bf16 activations: the gate (f32) reads RMSNorm(x) rounded to
    bf16 after up to 28 layers of bf16 products, whose rounding a random
    deep stack carries forward, so the bound is read off the card at the
    published widths. Over 1.78 M decisions of 13 sound runs on one H100
    (the judge reports them by margin, ``routing_by_margin``) the share
    that differ from the f32 reference's falls exponentially with the
    margin, halving every 0.0021 (fitted over 0.01-0.1; the widest that
    differed lay 0.0268 from a boundary). At 0.07 that tail leaves under
    5e-4 expected mismatches in 1e8 judged decisions (some 30 checks of
    14 runs each), at the slow end of the fit's 95% interval too; at
    0.05 it would leave 0.08-0.2.
(b) The logits. The reference takes the program's decisions and computes
    its logits in f32; each served token's gap is the best logit less the
    served token's. A mismatch outside the ties, or a sampled request
    whose routing is not found, makes ``widest_gap`` infinite, so
    ``correct`` is false.

The control is the reference with the language model's matrices at
``control_bits`` bits per output channel and its own routing; the tokens
it chooses are judged under (b)'s logits.
"""

from __future__ import annotations

import functools
import math
import zlib
from typing import Dict, List, Optional

import numpy as np

from benchmark.ops import moe_arith
from benchmark.reference import uni_moe as ref
from benchmark.reference.tokens import Encoder, Layout, byte_level_vocab

DELTA = 0.07
BLOCK = 4
# the judged decisions and those that differ, by margin, in bins of
# MARGIN_BIN up to MARGIN_TOP (DELTA's reading: PERF.md)
MARGIN_BIN, MARGIN_TOP = 0.0025, 0.1


@functools.lru_cache(maxsize=2)
def _vocab(n_vocab: int, endoftext: int):
    lay = Layout(n_vocab=n_vocab, eot=endoftext, sot=n_vocab, lang_base=0,
                 n_langs=0, translate=n_vocab, transcribe=n_vocab,
                 sot_lm=n_vocab, sot_prev=n_vocab, no_speech=n_vocab,
                 no_timestamps=n_vocab, timestamp_begin=n_vocab)
    vocab = byte_level_vocab(lay)
    for name, i in ref.special_ids({"endoftext": endoftext}).items():
        vocab[i] = f"<|{name}|>".encode()
    return vocab, Encoder(vocab, endoftext)


def vocabulary(model: dict):
    vocab, enc = _vocab(model["vocab_size"], model["endoftext"])
    return ref.special_ids(model), list(vocab), enc


def _gen(seed: int, name: str, device):
    import torch
    key = (int(seed) * 1_000_003 + zlib.crc32(name.encode())) % 2 ** 63
    return torch.Generator(device=device).manual_seed(key)


def _draw(seed, name, shape, kind, scale, device, dtype):
    """kind "w" normal * scale, "g" 1 + normal * scale, "b" normal *
    scale, from the tensor's own generator."""
    import torch
    t = torch.randn(shape, generator=_gen(seed, name, device), device=device,
                    dtype=dtype)
    t.mul_(scale)
    if kind == "g":
        t.add_(1.0)
    return t


def _tower_keys(model: dict) -> dict:
    t = model["tower"]
    return dict(t, decoder_layers=0, decoder_ffn_dim=t["encoder_ffn_dim"],
                vocab_size=model["vocab_size"], max_target_positions=1)


def base_tree(model: dict, seed: int, device, dtype=None) -> Dict:
    """Everything but the layers: the tower (Whisper's stacked encoder
    leaves), the connector, the embedding, the final norm, the head."""
    import torch

    from benchmark.weights import _leaves, sinusoids
    dtype = dtype or torch.bfloat16
    t, d, v = model["tower"], model["hidden_size"], model["vocab_size"]
    enc: Dict = {"blocks": {}}
    for path, shape, kind, scale in _leaves(_tower_keys(model)):
        if path[0] != "encoder":
            continue
        node = enc["blocks"] if path[1] == "blocks" else enc
        node[path[-1]] = _draw(seed, ".".join(path), shape, kind, scale,
                               device, dtype)
    enc["pos"] = torch.from_numpy(sinusoids(t["max_source_positions"],
                                            t["d_model"])).to(device, dtype)
    head = _draw(seed, "head", (d, v), "w", d ** -0.5, device, dtype)
    head[:, [model["endoftext"], ref.special_ids(model)["im_end"]]] = 0
    return {"encoder": enc,
            "connector": {"w": _draw(seed, "connector.w", (t["d_model"], d),
                                     "w", t["d_model"] ** -0.5, device,
                                     dtype),
                          "b": _draw(seed, "connector.b", (d,), "b", 0.02,
                                     device, dtype)},
            "embed": _draw(seed, "embed", (v, d), "w", 1.0, device, dtype),
            "norm": _draw(seed, "norm", (d,), "g", 0.05, device, dtype),
            "head": head}


def layer(model: dict, seed: int, i: int, device, dtype=None) -> Dict:
    """Layer i's weights, made again from the seed alone."""
    import torch
    dtype = dtype or torch.bfloat16
    d, h = model["hidden_size"], model["num_attention_heads"]
    hd = d // h
    kv = model["num_key_value_heads"] * hd
    r, f = model["mlp_dynamic_expert_num"], model["dynamic_intermediate_size"]
    s, fs = model["mlp_fixed_expert_num"], model["shared_intermediate_size"]
    e = r + model["mlp_dynamic_null_expert_num"]
    spec = {"ln1": ((d,), "g", 0.05), "q_w": ((d, h * hd), "w", d ** -0.5),
            "q_b": ((h * hd,), "b", 0.02), "k_w": ((d, kv), "w", d ** -0.5),
            "k_b": ((kv,), "b", 0.02), "v_w": ((d, kv), "w", d ** -0.5),
            "v_b": ((kv,), "b", 0.02),
            "o_w": ((h * hd, d), "w", (h * hd) ** -0.5),
            "ln2": ((d,), "g", 0.05), "gate": ((d, e), "w", d ** -0.5),
            "w13": ((r, d, 2 * f), "w", d ** -0.5),
            "w2": ((r, f, d), "w", f ** -0.5),
            "s13": ((s, d, 2 * fs), "w", d ** -0.5),
            "s2": ((s, fs, d), "w", fs ** -0.5)}
    out = {k: _draw(seed, f"layers.{i}.{k}", shape, kind, scale, device,
                    dtype) for k, (shape, kind, scale) in spec.items()}
    out["gate"] = out["gate"].float()
    return out


def _dtype(model: dict):
    import torch
    return getattr(torch, model["serving"]["compute_dtype"])


def build_engine(cell, seed: int, vocab: List[bytes], device):
    """The program's engine on the benchmark's weights, made on the card
    from ``seed``, its tower quantized by the program."""
    import torch
    from nobs_whisper_torch.api import UniMoEEngine
    from nobs_whisper_torch.core.config import uni_moe_config_from_hparams
    from nobs_whisper_torch.core.tokenizer import UniMoETokenizer
    m = cell.model
    cfg = uni_moe_config_from_hparams(m)
    dtype = _dtype(m)
    params = base_tree(m, seed, device, dtype)
    params["layers"] = [layer(m, seed, i, device, dtype)
                        for i in range(m["num_hidden_layers"])]
    return UniMoEEngine(params=params, cfg=cfg,
                        tokenizer=UniMoETokenizer(vocab, cfg),
                        compute_dtype=dtype,
                        device=torch.device(device)).quantize()


def _program_routing(sample: List[dict]):
    """For each sampled request, the routing of every kept record with
    its prompt and served tokens."""
    from nobs_whisper_torch.utils.profiling import GLOBAL_PROFILER
    kept = GLOBAL_PROFILER.routing_records()
    return [[rt for p, s, rt in kept if p == tuple(r["prompt"] or ())
             and s == tuple(r["served"])] for r in sample]


def _decisions(ids: np.ndarray) -> np.ndarray:
    """(layers, S, K) ids -> (layers, S) frozensets of the experts taken."""
    out = np.empty(ids.shape[:2], object)
    for i in np.ndindex(*ids.shape[:2]):
        out[i] = frozenset(int(e) for e in ids[i] if e >= 0)
    return out


def judge(cell, sample: List[dict], seed: int, device,
          control_bits: Optional[int] = None,
          routing: Optional[List[list]] = None) -> Dict:
    """``sample``: dicts with ``audio``, ``vocabulary``, ``context``,
    ``prompt`` (the program's prompt ids, compared exactly) and ``served``.
    ``routing``: each request's program routings (default: found on the
    program's tracer). Returns the widest gap (infinite with a routing
    mismatch outside the ties, or a request whose routing is missing),
    the prompts that differ, the routing counts, and with
    ``control_bits`` the control's widest gap."""
    import torch
    m = cell.model
    _, _, enc = vocabulary(m)
    tree = base_tree(m, seed, device, _dtype(m))
    lay = lambda i: layer(m, seed, i, device, _dtype(m))
    sound = ref.Reference(tree, m, lay)
    mels = [ref.log_mel(r["audio"], m["tower"]["num_mel_bins"])
            for r in sample]
    audio = []
    for i in range(0, len(mels), BLOCK):
        x = torch.from_numpy(np.stack(mels[i:i + BLOCK])).to(device)
        audio.extend(sound.audio(sound.encode(x)))
    routing = _program_routing(sample) if routing is None else routing
    bad_prompts, missing, rows, owner = 0, 0, [], []
    for i, r in enumerate(sample):
        prompt = ref.prompt_ids(enc.encode, m, r["vocabulary"], r["context"])
        if r.get("prompt") is not None and list(r["prompt"]) != prompt:
            bad_prompts += 1
        served = list(r["served"])
        if not served:
            continue
        if not routing[i]:
            missing += 1
        for rt in routing[i]:
            rows.append(dict(tokens=prompt + served[:-1], audio=audio[i],
                             lo=len(prompt) - 1, decisions=rt))
            owner.append(i)
    got = sound.run(rows)
    widest, gaps = 0.0, []
    mismatches = ties = decisions = 0
    widest_tie = 0.0
    edges = np.linspace(0.0, MARGIN_TOP, round(MARGIN_TOP / MARGIN_BIN) + 1)
    by_margin = np.zeros(len(edges) - 1, np.int64)
    differ_by_margin = np.zeros_like(by_margin)
    for row, g, i in zip(rows, got, owner):
        served = list(sample[i]["served"])
        lg = g["logits"].double().cpu().numpy()
        row_gaps = lg.max(1) - lg[np.arange(len(served)), served]
        gaps.append(float(row_gaps.max()))
        widest = max(widest, gaps[-1])
        differ = _decisions(row["decisions"]) != _decisions(g["ids"])
        near = g["margin"] <= DELTA
        mismatches += int((differ & ~near).sum())
        ties += int(near.sum())
        decisions += near.size
        by_margin += np.histogram(g["margin"], edges)[0]
        differ_by_margin += np.histogram(g["margin"][differ], edges)[0]
        if differ.any():
            widest_tie = max(widest_tie, float(g["margin"][differ].max()))
    out = {"widest_gap": math.inf if mismatches or missing else widest,
           "prompts_differ": bad_prompts, "row_gaps": gaps,
           "tokens_judged": sum(len(r["served"]) for r in sample),
           "routing_mismatches": mismatches, "routing_missing": missing,
           "routing_ties": ties, "routing_decisions": decisions,
           "routing_widest_differing_margin": widest_tie,
           "routing_by_margin": by_margin.tolist(),
           "routing_differing_by_margin": differ_by_margin.tolist(),
           "gap_before_routing": widest}
    if control_bits is not None:
        ctl = ref.Reference(tree, m, lay, bits=control_bits)
        cg = ctl.run([dict(row, decisions=None) for row in rows])
        widest_ctl = 0.0
        for g, c in zip(got, cg):
            lg = g["logits"].double().cpu().numpy()
            pick = c["logits"].argmax(1).cpu().numpy()
            widest_ctl = max(widest_ctl, float(
                (lg.max(1) - lg[np.arange(len(pick)), pick]).max()))
        out["control_widest_gap"] = widest_ctl
    return out


def batch_least_s(model: dict, prompt_lens, steps: int) -> float:
    """The tower, the prefill and ``steps`` - 1 decoded tokens at the
    published peaks, the routed experts counted at the cap of 2 slots a
    token (``ops/moe_arith.py::batch_least_s``)."""
    return moe_arith.batch_least_s(model, prompt_lens, steps)


def encoder_blocks(model: dict):
    t = model["tower"]
    return t["d_model"], t["encoder_ffn_dim"], t["encoder_layers"]
