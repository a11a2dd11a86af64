"""On the card (marked ``gpu``; it skips without one): the expert kernels
(``ops/moe.py``) against their plain version at the published widths of
one Uni-MoE-2.0-Omni layer (d 3584, routed experts of 18,944, shared of
2,368), at a decode batch (32 tokens) and at the ``unimoe-chunks`` cell's
prefill (11,136 tokens), and at the tiny engine's widths (d 448, experts
of 256 and 64: partial tiles); and a
speech LM's window decoded with its step captured as a CUDA graph against
the same window decoded eagerly: the graph replays the eager step's
kernels on the same inputs, so tokens and routing are equal.

Tolerance of the kernels: both sum bf16 products in f32 and round h to
bf16; the kernels sum in another order (f32 rounding, ~1e-6 of a sum), so
an element of h may round to the neighbouring bf16 value (2^-8 of it): a
few elements of a row's F. A flip moves an output by 2^-8 |h w|, up to
~1e-3 of the outputs' scale where h is among the largest of a prefill's
2e8 (measured on an H100: 1.04e-3 at 11,136 tokens). 4e-3 of the largest
output leaves that fourfold room and still fails a tile whose rows,
columns or expert are wrong, which is off by the scale itself.

This file imports neither JAX nor the JAX package; from the repo root:

    python -m pytest -p no:cacheprovider --noconftest -m gpu \
        tests/test_torch_uni_moe_gpu.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu
D, F_ROUTED, F_SHARED = 3584, 18944, 2368


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _weights(g, n, d, f, dev):
    w13 = (torch.randn((n, d, 2 * f), generator=g, device=dev)
           * d ** -0.5).to(torch.bfloat16)
    w2 = (torch.randn((n, f, d), generator=g, device=dev)
          * f ** -0.5).to(torch.bfloat16)
    return w13, w2


@pytest.mark.parametrize("tokens,d,f_routed,f_shared", [
    (32, D, F_ROUTED, F_SHARED), (11136, D, F_ROUTED, F_SHARED),
    (40, 448, 256, 64)])
def test_expert_kernels_at_published_widths(card, tokens, d, f_routed,
                                            f_shared):
    from nobs_whisper_torch.ops import moe
    g = torch.Generator(device=card).manual_seed(tokens)
    x = torch.randn((tokens, d), generator=g, device=card).to(torch.bfloat16)
    gate = torch.randn((d, 5), generator=g, device=card) * d ** -0.5
    ids, w = moe.route(x, gate, 0.7, 2, 4)
    for n, f, ids_, w_ in (
            (4, f_routed, ids, w),
            (2, f_shared, torch.arange(2, device=card).expand(tokens, 2),
             torch.ones((tokens, 2), device=card))):
        w13, w2 = _weights(g, n, d, f, card)
        before = moe.moe_launch_count
        got = moe.expert_ffn(x, ids_, w_, w13, w2)
        assert moe.moe_launch_count == before + 2
        pl = moe.plan(ids_, n, moe.BM)
        want = moe.expert_ffn_plain(x, pl, w_, w13, w2, 2).view(
            tokens, 2, d).sum(1)
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 4e-3 * scale
        assert torch.equal(got, moe.expert_ffn(x, ids_, w_, w13, w2))


def _tiny(card):
    from nobs_whisper_torch.api import UniMoEEngine
    from nobs_whisper_torch.core.config import uni_moe_config_from_hparams
    from nobs_whisper_torch.core.tokenizer import UniMoETokenizer
    from nobs_whisper_torch.models.uni_moe import init_params
    cfg = uni_moe_config_from_hparams(dict(
        name="tiny-unimoe", hidden_size=448, num_attention_heads=7,
        num_key_value_heads=1, num_hidden_layers=2, vocab_size=1024,
        mlp_dynamic_expert_num=4, mlp_dynamic_null_expert_num=1,
        dynamic_intermediate_size=256, mlp_fixed_expert_num=2,
        shared_intermediate_size=64, mlp_dynamic_top_p=0.7,
        mlp_dynamic_top_k=2, rope_theta=1e6, rms_norm_eps=1e-6,
        whisper_query_tokens_size=200, endoftext=1000,
        tower=dict(d_model=384, encoder_layers=4, encoder_attention_heads=6,
                   encoder_ffn_dim=1536, num_mel_bins=80,
                   max_source_positions=1500)))
    vocab = [bytes([i]) for i in range(256)] + [
        b"w%d" % i for i in range(256, 1000)]
    return UniMoEEngine(
        params=init_params(3, cfg, dtype=torch.bfloat16, device=card),
        cfg=cfg, tokenizer=UniMoETokenizer(vocab, cfg),
        compute_dtype=torch.bfloat16, device=card).quantize()


def test_captured_step_replays_the_eager_step(card):
    from nobs_whisper_torch.audio.mel import frame_window_np
    from nobs_whisper_torch.decode.greedy import pad_prompts
    from nobs_whisper_torch.models import uni_moe
    from nobs_whisper_torch.ops import moe
    eng = _tiny(card)
    cfg = eng.cfg
    rng = np.random.RandomState(0)
    frames = torch.stack([torch.from_numpy(frame_window_np(
        rng.randn(16000 * s).astype(np.float32) * 0.1, n_frames=3000))
        for s in (4, 9, 2)]).to(card)
    prompts = [eng.tokenizer.window_prompt("", ctx) for ctx in
               ("", "hello there", "the quick brown fox jumps over")]
    toks, pads = pad_prompts(prompts, cfg.eot)
    args = (eng.params, frames,
            torch.as_tensor(toks, dtype=torch.long, device=card),
            torch.as_tensor(pads, dtype=torch.long, device=card), cfg, 24,
            torch.bfloat16)
    eager = uni_moe.window_impl(*args, cuda_graph=False)
    before = moe.moe_launch_count
    graph = uni_moe.window_impl(*args, cuda_graph=True)
    torch.cuda.synchronize()
    assert moe.moe_launch_count - before >= 2 * 2 * 2 * 24
    tokens, n_sampled, sum_lp, _, routing = eager
    assert torch.equal(tokens, graph[0]) and torch.equal(n_sampled, graph[1])
    assert torch.equal(routing, graph[4])
    torch.testing.assert_close(sum_lp, graph[2], rtol=1e-5, atol=0)
