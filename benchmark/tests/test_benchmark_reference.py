"""The plain reference against the program's own pieces on the CPU, and
the comparison that decides ``correct`` against its control and the
faults a serving cell can have."""

import numpy as np
import pytest
import torch

from benchmark.audio import speech_like_audio
from benchmark.reference import rules
from benchmark.reference.tokens import (Encoder, byte_level_vocab, layout,
                                        prompt_tokens)
from benchmark.reference.whisper import log_mel
from benchmark.traffic import _Prompts

import tiny


@pytest.fixture(scope="module")
def vocab():
    lay = layout(51866)
    return lay, byte_level_vocab(lay)


@pytest.fixture(scope="module")
def program(vocab):
    from nobs_whisper_torch.core.config import get_config
    from nobs_whisper_torch.core.tokenizer import WhisperTokenizer
    cfg = get_config("large-v3-turbo")
    return cfg, WhisperTokenizer(vocab[1], cfg)


def test_layout_is_the_programs(vocab, program):
    lay, (cfg, _) = vocab[0], program
    for k in ("eot", "sot", "lang_base", "translate", "transcribe", "sot_lm",
              "sot_prev", "no_speech", "no_timestamps", "timestamp_begin"):
        assert getattr(lay, k) == getattr(cfg, k), k


def test_encoder_and_prompt_match_the_programs(vocab, program):
    lay, v = vocab
    cfg, tok = program
    enc = Encoder(v, lay.eot)
    p = _Prompts(np.random.default_rng(4), enc)
    for n in (0, 1, 7, 30, 120, 250):
        voc, ctx = p.make(n // 3), p.make(n)
        assert enc.encode(" " + ctx) == tok.encode(" " + ctx) if ctx else True
        initial = tok.encode(" " + " ".join(x for x in (voc, ctx) if x)) \
            if (voc or ctx) else []
        want = ([cfg.sot_prev] + initial[-223:] if initial else []) \
            + tok.sot_sequence(language="en", task="transcribe")
        assert prompt_tokens(enc, lay, voc, ctx) == want


@pytest.mark.parametrize("seconds", [1.0, 6.3, 25.0])
def test_mel_matches_the_programs_framed_path(seconds):
    from nobs_whisper_torch.audio.mel import (frame_window_np,
                                              log_mel_from_frames)
    audio = speech_like_audio(seconds, seed=9)
    frames = torch.from_numpy(frame_window_np(audio, 3000))[None]
    got = log_mel_from_frames(frames, n_mels=128, n_frames=3000)[0].numpy()
    assert np.abs(got - log_mel(audio, 128)).max() < 2e-3


def test_rules_choose_as_the_program(vocab, program):
    """Greedy steps under random logits: the reference's choice equals
    the program's argmax over its masked logits at every step."""
    from nobs_whisper_torch.decode.rules import (DecodeOptions,
                                                 apply_logit_rules_scored,
                                                 build_rule_tables)
    lay = vocab[0]
    cfg, tok = program
    tables = build_rule_tables(cfg, DecodeOptions(), tok)
    rng = np.random.default_rng(0)
    for row in range(6):
        hist = []
        for step in range(40):
            lg = rng.standard_normal(lay.n_vocab).astype(np.float32)
            lg[lay.timestamp_begin:] += (row - 2) * 0.8   # more ts, or fewer
            tb = lay.timestamp_begin
            ts = [t for t in hist if t >= tb]
            masked, _, _ = apply_logit_rules_scored(
                torch.from_numpy(lg)[None], tables,
                n_sampled=torch.tensor([len(hist)]),
                last_token=torch.tensor([hist[-1] if hist else 0]),
                penult_token=torch.tensor([hist[-2] if len(hist) > 1 else 0]),
                max_ts_token=torch.tensor([max(ts) if ts else tb - 1]))
            want = int(torch.argmax(masked[0]))
            ok = rules.allowed(hist, lay)
            assert rules.choose(lg.astype(np.float64), ok, tb) == want
            assert rules.gap(lg.astype(np.float64), ok, want, tb) == 0.0
            hist.append(want)


def test_gap_of_a_forbidden_or_worse_token(vocab):
    lay = vocab[0]
    lg = np.zeros(lay.n_vocab)
    lg[lay.timestamp_begin:] = -10.0   # the timestamps' mass stays below
    lg[100], lg[200] = 3.0, 1.0
    ok = rules.allowed([lay.timestamp_begin, 100], lay)   # ts, text
    assert rules.gap(lg, ok, 100, lay.timestamp_begin) == 0.0
    assert rules.gap(lg, ok, 200, lay.timestamp_begin) == pytest.approx(2.0)
    assert rules.gap(lg, ok, lay.sot, lay.timestamp_begin) == np.inf


# ------------------------------------------------------ whole runs ---

@pytest.fixture(scope="module")
def sound():
    """A tiny serving run on the CPU, the control judged beside it."""
    c = tiny.cell("v3-chunks", check_requests=8)
    return c, tiny.run(c, 2**31 + 101, control_bits=4)


def test_a_sound_run_is_correct(sound):
    c, out = sound
    assert out["correct"], out["checks"]
    assert out["detail"]["widest_gap"] < c.limits["widest_gap"] / 3


def test_the_control_is_not_correct(sound):
    """The reference at int4 in the program's place reads past the
    limit."""
    c, out = sound
    assert out["detail"]["control_widest_gap"] > c.limits["widest_gap"]


def _faulty(monkeypatch, fault):
    from nobs_whisper_torch.decode import greedy
    if fault == "state_unchanged":
        orig = greedy.decoder_forward
        first = {}

        def fwd(params, tokens, cache_start, *a, **k):
            logits, cache = orig(params, tokens, cache_start, *a, **k)
            if tokens.shape[1] == 1:       # a step returns the prefill's
                return first["logits"], cache
            first["logits"] = logits[:, -1:]
            return logits, cache
        monkeypatch.setattr(greedy, "decoder_forward", fwd)
        return
    orig_fin = greedy.decode_window_finalize

    def fin(handle):
        out = orig_fin(handle)
        if fault == "half_the_batch":      # rows past half get row 0's
            for r in out[(len(out) + 1) // 2:]:
                r.tokens = list(out[0].tokens)
        elif fault == "token_altered":     # one token of each row
            for r in out:
                r.tokens[len(r.tokens) // 2] += 1
        return out
    monkeypatch.setattr(greedy, "decode_window_finalize", fin)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch",
                                   "token_altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    c = tiny.cell("v3-chunks", check_requests=8)
    _faulty(monkeypatch, fault)
    out = tiny.run(c, 2**31 + 202)
    assert not out["correct"], out["checks"]
