#!/usr/bin/env python3
"""Where a decode step's device time goes, by PyTorch op and kernel, on
one NVIDIA card: an int8 Whisper decoder at bf16 compute (random weights
from a seed), a batch of ``--rows`` rows whose prompts fill ``--prompt``
tokens, the packed cross-KV of random encoder states, as the greedy
window program lays them out (``decode/greedy.py::window_cross_kv``).
After the prefill, ``--steps`` single-token ``decoder_forward`` calls run
eagerly under ``torch.profiler``; each kernel is put down to the op that
launched it (the profiler's CPU op with its input shapes).

Printed: the card; for each route of the int8 linears (``--routes``:
``default``, the gate as it stands, and ``dequant``, with
``NWT_Q8_KERNEL_MIN_BYTES`` past every weight, the route before K6 served
the step) the step's device ms, its kernel launches, then the rows
(op, input shapes, kernel) by device ms a step, the largest first, and
the same by kernel name alone.

Run from the repo root on a machine with a card and ``nvcc``:
``python3 scripts/torch_step_ops.py [--model large-v3] [--rows 32]
[--prompt 160] [--steps 4] [--top 30]``. Imports nothing of JAX.
"""

import argparse
import collections
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def profile_steps(eng, rows, prompt, steps, seed=0):
    """{(op, shapes, kernel): [device us, launches]} over ``steps`` decode
    steps, and the steps' device ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from nobs_whisper_torch.decode.greedy import window_cross_kv
    from nobs_whisper_torch.models.whisper import (decoder_forward,
                                                   init_kv_cache)
    cfg, dev = eng.cfg, eng.device
    g = torch.Generator(device=dev).manual_seed(seed)
    xa = torch.randn(rows, cfg.n_audio_ctx, cfg.n_audio_state, generator=g,
                     device=dev).to(torch.bfloat16)
    cross = window_cross_kv(eng.params, xa, cfg, False, True)
    t_cache = -(-(prompt + steps + 1) // 8) * 8
    cache = init_kv_cache(cfg, rows, dtype=torch.bfloat16, t_ctx=t_cache,
                          device=dev)
    pads = torch.zeros(rows, dtype=torch.long, device=dev)
    tokens = torch.randint(0, cfg.eot, (rows, prompt), generator=g,
                           device=dev)

    def fwd(tok, start):
        return decoder_forward(eng.params, tok, start, pads, cache, cross,
                               cfg, torch.bfloat16)[0]

    logits = fwd(tokens, 0)
    nxt = logits[:, -1].argmax(-1, keepdim=True)
    fwd(nxt, prompt)                       # the step's shapes warmed
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for i in range(steps):
            nxt = fwd(nxt, prompt + 1 + i)[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
    rows_ = collections.defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type != DeviceType.CPU or not ev.kernels:
            continue
        # a kernel is listed under the op whose launch it was
        shapes = str([tuple(s) for s in ev.input_shapes if s])[:80]
        for k in ev.kernels:
            key = (ev.name, shapes, k.name[:90])
            rows_[key][0] += k.duration
            rows_[key][1] += 1
    device = sum(ev.time_range.elapsed_us() for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA)
    return rows_, device / 1e3 / steps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="large-v3")
    ap.add_argument("--rows", type=int, default=32)
    ap.add_argument("--prompt", type=int, default=160)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--routes", default="default,dequant")
    args = ap.parse_args()
    import torch
    from nobs_whisper_torch.api import WhisperEngine
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    eng = WhisperEngine.from_random(args.model, dtype=torch.bfloat16,
                                    seed=0, device="cuda").quantize()
    for route in args.routes.split(","):
        if route == "dequant":
            os.environ["NWT_Q8_KERNEL_MIN_BYTES"] = str(1 << 62)
        else:
            os.environ.pop("NWT_Q8_KERNEL_MIN_BYTES", None)
        rows, step_ms = profile_steps(eng, args.rows, args.prompt,
                                      args.steps)
        launches = sum(v[1] for v in rows.values()) / args.steps
        owned = sum(v[0] for v in rows.values()) / 1e3 / args.steps
        print(f"[step] {args.model} route {route}: B={args.rows}, prompt "
              f"{args.prompt}: {step_ms:.3f} device ms a step ({owned:.3f} "
              f"put down to an op) in {launches:.0f} kernels", flush=True)
        for (op, shapes, kern), (us, n) in sorted(
                rows.items(), key=lambda kv: -kv[1][0])[:args.top]:
            print(f"[op] {route}: {us / 1e3 / args.steps:.4f} ms a step, "
                  f"{n / args.steps:g} launches: {op} {shapes} -> {kern}",
                  flush=True)
        by_kernel = collections.defaultdict(lambda: [0.0, 0])
        for (_, _, kern), (us, n) in rows.items():
            by_kernel[kern[:60]][0] += us
            by_kernel[kern[:60]][1] += n
        for kern, (us, n) in sorted(by_kernel.items(),
                                    key=lambda kv: -kv[1][0])[:15]:
            print(f"[kernel] {route}: {us / 1e3 / args.steps:.4f} ms a step, "
                  f"{n / args.steps:g} launches: {kern}", flush=True)


if __name__ == "__main__":
    main()
