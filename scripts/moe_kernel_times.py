"""The expert kernels' times at a Uni-MoE-2.0-Omni layer's published
widths (``ops/moe.py``), for the kernel table of ``PERF.md``: a decode
batch (32 tokens) and a prefill (11,136 tokens, 32 rows of ~348 real
tokens), routed (4 experts of 18,944 by a random f32 gate, top-p 0.7
capped at 2) and shared (2 of 2,368). For each: the kernels' device ms
(captured in a CUDA graph and replayed, ``utils/profiling.py::graph_ms``),
their least time at the published peaks
(``benchmark/ops/moe_arith.py::expert_least_s``), and the plain version's
ms on the card. One JSON line. Run on the card from the repo root:

    python scripts/moe_kernel_times.py
"""

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark.ops import moe_arith  # noqa: E402
from nobs_whisper_torch.ops import moe  # noqa: E402
from nobs_whisper_torch.utils.profiling import cuda_ms, graph_ms  # noqa: E402

D, F, FS = 3584, 18944, 2368
MODEL = {"hidden_size": D, "dynamic_intermediate_size": F,
         "shared_intermediate_size": FS, "mlp_fixed_expert_num": 2,
         "mlp_dynamic_expert_num": 4}


def main():
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    w13 = (torch.randn((4, D, 2 * F), generator=g, device=dev)
           * D ** -0.5).to(torch.bfloat16)
    w2 = (torch.randn((4, F, D), generator=g, device=dev)
          * F ** -0.5).to(torch.bfloat16)
    s13 = (torch.randn((2, D, 2 * FS), generator=g, device=dev)
           * D ** -0.5).to(torch.bfloat16)
    s2 = (torch.randn((2, FS, D), generator=g, device=dev)
          * FS ** -0.5).to(torch.bfloat16)
    gate = torch.randn((D, 5), generator=g, device=dev) * D ** -0.5
    out = {"card": torch.cuda.get_device_name(0),
           "power_limit": subprocess.run(
               ["nvidia-smi", "--query-gpu=power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip()}
    for name, t in (("decode", 32), ("prefill", 11136)):
        x = torch.randn((t, D), generator=g, device=dev).to(torch.bfloat16)
        ids, w = moe.route(x, gate, 0.7, 2, 4)
        sid = torch.arange(2, device=dev).expand(t, 2)
        sw = torch.ones((t, 2), device=dev)
        rows = torch.bincount(ids[ids >= 0], minlength=5)[:4].tolist()
        routed = lambda: moe.expert_ffn(x, ids, w, w13, w2)
        shared = lambda: moe.expert_ffn(x, sid, sw, s13, s2)
        both = lambda: (routed(), shared())
        pl = moe.plan(ids, 4, moe.BM)
        plain = lambda: moe.expert_ffn_plain(x, pl, w, w13, w2, 2)
        out[name] = {
            "tokens": t, "rows": rows,
            "routed_ms": graph_ms(routed, reps=20),
            "shared_ms": graph_ms(shared, reps=20),
            "ms": graph_ms(both, reps=20),
            "bound_ms": 1e3 * moe_arith.expert_least_s(MODEL, t, rows),
            "plain_ms": cuda_ms(plain, reps=3, warmup=1)}
        print(json.dumps({name: out[name]}), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
