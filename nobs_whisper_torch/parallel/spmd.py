"""dp-sharded serving programs (port of ``parallel/spmd.py``).

The reference runs the complete single-chip program per shard with
``jax.shard_map`` over a dp-only mesh, with its Pallas kernels
re-enabled inside the shard body. Here each dp shard runs the port's
single-device implementation (``decode_window_impl``,
``frames_encode_decode_window_impl``, the speculative implementations,
``frames_encode_detect_impl``, ``frames_encode_impl``) on its contiguous
slice of the batch rows, with its own parameter replica, on its own
device. The kernel gates inside are exactly those of one card
(``models/whisper.py``: ``x.is_cuda``), so K1, K2 and, under their knobs,
K4-K6 launch in every shard.

The port's decode loop syncs with the host at each early-exit check, so
shards on two cards overlap only if each runs in a host thread of its
own: :func:`run_on_mesh` starts one thread a mesh position, and each
thread enters its device's context (``torch.cuda.device``) before its
first launch, because the kernels launch on the current device's current
stream. Kernel libraries build and load under ``ops/_build.py``'s lock,
so two threads never build one library at once.

A mesh with tp > 1 runs the same shard bodies, each dp group over its tp
ranks (``parallel/tp.py``), with the kernels off as under the reference's
GSPMD path; ``NWT_NO_SPMD`` turns the kernels off on a dp-only mesh too,
the reference's pure-GSPMD opt-out. A shard that raises fails the whole
call with its exception (the batcher then fails the batch's rows), as a
single-device batch does.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from .mesh import Mesh, ShardedParams, batch_shards, gather_batch, \
    shard_params
from .tp import ShardContext, TPGroup, shard_context


def spmd_serving_enabled(mesh: Optional[Mesh]) -> bool:
    """The per-shard serving path (kernels on in every shard) applies to
    dp-only meshes (tp == 1); ``NWT_NO_SPMD=1`` opts back into the plain
    path, the reference's pure GSPMD."""
    return (mesh is not None
            and mesh.shape.get("tp", 1) == 1
            and not os.environ.get("NWT_NO_SPMD"))


def _device_ctx(dev: torch.device):
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _to(x, dev: torch.device):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return x


def run_threads(jobs: Sequence[Tuple[str, torch.device, Callable[[], Any],
                                     Optional[TPGroup]]]) -> List[Any]:
    """Run each job ``(name, device, fn, group)``'s ``fn()`` in a host
    thread of its own named ``name``, under its device's context and the
    caller's grad mode (grad mode is per thread), and wait for them all.
    A job that raises aborts its ``group``'s barrier, so its peers raise
    too instead of waiting; the first exception in job order that is not
    a peer's broken barrier is raised here after every thread has ended.
    Returns the results in job order."""
    grad = torch.is_grad_enabled()
    results: List[Any] = [None] * len(jobs)
    errors: List[Optional[BaseException]] = [None] * len(jobs)

    def run(k: int):
        _, dev, fn, group = jobs[k]
        try:
            with _device_ctx(dev), torch.set_grad_enabled(grad):
                results[k] = fn()
        except BaseException as e:     # noqa: BLE001 (re-raised below)
            errors[k] = e
            if group is not None:
                group.abort()

    threads = [threading.Thread(target=run, args=(k,), daemon=True,
                                name=job[0]) for k, job in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    first = [e for e in errors if e is not None]
    if first:
        # a rank that saw only its peer's broken barrier is not the cause
        real = [e for e in first
                if not isinstance(e, threading.BrokenBarrierError)]
        raise (real or first)[0]
    return results


def run_on_mesh(mesh: Mesh, sparams: ShardedParams,
                body: Callable[..., Any], batch_args: Sequence = (),
                out_device: Optional[torch.device] = None) -> Any:
    """Run ``body(params, *shard_args)`` once a mesh position, each in a
    host thread (:func:`run_threads`) under its device's context and its
    :class:`ShardContext` (kernels off under tp or ``NWT_NO_SPMD``,
    :func:`spmd_serving_enabled`).

    ``batch_args`` are batch-leading (tensors, arrays or lists, or None)
    and split into dp contiguous shards; a shard's tensors move to its
    device. Within a dp group every tp rank gets the same rows; the
    group's result is rank 0's. The groups' results are put back together
    in shard order (:func:`mesh.gather_batch`), tensors on
    ``out_device`` (default the mesh's first device). The first
    exception a position raises, in mesh order, is raised here after
    every thread has ended."""
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    plain = not spmd_serving_enabled(mesh)
    shards = [batch_shards(a, dp) if a is not None else [None] * dp
              for a in batch_args]
    groups = [TPGroup(row) if tp > 1 else None for row in mesh.devices]

    def job(i: int, j: int):
        dev = mesh.devices[i][j]
        ctx = (ShardContext(groups[i], j, plain, sparams.vocab[j][0])
               if tp > 1 or plain else None)

        def fn():
            with shard_context(ctx):
                args = [_to(s[i], dev) for s in shards]
                return body(sparams.trees[i][j], *args)
        return f"nwt-shard-{i}-{j}", dev, fn, groups[i]

    results = run_threads([job(i, j) for i in range(dp) for j in range(tp)])
    return gather_batch([results[i * tp] for i in range(dp)],
                        out_device if out_device is not None
                        else mesh.first)


def shard_seeds(generator: Optional[torch.Generator], dp: int
                ) -> List[Optional[int]]:
    """One sampling seed a dp shard, from one draw of the batch's
    ``generator`` and the shard's index (the reference folds
    ``axis_index("dp")`` into its key), so that rows at the same in-shard
    index draw different samples. The tp ranks of a group share their
    group's seed, so they draw the same tokens."""
    if generator is None:
        return [None] * dp
    base = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device))
    return [(base * 1_000_003 + i) % (2 ** 63) for i in range(dp)]


def window_decode_spmd(params, data, prompt_tokens, pad_lens, sot_idx,
                       tables, temperature, generator, mesh: Mesh, cfg,
                       sample_len: int, compute_dtype=torch.float32,
                       q8_kv: bool = False, xattn_bf16: bool = False,
                       sampling: bool = True, kind: str = "frames",
                       speculative: int = 0, draft_pool: int = 4):
    """One dp-sharded window decode (the contract of
    ``decode/greedy.py``'s window implementations).

    ``kind`` picks the program a shard runs: "frames" (STFT frames -> mel
    -> encode -> decode, the serving path), "mel" (encode -> decode), "xa"
    (decode only). ``data`` and the prompt arrays are batch-leading and
    padded once for the whole batch, as the reference pads them before
    sharding. ``speculative`` K > 0 runs exact speculative greedy per
    shard, the target drafting for itself (greedy batches only). Returns
    (tokens, n_sampled, sum_logprob, no_speech_prob), the shards put back
    together in order."""
    from ..decode import greedy as g
    from ..models.whisper import encode
    use_spec = speculative > 0 and not sampling
    seeds = shard_seeds(generator if sampling else None, mesh.shape["dp"])

    def body(p, data, prompt, pads, sot, temps, seed):
        dev = data.device
        tab = tables.to(dev)
        if use_spec:
            from ..decode import speculative as sp
            impl = {"frames": sp.frames_encode_decode_speculative_impl,
                    "mel": sp.encode_decode_speculative_impl,
                    "xa": sp.decode_window_speculative_impl}[kind]
            tokens, n_sampled, sum_lp, nsp, _ = impl(
                p, p, data, prompt, pads, sot, tab, cfg, cfg, sample_len,
                speculative, draft_pool, compute_dtype, xattn_bf16, q8_kv,
                True)
            return tokens, n_sampled, sum_lp, nsp
        gen = (None if seed[0] is None
               else torch.Generator(device=dev).manual_seed(seed[0]))
        if kind == "frames":
            impl = g.frames_encode_decode_window_impl
        else:
            impl = g.decode_window_impl
            if kind == "mel":
                data = encode(p, data, cfg, compute_dtype=compute_dtype)
        return impl(p, data, prompt, pads, sot, tab, temps, gen, cfg,
                    sample_len, compute_dtype, q8_kv, xattn_bf16, sampling)

    return run_on_mesh(mesh, shard_params(params, mesh), body,
                       (data, prompt_tokens, pad_lens, sot_idx, temperature,
                        seeds))


def frames_encode_detect_spmd(params, frames, mesh: Mesh, cfg,
                              compute_dtype=torch.float32):
    """dp-sharded frames -> mel -> encode -> language detect (the
    auto-language serving stage). Returns (xa, lang_idx, lang_probs), the
    shards put back together on the mesh's first device."""
    from ..decode import greedy as g
    return run_on_mesh(
        mesh, shard_params(params, mesh),
        lambda p, fr: g.frames_encode_detect_impl(p, fr, cfg, compute_dtype),
        (frames,))


def frames_encode_spmd(params, frames, mesh: Mesh, cfg,
                       compute_dtype=torch.float32) -> torch.Tensor:
    """dp-sharded frames -> mel -> encoder states, no language detect (the
    beam batcher's fixed-language stage)."""
    from ..decode import greedy as g
    return run_on_mesh(
        mesh, shard_params(params, mesh),
        lambda p, fr: g.frames_encode_impl(p, fr, cfg, compute_dtype),
        (frames,))


def encode_spmd(params, mel, mesh: Mesh, cfg,
                compute_dtype=torch.float32) -> torch.Tensor:
    """dp-sharded ``encode`` of a mel batch."""
    from ..models.whisper import encode
    return run_on_mesh(
        mesh, shard_params(params, mesh),
        lambda p, m: encode(p, m, cfg, compute_dtype=compute_dtype), (mel,))


def detect_language_spmd(params, xa, mesh: Mesh, cfg,
                         compute_dtype=torch.float32):
    """dp-sharded language detection from encoder states."""
    from ..decode.greedy import detect_language
    return run_on_mesh(
        mesh, shard_params(params, mesh),
        lambda p, x: detect_language(p, x, cfg, compute_dtype), (xa,))
