"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, loaded with ``ctypes`` (seconds to build, where a PyTorch C++
extension takes minutes). The build runs at first use into
``csrc/build/`` (listed in ``.gitignore``); :func:`build_all` starts one
``nvcc`` per source, all at once. Nothing here runs at import time: a
machine without ``nvcc`` or a card imports the port fine and runs the
kernels' plain versions on CPU tensors.
"""

from __future__ import annotations

import collections
import ctypes
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCES = ("encoder_attention", "fused_mlp", "cross_attention_decode",
           "q8_matmul", "fused_qkv", "conv_stem", "fused_layer", "mel",
           "fused_mlp_q8", "moe")
# sources a source includes besides the headers (K12 is K1 then K2)
INCLUDES = {"fused_layer": ("encoder_attention", "fused_mlp")}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
# held by every launch counter's increment: shards on a mesh launch from
# several host threads at once (parallel/spmd.py)
COUNT_LOCK = threading.Lock()
_capture = threading.local()
_libs: Dict[str, ctypes.CDLL] = {}
# per-source build record: {"seconds": float, "ptxas": str} (chip_smoke)
build_log: Dict[str, dict] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built on the machine with the card")
    return found


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"libnwt_{name}.so")


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    t = os.path.getmtime(lib)
    deps = [os.path.join(CSRC, f"{n}.cu")
            for n in (name, *INCLUDES.get(name, ()))] + [
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")]
    return any(os.path.getmtime(p) > t for p in deps)


def build_all(names: Optional[List[str]] = None, force: bool = False
              ) -> Dict[str, dict]:
    """Compile the given sources (default: all) that are missing or stale,
    one ``nvcc`` process per source started together. Raises with the
    compiler's output if any build fails."""
    names = list(names or SOURCES)
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    t0 = time.perf_counter()
    for n in todo:
        fd, tmp = tempfile.mkstemp(prefix=f".libnwt_{n}.", suffix=".so",
                                   dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for n, tmp, p in procs:
        out, _ = p.communicate()
        build_log[n] = {"seconds": time.perf_counter() - t0, "ptxas": out}
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{out}")
            os.unlink(tmp)
        else:
            os.replace(tmp, _lib_path(n))   # atomic when two processes build at once
    if errors:
        raise RuntimeError("\n".join(errors))
    return build_log


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """Build (if needed) and load ``libnwt_<name>.so``, declaring each C
    function's argument types; every function returns a cudaError_t."""
    with _lock:
        if name not in _libs:
            build_all([name])
            lib = ctypes.CDLL(_lib_path(name))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def build_variants(sources: Dict[str, str], out_dir: str,
                   signatures: Dict[str, list]
                   ) -> Tuple[Dict[str, ctypes.CDLL], Dict[str, str]]:
    """Compile each CUDA source text of ``sources`` ({name: text}) into
    ``out_dir/lib<name>.so`` with the port's flags and ``csrc/`` on the
    include path, one ``nvcc`` each, all started together, and load it,
    declaring each function of ``signatures`` that it has. For scripts
    that time versions of a kernel side by side. Returns ({name: library},
    {name: nvcc's output}); raises with the compiler's output if a build
    fails."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-I", CSRC, "-o",
             os.path.join(out_dir, f"lib{name}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, logs = {}, {}
    for name, p in procs.items():
        logs[name], _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
        lib = libs[name] = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
        for fn, argtypes in signatures.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
    return libs, logs


def sass_counts(lib_path: str) -> Dict[str, collections.Counter]:
    """{kernel name: Counter of opcodes} of a built library, from the
    toolkit's ``cuobjdump -sass`` (for the variants scripts)."""
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)"
                     r"(\.[A-Z0-9_.]+)?", line)
        if name and m:
            out[name][m.group(1)] += 1
    return out


def no_autograd(what: str, *inputs) -> None:
    """Refuse a kernel call under autograd. A hand-written kernel's output
    has no ``grad_fn``, so a training forward that reached one would lose
    every gradient behind it without a word. Raises RuntimeError when grad
    mode is on and a tensor input (or a part of a QTensor dict) requires
    grad. Under ``inference_mode`` and ``no_grad`` it is one flag read.
    Each wrapper calls it first, on every device: the plain version that
    a CPU tensor takes stands in for the kernel, and raises alike."""
    if not torch.is_grad_enabled():
        return
    for t in inputs:
        parts = t.values() if isinstance(t, dict) else (t,)
        if any(isinstance(z, torch.Tensor) and z.requires_grad
               for z in parts):
            raise RuntimeError(
                f"{what}: a hand-written kernel was reached with an input "
                "that requires grad; its output would carry no gradient. "
                "Training runs the plain torch ops "
                "(parallel/tp.py::plain_ops)")


def count(counter, key, n: int = 1) -> None:
    """Add ``n`` to the launch counter ``counter[key]``: a module's
    ``globals()`` and a counter's name, or a ``Counter`` and a key. While
    the calling thread captures a CUDA graph (:class:`LaunchTally`), the
    launch only enters the graph: the count goes to the capture's tally,
    and each replay adds it (the decode step's counters:
    ``decoder_forward_calls``, K4, K5 and K6)."""
    tally = getattr(_capture, "tally", None)
    if tally is not None:
        tally.add(counter, key, n)
        return
    with COUNT_LOCK:
        counter[key] += n


class LaunchTally:
    """The launch counts of one CUDA graph's capture: entered around the
    capture (in the capturing thread), added once a replay
    (:meth:`replay`), so that replays count as the launches they
    replay."""

    def __init__(self):
        self._counts: Dict[Tuple[int, object], list] = {}

    def add(self, counter, key, n: int) -> None:
        slot = self._counts.setdefault((id(counter), key), [counter, key, 0])
        slot[2] += n

    def replay(self) -> None:
        with COUNT_LOCK:
            for counter, key, n in self._counts.values():
                counter[key] += n

    def __enter__(self) -> "LaunchTally":
        _capture.tally = self
        return self

    def __exit__(self, *exc) -> None:
        del _capture.tally


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
