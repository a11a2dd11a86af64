"""The check that the benchmark runs without JAX.

The port (``nobs_whisper_torch``) is measured; the JAX package
(``nobs_whisper_tpu``) it was ported from, and JAX itself, must not be
loaded. Names are compared by their top-level part, whole: the part
before the first dot, so ``nobs_whisper_torch`` is not
``nobs_whisper_tpu``.
"""

from __future__ import annotations

import ast
import os
import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "nobs_whisper_tpu"})


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded(modules: Iterable[str] = None) -> List[str]:
    """Forbidden top-level names among ``modules`` (default: sys.modules)."""
    names = sys.modules if modules is None else modules
    return sorted({top(m) for m in names if top(m) in FORBIDDEN})


def imports_in(source: str) -> List[str]:
    """Forbidden top-level names that ``source`` imports."""
    found = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            found.update(top(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            found.add(top(node.module))
    return sorted(found & FORBIDDEN)


def scan(directory: str) -> List[str]:
    """"path: name" for each forbidden import in the .py files under
    ``directory``."""
    out = []
    for dirpath, _, files in os.walk(directory):
        for f in sorted(files):
            if f.endswith(".py"):
                p = os.path.join(dirpath, f)
                with open(p, encoding="utf-8") as fh:
                    out += [f"{p}: {n}" for n in imports_in(fh.read())]
    return out
