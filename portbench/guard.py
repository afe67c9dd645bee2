"""What a run may not load: the JAX package and JAX itself in the process
that prints the result, and anything of the program in the reference.
Names are compared whole, by the part before the first dot, so that
``cilqr_tpu_torch`` is not taken for ``cilqr_tpu``."""

from __future__ import annotations

import ast
import pathlib
import sys

FORBIDDEN_IN_RUN = frozenset({"jax", "jaxlib", "flax", "cilqr_tpu"})
FORBIDDEN_IN_REFERENCE = FORBIDDEN_IN_RUN | {"cilqr_tpu_torch"}

REF_DIR = pathlib.Path(__file__).resolve().parent / "ref"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None, forbidden=FORBIDDEN_IN_RUN):
    """The names in ``modules`` (sys.modules by default) whose top-level
    name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top_level(n) in forbidden)


def imported_names(path: pathlib.Path):
    """Every absolute module name a source file imports, at any depth."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def reference_violations(ref_dir: pathlib.Path = REF_DIR):
    """(file, module) pairs of the reference that import a forbidden
    package."""
    return [(p.name, m) for p in sorted(ref_dir.glob("*.py"))
            for m in imported_names(p)
            if top_level(m) in FORBIDDEN_IN_REFERENCE]
