"""Git-derived build metadata.

The reference derives its version from the git history at configure
time (``cmake/build-info.cmake:1-67``: commit hash + ``rev-list
--count`` -> ``0.0.<count>``).  The package is pure Python,
so the equivalent is computed lazily at runtime: when the package runs
from a git checkout, :func:`build_info` reports the commit, commit
count, and dirty state; from an installed wheel it falls back to the
static package version.  Results are cached per process.
"""

from __future__ import annotations

import functools
import os
import subprocess

def _base_version() -> str:
    """Single source: the package's __version__ (pyproject.toml is the
    packaging-metadata copy)."""
    try:
        from . import __version__
        return __version__
    except Exception:  # pragma: no cover - degenerate import states
        return "0.0.0"


def _git(args: list[str], cwd: str) -> str | None:
    try:
        out = subprocess.run(
            ["git", *args], cwd=cwd, capture_output=True, text=True,
            timeout=5)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return out.stdout.strip()


@functools.lru_cache(maxsize=1)
def build_info() -> dict:
    """``{"version", "commit", "commit_count", "dirty", "source"}``.

    ``version`` is ``<base>+g<short-commit>[.dirty]`` from a git
    checkout (PEP 440 local version), or the plain base version from an
    installed distribution.
    """
    here = os.path.dirname(os.path.abspath(__file__))
    # Only trust a discovered repo that actually is this project: a
    # wheel installed into a venv that happens to live inside some
    # unrelated git checkout must not report that repo's commit state.
    toplevel = _git(["rev-parse", "--show-toplevel"], here)
    is_ours = toplevel is not None and (
        os.path.isdir(os.path.join(toplevel, "canopy_tpu"))
        or os.path.samefile(toplevel, os.path.dirname(here)))
    commit = _git(["rev-parse", "--short", "HEAD"], here) \
        if is_ours else None
    if commit is None:
        return {"version": _base_version(), "commit": None,
                "commit_count": None, "dirty": False,
                "source": "package"}
    count = _git(["rev-list", "--count", "HEAD"], here)
    status = _git(["status", "--porcelain"], here)
    dirty = bool(status)
    version = f"{_base_version()}+g{commit}" + (".dirty" if dirty else "")
    return {"version": version, "commit": commit,
            "commit_count": int(count) if count else None,
            "dirty": dirty, "source": "git"}


def version_string() -> str:
    info = build_info()
    if info["source"] == "git":
        return (f"canopy-tpu {info['version']} "
                f"(commit {info['commit']}, #{info['commit_count']})")
    return f"canopy-tpu {info['version']}"
