"""Build/version metadata (volcano pkg/version/version.go + Makefile:25-28).

The reference stamps GitSHA/Built/Version into the binary via ldflags; here
the same three fields are resolved at import: the package version, the repo
HEAD when running from a git checkout (best-effort — empty when unavailable),
and the build/install timestamp of the package tree.
"""

from __future__ import annotations

import os
import subprocess
import time

__version__ = "0.2.0"


def _git_sha() -> str:
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        # the parent dir is only trustworthy when it IS this repo's checkout:
        # an install into site-packages nested under some unrelated git
        # checkout must not report that repo's SHA
        top = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"], cwd=repo,
            capture_output=True, text=True, timeout=5)
        if (top.returncode != 0
                or os.path.realpath(top.stdout.strip()) != os.path.realpath(repo)):
            return ""
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=repo,
            capture_output=True, text=True, timeout=5)
        return out.stdout.strip() if out.returncode == 0 else ""
    except Exception:
        return ""


def _built() -> str:
    try:
        ts = os.path.getmtime(os.path.abspath(__file__))
    except OSError:
        ts = time.time()
    return time.strftime("%Y-%m-%d %H:%M:%S UTC", time.gmtime(ts))


VERSION = __version__


def version_string(apiserver: bool = False) -> str:
    """Multi-line banner matching version.go PrintVersionAndExit's fields.

    GitSHA/Built are resolved here, lazily — only --version pays the git
    subprocess, not every `import volcano_tpu_torch`."""
    return (
        f"Version: {VERSION}\n"
        f"Git SHA: {_git_sha() or '(unknown)'}\n"
        f"Built At: {_built()}\n"
    )
