"""At-scale artifact cache location (counterpart of
bitmapperbs_tpu/utils/artifacts.py).

A 3 Gbp index takes hours to build, so at-scale artifacts live in one
persistent, gitignored directory inside the repository (`artifacts/`, or
$BTBS_ARTIFACTS), shared with the reference package: the on-disk formats
are the same.

Layout: <dir>/<name>.bin + <name>.json (index artifacts, index/build.py),
plus derived caches (gplanes_<sha>.v1.bin, index/device.py).
"""
from __future__ import annotations

import os

_REPO_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "artifacts")


def artifacts_dir() -> str:
    """Persistent directory for writing at-scale artifacts."""
    d = os.environ.get("BTBS_ARTIFACTS", _REPO_DIR)
    os.makedirs(d, exist_ok=True)
    return d


def find_artifact(name: str) -> str | None:
    """Locate `<name>.json` in the persistent directory.  Returns the
    artifact prefix (no extension) or None."""
    prefix = os.path.join(os.environ.get("BTBS_ARTIFACTS", _REPO_DIR), name)
    return prefix if os.path.exists(prefix + ".json") else None
