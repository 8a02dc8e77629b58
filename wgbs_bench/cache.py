"""The benchmark's on-disk cache: `wgbs_bench/.cache/<kind>-<key>/`.

Each entry is a directory at a fixed path named by the hash of what it was
made from, written under a staging name and renamed into place whole, so a
run that is cut leaves no half entry and the next run of the checkout finds
every entry that the first one made.  Kinds: `genome` (the contigs),
`index` (the port's artifact and its plane cache).  The reference keeps
nothing on disk.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".cache")


def key(*parts) -> str:
    """A 16-hex-digit hash of JSON-able parts and raw bytes."""
    h = hashlib.sha256()
    for p in parts:
        h.update(p if isinstance(p, bytes)
                 else json.dumps(p, sort_keys=True).encode())
        h.update(b"\0")
    return h.hexdigest()[:16]


def entry(kind: str, *parts) -> str:
    return os.path.join(ROOT, f"{kind}-{key(*parts)}")


def staging(final: str) -> str:
    """A fresh directory beside `final` to write an entry into."""
    tmp = f"{final}.part{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    return tmp


def commit(tmp: str, final: str) -> None:
    try:
        os.rename(tmp, final)
    except OSError:             # another run committed it first
        shutil.rmtree(tmp, ignore_errors=True)


def sources_hash(*dirs: str) -> bytes:
    """The bytes of every file under `dirs` (sorted paths), hashed: a change
    to the code that made an entry makes a new key."""
    h = hashlib.sha256()
    for d in dirs:
        for base, subdirs, files in sorted(os.walk(d)):
            subdirs[:] = sorted(s for s in subdirs if s != "__pycache__")
            for name in sorted(files):
                if name.endswith((".py", ".cpp", ".h", ".cu", ".cuh")):
                    path = os.path.join(base, name)
                    h.update(os.path.relpath(path, d).encode())
                    with open(path, "rb") as f:
                        h.update(f.read())
    return h.digest()
