"""Build a shared library from a source file of the package at first use.

Outputs go to `build/lancet_tpu_torch/` at the root of the checkout (listed
in .gitignore), never into the package directory. The file name carries a
hash of the source, of every header it includes with quotes (`#include
"..."`, found beside the including file, and the headers those include) and
of the compile command, so an edited source or header or changed flags
build afresh and a stale library is never loaded. An exclusive file
lock serialises concurrent builders (test workers, threads); the library is
written to a temporary name and renamed into place, so a reader never sees
a half-written file.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import re
import subprocess

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_ROOT, "build", "lancet_tpu_torch")


_QUOTED_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


class BuildError(RuntimeError):
    """A compiler is missing or refused the source; the message carries the
    compiler's own error text."""


def cache_key(src: str, cmd: list[str]) -> str:
    """The hash a build of `src` by `cmd` is cached under: the source's
    bytes, then each header it includes with quotes that exists beside the
    including file (its name relative to the source's directory and its
    bytes, each header once, in the order first reached), then the
    command."""
    with open(src, "rb") as f:
        data = f.read()
    h = hashlib.sha256(data)
    root = os.path.dirname(os.path.abspath(src))
    seen = {os.path.abspath(src)}
    todo = [(root, data)]
    while todo:
        where, text = todo.pop(0)
        for m in _QUOTED_INCLUDE.finditer(text):
            path = os.path.normpath(os.path.join(where, m.group(1).decode()))
            if path in seen or not os.path.isfile(path):
                continue
            seen.add(path)
            with open(path, "rb") as f:
                inc = f.read()
            h.update(b"\0" + os.path.relpath(path, root).encode() + b"\0")
            h.update(inc)
            todo.append((os.path.dirname(path), inc))
    h.update("\0".join(cmd).encode())
    return h.hexdigest()


def build_shared(src: str, stem: str, cmd: list[str]) -> str:
    """Compile `src` into BUILD_DIR/<stem>-<hash>.so unless it exists and
    return its path (the hash: cache_key). `cmd` is the compiler command
    without the output argument; "-o <path>" is appended. The compiler's
    output (warnings, a ptxas report) is kept in <path>.log."""
    so = os.path.join(BUILD_DIR, f"{stem}-{cache_key(src, cmd)[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f".{stem}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so):
            return so
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            r = subprocess.run(cmd + ["-o", tmp], capture_output=True,
                               text=True)
        except FileNotFoundError as e:
            raise BuildError(f"{stem}: compiler not found: {e}") from e
        if r.returncode != 0:
            raise BuildError(f"{stem}: build failed (rc {r.returncode}):\n"
                             f"{' '.join(cmd)}\n{r.stderr[-4000:]}")
        with open(so + ".log", "w") as f:
            f.write(r.stdout + r.stderr)
        os.replace(tmp, so)
    return so
