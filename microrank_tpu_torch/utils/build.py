"""Build-at-first-use for the port's native libraries.

Both libraries — the C++ span loader / graph builder (``native/``) and
the CUDA kernels (``csrc/``) — compile from sources in the package into
one git-ignored directory, ``microrank_tpu_torch/_build/``, and load
with ctypes. A build writes to a process-private temporary name and
renames it into place, so concurrent first uses (test workers, a smoke
script building everything in parallel) never load a half-written file.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path
from typing import Sequence

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"


class BuildError(RuntimeError):
    """A native library could not be compiled."""


def is_stale(out: Path, sources: Sequence[Path]) -> bool:
    return not out.exists() or out.stat().st_mtime < max(
        s.stat().st_mtime for s in sources
    )


def tmp_output(out: Path) -> Path:
    return out.with_name(f".{out.stem}.{os.getpid()}.tmp{out.suffix}")


def run_build(cmd: Sequence[str], tmp: Path, out: Path, timeout: float = 600) -> str:
    """Run one compiler command that writes ``tmp``, then publish it as
    ``out``; returns the compiler's output. Raises BuildError with that
    output on failure."""
    out.parent.mkdir(parents=True, exist_ok=True)
    try:
        proc = subprocess.run(
            list(cmd), check=True, capture_output=True, text=True,
            timeout=timeout,
        )
    except FileNotFoundError as exc:
        raise BuildError(f"compiler not found: {cmd[0]}") from exc
    except subprocess.CalledProcessError as exc:
        tmp.unlink(missing_ok=True)
        raise BuildError(
            f"build of {out.name} failed:\n{exc.stdout}\n{exc.stderr}"
        ) from exc
    os.replace(tmp, out)
    return proc.stdout + proc.stderr
