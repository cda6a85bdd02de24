"""Build the native media loader (`medialoader.cc`) and say where it is.

The loader is compiled at first use with

    g++ -O2 -fPIC -shared -std=c++17 medialoader.cc $(pkg-config --cflags --libs <libav>)

over the five libraries in `LIBAV`, into `_build/` beside this file (listed
in `.gitignore`), under a name keyed by a hash of the source, the flags and
`pkg-config --modversion`, so a changed source or another libav is rebuilt
and an unchanged one is reused.

Availability: the loader exists when pkg-config finds all five libraries.
Then a compile that fails raises with the compiler's output; there is no
quiet retreat to cv2.  When pkg-config does not find them, `missing()` says
what it reported and `medialoader.available()` is False.

    python -m multimodalemotionrecognition_torch.native.build   # build, print the path
"""

from __future__ import annotations

import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

__all__ = ["BUILD_DIR", "CXX_FLAGS", "LIBAV", "SOURCE", "build", "compile_to", "libav_version",
           "library_path", "missing"]

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "medialoader.cc"
BUILD_DIR = HERE / "_build"
LIBAV = ("libavformat", "libavcodec", "libavutil", "libswresample", "libswscale")
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")


@functools.lru_cache(maxsize=None)
def _pkg_config(libs: Tuple[str, ...]) -> Tuple[Optional[Tuple[str, ...]], str]:
    """(compiler flags, `--modversion` text) of `libs`, or (None, why) when
    pkg-config does not find every one."""
    try:
        versions = subprocess.run(["pkg-config", "--modversion", *libs], capture_output=True,
                                  text=True)
    except FileNotFoundError:
        return None, "pkg-config not found: the native media loader needs it and libav"
    if versions.returncode != 0:
        return None, f"libav not found by pkg-config ({' '.join(libs)}): {versions.stderr.strip()}"
    flags = subprocess.run(["pkg-config", "--cflags", "--libs", *libs], capture_output=True,
                           text=True, check=True)
    return tuple(flags.stdout.split()), versions.stdout.strip()


def missing() -> Optional[str]:
    """None when pkg-config finds libav, else what it reported."""
    flags, text = _pkg_config(LIBAV)
    return text if flags is None else None


def _found() -> Tuple[Tuple[str, ...], str]:
    """(compiler flags, versions); raises with pkg-config's message when
    libav is missing."""
    flags, text = _pkg_config(LIBAV)
    if flags is None:
        raise RuntimeError(text)
    return flags, text


def libav_version() -> str:
    """`pkg-config --modversion` of the five libraries, one per line, in
    `LIBAV`'s order; raises when they are missing."""
    return _found()[1]


def compile_to(out: Path) -> None:
    """Compile the loader into `out`; raises with the compiler's output."""
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(out), *_found()[0]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")


def library_path() -> Path:
    flags, versions = _found()
    digest = hashlib.sha256(" ".join((*CXX_FLAGS, *flags)).encode())
    digest.update(versions.encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmedialoader_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Path of the built loader, compiling it first when it is not there."""
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Compile under a temporary name and rename, so concurrent or cut
        # builds never leave a half-written library under the final name.
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            tmp_lib = Path(tmp) / path.name
            compile_to(tmp_lib)
            os.replace(tmp_lib, path)
    return path


if __name__ == "__main__":
    print(build())
