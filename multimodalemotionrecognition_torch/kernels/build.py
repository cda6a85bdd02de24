"""Build the port's CUDA kernels and load them with ctypes.

Every `csrc/*.cu` file is compiled by `nvcc` for Hopper (`sm_90a`) into one
shared library with a plain C interface; no PyTorch headers are involved, so
the build takes seconds.  It happens at first use, into `_build/` beside this
file (listed in `.gitignore`), under a name keyed by a hash of the sources
and flags, so a changed source is rebuilt and an unchanged one is reused.

There is no fallback: without `nvcc`, or when the build fails, `load_library`
raises.

    python -m multimodalemotionrecognition_torch.kernels.build   # build, print the path
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = [
    "BUILD_DIR",
    "CSRC_DIR",
    "NVCC_FLAGS",
    "check",
    "find_nvcc",
    "load_library",
]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (every function returns a cudaError_t).
_SIGNATURES = {
    # hidden, q, k, v, gate, bias, wo, bo, lns, lnb, ctx, proj, out,
    # B, Tp, seq_len, E, H, eps, stream
    "emo_wavlm_attn_f32": [_P] * 13 + [_I] * 5 + [ctypes.c_float, _P],
    "emo_wavlm_attn_bf16": [_P] * 13 + [_I] * 5 + [ctypes.c_float, _P],
    # y, w, out, B, rows, t_in, k, stride, cin, cout, gelu_in, gelu_out, stream
    "emo_conv_fe_f32": [_P] * 3 + [_I] * 9 + [_P],
    "emo_conv_fe_bf16": [_P] * 3 + [_I] * 9 + [_P],
}


def find_nvcc() -> str:
    """Path of nvcc (PATH, then $CUDA_HOME/bin, then /usr/local/cuda/bin)."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the port's "
        "CUDA kernels are built from source and need the CUDA toolkit"
    )


def _library_path(sources) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libemo_kernels_{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    lib_path = _library_path(sources)
    if not lib_path.exists():
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Build into a temporary name and rename, so a concurrent or cut
        # build never leaves a half-written library under the final name.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC_DIR}", "-o", tmp, *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
            )
        (BUILD_DIR / (lib_path.stem + ".log")).write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.emo_error_string.argtypes = [ctypes.c_int]
    lib.emo_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        text = lib.emo_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({text})")


if __name__ == "__main__":
    print(load_library()._name)
