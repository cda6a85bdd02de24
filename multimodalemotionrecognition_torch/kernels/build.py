"""Build the port's CUDA kernels and load them with ctypes.

Every `csrc/*.cu` file is compiled by `nvcc` for Hopper (`sm_90a`), one
`nvcc` process per source and all of them at once, and the objects are
linked into one shared library with a plain C interface; no PyTorch headers
are involved, so the build takes seconds.  It happens at first use, into
`_build/` beside this file (listed in `.gitignore`), under a name keyed by a
hash of the sources, headers and flags, so a changed source is rebuilt and
an unchanged one is reused.

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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# seed, attention threshold and 1/keep, hidden threshold and 1/keep
_DROPOUT = [_I, ctypes.c_uint, _F, ctypes.c_uint, _F]
# C entry points: name -> argtypes (every function returns a cudaError_t).
_SIGNATURES = {
    # hidden, q, k, v, gate, bias, wo, bo, lns, lnb, ctx, proj, out, wo_t
    # (W_o transposed, float32 tensor-core route only, else null), seed_dev
    # (the dropout seed as an int32 in device memory, else null: the seed
    # argument), B, Tp, seq_len, E, H, eps, then the dropout, then the stream
    "emo_wavlm_attn_f32": [_P] * 15 + [_I] * 5 + [_F] + _DROPOUT + [_P],
    "emo_wavlm_attn_bf16": [_P] * 15 + [_I] * 5 + [_F] + _DROPOUT + [_P],
    # dout, q, k, v, gate, bias, wo, lns, ctx, proj; the ten gradients; seven
    # scratch buffers, then the transposed operands (float32 tensor-core
    # route only, else null); B, Tp, seq_len, E, H, col_chunks, eps, dropout,
    # stream
    "emo_wavlm_attn_bwd_f32": [_P] * 28 + [_I] * 6 + [_F] + _DROPOUT + [_P],
    "emo_wavlm_attn_bwd_bf16": [_P] * 28 + [_I] * 6 + [_F] + _DROPOUT + [_P],
    # as emo_wavlm_attn up to out; then G, B, Tp, seq_len, E, H, eps, stream
    "emo_wavlm_attn_tiled_f32": [_P] * 13 + [_I] * 6 + [_F, _P],
    "emo_wavlm_attn_tiled_bf16": [_P] * 13 + [_I] * 6 + [_F, _P],
    # the tensor-core route: the same with W_o transposed after out (float32
    # only, else null)
    "emo_wavlm_attn_tiled_tc_f32": [_P] * 14 + [_I] * 6 + [_F, _P],
    "emo_wavlm_attn_tiled_tc_bf16": [_P] * 14 + [_I] * 6 + [_F, _P],
    # y, w, out, B, rows, t_in, k, stride, cin, cout, gelu_in, gelu_out, stream
    "emo_conv_fe_f32": [_P] * 3 + [_I] * 9 + [_P],
    "emo_conv_fe_bf16": [_P] * 3 + [_I] * 9 + [_P],
    # y, w, out, B, rows, t_in, k, stride, cin, cout, gelu_out, plan, steps, stream
    "emo_conv_fe_wgmma_bf16": [_P] * 3 + [_I] * 8 + [ctypes.POINTER(_I), _I, _P],
    # the same with w as [2, cout, k*cin], W^T split into TF32 hi and lo
    "emo_conv_fe_wgmma_tf32x3": [_P] * 3 + [_I] * 8 + [ctypes.POINTER(_I), _I, _P],
    # x, hi, lo, n, stream: the device's TF32 split, elementwise
    "emo_split_tf32": [_P] * 3 + [ctypes.c_longlong, _P],
}
# pointer table, its length, int table, its length, eps, dh^-0.5, stream
# (the tables are laid out in csrc/fusion.cuh and filled by kernels/xattn.py)
_FUSION_ARGTYPES = [
    ctypes.POINTER(_P), _I, ctypes.POINTER(_I), _I, ctypes.c_float, ctypes.c_float, _P,
]
for _name in ("emo_fused_block_f32", "emo_fused_block_bf16", "emo_fused_block_tc_f32",
              "emo_fused_block_tc_bf16", "emo_xattn", "emo_xattn_tc"):
    _SIGNATURES[_name] = _FUSION_ARGTYPES


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
    for src in (*sources, *sorted(CSRC_DIR.glob("*.cuh"))):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libemo_kernels_{digest.hexdigest()[:16]}.so"


def _build(nvcc: str, sources, lib_path: Path) -> None:
    """Compile every source in its own nvcc process, all started together,
    then link; raises with nvcc's output when a step fails."""
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC_DIR}", "-c", "-o", str(obj), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            jobs.append((cmd, obj, proc))
        log, failed = [], []
        for cmd, _, proc in jobs:  # wait for all, so none outlives a failure
            out, err = proc.communicate()
            log.append(out + err)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        # Link under a temporary name and rename, so a concurrent or cut
        # build never leaves a half-written library under the final name.
        tmp_lib = Path(tmp) / lib_path.name
        cmd = [nvcc, "-shared", "-o", str(tmp_lib), *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        (BUILD_DIR / (lib_path.stem + ".log")).write_text("".join(log))
        os.replace(tmp_lib, lib_path)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    lib_path = _library_path(sources)
    if not lib_path.exists():
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _build(nvcc, sources, lib_path)
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
