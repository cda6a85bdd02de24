"""Shared set-up for the tests that hold the port's libav loader against the
JAX package's: a build of the JAX package's own `native/medialoader.cc`
outside its directory, and a fixture that runs a test once on each decoder.

`JAX native/build.py` links with `-lavformat ...` and no include flags; the
headers here sit under pkg-config's `-I`, so the command below is that one
plus pkg-config's `-I`.  Nothing is written into the JAX package's
directory: its `medialoader` is pointed at the build by monkeypatching
`_lib_path`, `_lib` and `_load_attempted`, which monkeypatch restores.
"""

import subprocess
from pathlib import Path

import pytest

from multimodalemotionrecognition_tpu.native import medialoader as jax_medialoader
from multimodalemotionrecognition_torch.native import build as native_build
from multimodalemotionrecognition_torch.native import medialoader

JAX_SOURCE = Path(jax_medialoader.__file__).with_name("medialoader.cc")
JAX_LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswresample", "-lswscale")


def skip_without_libav() -> None:
    reason = native_build.missing()
    if reason is not None:
        pytest.skip(reason)


def build_jax_loader(out_dir: Path) -> Path:
    """The JAX package's loader compiled into `out_dir`."""
    skip_without_libav()
    include = subprocess.run(["pkg-config", "--cflags-only-I", *native_build.LIBAV],
                             capture_output=True, text=True, check=True).stdout.split()
    out = Path(out_dir) / "libmedialoader.so"
    subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-std=c++17", *include, str(JAX_SOURCE),
                    "-o", str(out), *JAX_LIBS], check=True, capture_output=True)
    return out


def use_jax_loader(monkeypatch, lib_path: Path) -> None:
    """Point the JAX package's bindings at `lib_path` for one test."""
    monkeypatch.setattr(jax_medialoader, "_lib_path", lambda: Path(lib_path))
    monkeypatch.setattr(jax_medialoader, "_lib", None)
    monkeypatch.setattr(jax_medialoader, "_load_attempted", False)
    assert jax_medialoader.available()


@pytest.fixture(scope="module")
def jax_loader_path(tmp_path_factory):
    """The JAX package's loader, built once per test module."""
    return build_jax_loader(tmp_path_factory.mktemp("jax_native"))


@pytest.fixture(params=["cv2", "libav"])
def decoder(request, monkeypatch):
    """Video decode through cv2 in both packages (`EMO_NATIVE_DECODE=0`, which
    both honour), or through each package's libav loader.  Where libav is
    present the JAX package is on its loader in both cases, so container
    audio decodes; the libav case skips where it is absent."""
    monkeypatch.setenv("EMO_NATIVE_DECODE", "0" if request.param == "cv2" else "1")
    if request.param == "cv2" and native_build.missing() is not None:
        return request.param
    skip_without_libav()
    use_jax_loader(monkeypatch, request.getfixturevalue("jax_loader_path"))
    assert medialoader.available()
    return request.param
