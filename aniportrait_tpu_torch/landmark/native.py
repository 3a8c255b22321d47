"""ctypes binding for the in-repo C++ TFLite runner
(``native/tflite_runner/``), the port's copy of
``aniportrait_tpu/landmark/native.py``: a drop-in ``InterpreterLike`` for
``FaceLandmarkerLite``.

The library is used as the file the repository ships
(``native/tflite_runner/libtflite_runner.so``).  Where that file is missing
or does not load on this machine, ``tflite_runner.cc`` is compiled with the
Makefile's flags into the git-ignored ``build/native/`` and that copy is
loaded; nothing is written under ``native/``."""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from typing import List

import numpy as np

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
_NATIVE_DIR = os.path.join(_ROOT, "native", "tflite_runner")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libtflite_runner.so")
_BUILD_DIR = os.path.join(_ROOT, "build", "native")
# native/tflite_runner/Makefile's flags
_CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")


def _build() -> str:
    """Compile ``tflite_runner.cc`` into ``build/native/``; returns the
    library's path."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"{_LIB_PATH} does not load and no C++ compiler is "
                           "available to build it")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    out = os.path.join(_BUILD_DIR, "libtflite_runner.so")
    subprocess.run([cxx, *_CXXFLAGS, "-shared", "-o", out,
                    os.path.join(_NATIVE_DIR, "tflite_runner.cc")],
                   check=True, capture_output=True)
    return out


def _open():
    try:
        return ctypes.CDLL(_LIB_PATH)
    except OSError:  # missing, or built for another machine
        return ctypes.CDLL(_build())


def _load_lib():
    lib = _open()
    lib.flr_create.restype = ctypes.c_void_p
    lib.flr_create.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.flr_destroy.argtypes = [ctypes.c_void_p]
    for f in ("flr_num_inputs", "flr_num_outputs"):
        getattr(lib, f).argtypes = [ctypes.c_void_p]
        getattr(lib, f).restype = ctypes.c_int
    for f in ("flr_input_size", "flr_output_size"):
        getattr(lib, f).argtypes = [ctypes.c_void_p, ctypes.c_int]
        getattr(lib, f).restype = ctypes.c_int
    lib.flr_set_input.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"), ctypes.c_int,
    ]
    lib.flr_invoke.argtypes = [ctypes.c_void_p]
    lib.flr_get_output.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"), ctypes.c_int,
    ]
    return lib


_LIB = None


class NativeInterpreter:
    """Runs a .tflite model through the in-repo C++ interpreter."""

    def __init__(self, model_content: bytes):
        global _LIB
        if _LIB is None:
            _LIB = _load_lib()
        self._buf = model_content  # keep alive
        self._h = _LIB.flr_create(model_content, len(model_content))
        if not self._h:
            raise RuntimeError("failed to load model in native runner")

    def __del__(self):
        if getattr(self, "_h", None) and _LIB is not None:
            _LIB.flr_destroy(self._h)
            self._h = None

    def run(self, inputs: np.ndarray) -> List[np.ndarray]:
        x = np.ascontiguousarray(inputs, np.float32).reshape(-1)
        if x.size != _LIB.flr_input_size(self._h, 0):
            raise ValueError(f"input of {x.size} values, the model takes "
                             f"{_LIB.flr_input_size(self._h, 0)}")
        _LIB.flr_set_input(self._h, 0, x, x.size)
        _LIB.flr_invoke(self._h)
        outs = []
        for i in range(_LIB.flr_num_outputs(self._h)):
            n = _LIB.flr_output_size(self._h, i)
            buf = np.empty(n, np.float32)
            _LIB.flr_get_output(self._h, i, buf, n)
            outs.append(buf)
        return outs
