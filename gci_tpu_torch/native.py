"""Make ``gci_tpu.native`` (the reused C++ host codec) loadable.

``gci_tpu.native`` builds ``gci_native.cpp`` with g++ against zlib and
libdeflate on first use.  Where libdeflate is missing the build fails with a
``CalledProcessError`` that its callers do not catch, so every BAM read and
checkpoint write would stop there; a library built on another machine
fails to load with an ``OSError``.  ``ensure_host_codec`` then compiles the
same source against ``csrc/zlib_deflate_shim/libdeflate.h`` (libdeflate's
API on zlib) into ``build/gci_tpu_torch/`` and hands the library to
``gci_tpu.native``: the same codec, with zlib doing the deflate work.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

from gci_tpu_torch.kernels import BUILD_DIR

_SHIM_DIR = Path(__file__).resolve().parent / "csrc" / "zlib_deflate_shim"


def _shim_library_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + (_SHIM_DIR / "libdeflate.h").read_bytes())
    return BUILD_DIR / f"_gci_native_zlib_{h.hexdigest()[:16]}.so"


def ensure_host_codec() -> str:
    """Load the host codec; return ``"libdeflate"`` or ``"zlib shim"``.

    Raises ``RuntimeError`` with the compiler's message when neither build
    works.
    """
    from gci_tpu import native

    try:
        native.get_lib()
        return "libdeflate"
    except subprocess.CalledProcessError as exc:  # the build failed
        first_error = (exc.stderr or b"").decode(errors="replace")
    except OSError as exc:  # a library built elsewhere does not load here
        first_error = str(exc)
    src = Path(native._SRC)
    out = _shim_library_path(src)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
            "-fvisibility=hidden", f"-I{_SHIM_DIR}", str(src), "-lz",
            "-lpthread", "-o", str(tmp),
        ]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                "the host codec did not build with libdeflate:\n"
                f"{first_error}\nnor with the zlib shim:\n{r.stderr}"
            )
        tmp.replace(out)
    lib = ctypes.CDLL(str(out))
    native._declare(lib)
    native._lib = lib
    return "zlib shim"
