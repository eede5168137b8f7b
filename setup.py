"""Build script: packages tinyknn_tpu and pre-compiles the native helper.

The accelerator compute path needs no compilation here (XLA and the
Pallas kernel compile at run time). The only native artifact is the host-side
runtime helper (native/tinyknn_native.cpp: inverted-list builder +
.fvecs reader), which tinyknn_tpu/native.py can also build lazily at
import time — so a missing toolchain never blocks installation.
Reference analogue: setup.py compiling the two Cython SIMD modules
(reference: setup.py:16-49).
"""

import hashlib
import subprocess
import sys
from pathlib import Path

from setuptools import setup
from setuptools.command.build_py import build_py


class BuildWithNative(build_py):
    def run(self):
        super().run()
        root = Path(__file__).parent
        src = root / "native" / "tinyknn_native.cpp"
        if src.exists():
            # Content-hashed filename (must match native._so_path): a
            # changed source always builds to a fresh path.
            h = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
            dst = (Path(self.build_lib) / "tinyknn_tpu"
                   / f"_tinyknn_native-{h}.so")
            for cc in ("g++", "c++", "clang++"):
                try:
                    subprocess.run(
                        [cc, "-O3", "-march=native", "-shared", "-fPIC",
                         str(src), "-o", str(dst)],
                        check=True, capture_output=True, timeout=300)
                    print(f"built native helper with {cc}")
                    return
                except (OSError, subprocess.SubprocessError):
                    continue
            print("no C++ compiler found; native helper will use NumPy "
                  "fallbacks", file=sys.stderr)


setup(cmdclass={"build_py": BuildWithNative})
