"""The C Avro decoder, built from this package's source at first use
(port of photon_ml_tpu/native/__init__.py:29-74).

``_avro_native.c`` (a copy of the JAX package's decoder) is a CPython
extension: ``load_avro_native`` compiles it with the interpreter's C
compiler into ``native/_build/`` (listed in .gitignore), under a name
keyed by a hash of the source and the command, and imports it. A later
call in the same process returns the loaded module; a later process finds
the built library and only imports it.

There is no quiet fallback: a failed build raises ``RuntimeError`` with
the compiler's output. The JAX package's ``PHOTON_ML_TPU_NO_NATIVE``
opt-out has no counterpart; a caller that wants the pure-Python codec
asks for it (``feeder="python"``, ``read_container(..., native=False)``).
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
from pathlib import Path

_NATIVE_DIR = Path(__file__).resolve().parent
SOURCE = _NATIVE_DIR / "_avro_native.c"
BUILD_DIR = _NATIVE_DIR / "_build"
_module = None


def _command(out: Path):
    cc = (sysconfig.get_config_var("CC") or "cc").split()[0]
    include = sysconfig.get_paths()["include"]
    return [cc, "-O2", "-shared", "-fPIC", f"-I{include}", str(SOURCE),
            "-o", str(out)]


def library_path() -> Path:
    """Where the built extension lives: a name keyed by the source and
    the compile command, so a changed source rebuilds."""
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(_command(Path("x"))).encode())
    return BUILD_DIR / f"_avro_native-{digest.hexdigest()[:16]}{suffix}"


def build() -> Path:
    """Compile the extension unless a build for this source exists;
    returns its path. Raises RuntimeError when the compiler fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = _command(tmp)
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"the C Avro decoder did not build: "
                           f"{' '.join(cmd)}: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"the C Avro decoder did not build (exit {res.returncode}): "
            f"{' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders race harmlessly
    return out


def load_avro_native():
    """The compiled ``_avro_native`` module (``decode_block``,
    ``decode_training_block``), built first if needed."""
    global _module
    if _module is None:
        so = build()
        spec = importlib.util.spec_from_file_location(
            "photon_ml_tpu_torch.native._avro_native", so)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _module = mod
    return _module
