"""Native (C) runtime components, built on demand with the system C
compiler.

Each extension is built from its source into `_build/`, under a file name
that carries a hash of the source, so a binary is never used with a
source other than the one it was built from.  When a build or load fails
the loader warns, records the reason in `BUILD_ERRORS` and returns None;
the callers then run the Python engines (about 21x slower for CABAC).

Set VTM_NO_NATIVE=1 to force the pure-Python paths.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import warnings

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "_build")

# name -> why the native engine is unavailable (build or load error)
BUILD_ERRORS: dict[str, str] = {}


def built_path(name: str, sources: list[str]) -> str:
    """Path of the extension built from the current `sources`."""
    h = hashlib.sha256()
    for s in sources:
        with open(os.path.join(_DIR, s), "rb") as f:
            h.update(f.read())
    tag = sysconfig.get_config_var("SOABI") or "cpython"
    return os.path.join(BUILD_DIR, f"_{name}-{h.hexdigest()[:16]}.{tag}.so")


def _build(name: str, sources: list[str]) -> str:
    so = built_path(name, sources)
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # build under a private name, then rename: concurrent processes
        # never load a half-written library
        tmp = f"{so}.{os.getpid()}.tmp"
        cc = os.environ.get("CC", "cc")
        inc = sysconfig.get_paths()["include"]
        srcs = [os.path.join(_DIR, s) for s in sources]
        subprocess.run([cc, "-O3", "-shared", "-fPIC", f"-I{inc}", *srcs,
                        "-o", tmp], check=True, capture_output=True, text=True)
        os.replace(tmp, so)
    return so


def _load(name: str, sources: list[str]):
    if os.environ.get("VTM_NO_NATIVE"):
        return None
    try:
        so = _build(name, sources)
        spec = importlib.util.spec_from_file_location(f"_{name}", so)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    except (OSError, ImportError, subprocess.CalledProcessError) as e:
        why = (e.stderr or str(e)) if isinstance(
            e, subprocess.CalledProcessError) else str(e)
        BUILD_ERRORS[name] = why
        warnings.warn(f"native {name} unavailable, using the Python "
                      f"engine: {why}", RuntimeWarning, stacklevel=3)
        return None
    BUILD_ERRORS.pop(name, None)
    return mod


def load_cabac():
    """The _cabac_native module (CABAC engine + residual bit estimator),
    built from cabac.c; None if disabled or the build fails."""
    return _load("cabac_native", ["cabac.c"])


def load_tcq():
    """The _tcq_native module (batched TCQ scan, the native twin of
    encoder/tcq_scan.py); None if disabled or the build fails."""
    return _load("tcq_native", ["tcq.c"])


def load_depquant():
    """The _depquant_native module; None if disabled or the build fails."""
    return _load("depquant_native", ["depquant.c"])
