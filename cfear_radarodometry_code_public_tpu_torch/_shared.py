"""The reference package's framework-free modules, loaded by file path.

`cfear_radarodometry_code_public_tpu/__init__.py` imports `jax`, so
importing any of its modules the normal way pulls JAX in, and the machine
that runs this port has no JAX. The four modules below import only the
standard library and numpy; they are loaded straight from their files with
`importlib.util.spec_from_file_location`, without running the reference
package's `__init__`. One source of truth, no copies:

- `config`: `CFEARConfig`, `preset` and the sub-configs;
- `synthetic`: the synthetic radar world and sequence renderer;
- `native_io`: the native host filter over `native/cfear_io.cpp` (it finds
  the C++ source from its own `__file__`, which the loader sets to the real
  path);
- `kitti`: the KITTI drift evaluator.
"""

from __future__ import annotations

import importlib.util
import os
import sys

_REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "cfear_radarodometry_code_public_tpu")


def _load(name: str, relpath: str):
    modname = f"{__name__}.{name}"
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(
        modname, os.path.join(_REF, relpath))
    mod = importlib.util.module_from_spec(spec)
    # dataclasses resolves string annotations through sys.modules
    sys.modules[modname] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[modname]
        raise
    return mod


config = _load("config", "config.py")
synthetic = _load("synthetic", os.path.join("datasets", "synthetic.py"))
native_io = _load("native_io", os.path.join("utils", "native_io.py"))
kitti = _load("kitti", os.path.join("eval", "kitti.py"))
