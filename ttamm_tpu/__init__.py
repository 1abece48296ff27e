"""The package's former import name, kept so that existing imports work.

The package is :mod:`ttamm`. Importing this name, or any submodule under
it, warns with a ``DeprecationWarning`` and returns the :mod:`ttamm`
module itself: ``<this name>.pipelines is ttamm.pipelines``, so classes,
registries and module state are shared, never loaded twice.
"""

from __future__ import annotations

import importlib
import importlib.abc
import importlib.util
import sys
import warnings

import ttamm

_NEW = ttamm.__name__


class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<this name>.X`` to the already-importable ``ttamm.X``."""

    def __init__(self) -> None:
        self._specs: dict[str, object] = {}

    def find_spec(self, fullname, path=None, target=None):
        if not fullname.startswith(__name__ + "."):
            return None
        return importlib.util.spec_from_loader(fullname, self)

    def create_module(self, spec):
        module = importlib.import_module(_NEW + spec.name[len(__name__):])
        # The import system stamps the alias spec onto the module it gets
        # back; keep the real one to restore in exec_module.
        self._specs[spec.name] = module.__spec__
        return module

    def exec_module(self, module) -> None:
        module.__spec__ = self._specs.pop(module.__spec__.name)


if not any(isinstance(f, _AliasFinder) for f in sys.meta_path):
    sys.meta_path.insert(0, _AliasFinder())

warnings.warn(
    f"'{__name__}' is a deprecated alias of '{_NEW}'; import '{_NEW}' instead",
    DeprecationWarning,
    stacklevel=2,
)


def __getattr__(name: str):
    return getattr(ttamm, name)
