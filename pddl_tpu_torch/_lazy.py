"""PEP 562 lazy exports for the port's packages: a public name resolves
to its module's attribute (or to the module itself) at first access, so
importing a package imports none of its modules and builds nothing."""

from __future__ import annotations

import importlib
from typing import Callable, Dict, Tuple


def lazy_exports(package: str, exports: Dict[str, str]
                 ) -> Tuple[Callable, Callable]:
    """``(__getattr__, __dir__)`` for ``package``. ``exports`` maps a
    public name to the module under ``package`` that defines it; a name
    equal to its module's last part is the module itself."""
    namespace = importlib.import_module(package).__dict__

    def __getattr__(name):
        try:
            module = exports[name]
        except KeyError:
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}") from None
        mod = importlib.import_module(f"{package}.{module}")
        value = mod if module.rsplit(".", 1)[-1] == name else getattr(
            mod, name)
        namespace[name] = value  # cache: the next access skips __getattr__
        return value

    def __dir__():
        return sorted(set(namespace) | set(exports))

    return __getattr__, __dir__
