"""One-release deprecation shims — the counterpart of
``repro.deprecation``.

Every renamed/superseded entry point keeps working for one release behind
a :class:`DeprecationWarning` that fires exactly ONCE per process per
shim — a migration nudge, not log spam.  Tests reset the once-guard via
:func:`reset_warnings`.
"""
from __future__ import annotations

import warnings
from typing import Optional, Set

_WARNED: Set[str] = set()


def warn_once(key: str, message: str, *, stacklevel: int = 3) -> None:
    """Emit ``DeprecationWarning`` the first time ``key`` is seen."""
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(message, DeprecationWarning, stacklevel=stacklevel)


def reset_warnings(key: Optional[str] = None) -> None:
    """Forget emitted warnings (all, or one ``key``) — test hook."""
    if key is None:
        _WARNED.clear()
    else:
        _WARNED.discard(key)
