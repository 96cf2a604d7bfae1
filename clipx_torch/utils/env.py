"""Environment-variable hygiene helpers (the port's copy of
``clipx.utils.env``).

Many knobs are ``CLIPX_*`` environment variables. Tool ``main()``s are also
library API (the tests import and call them), so a mutation that leaks out
of one changes every later caller in the process. These helpers give the
tools and the tests one way to set a knob for a block and restore it, and
to report any drift of the ``CLIPX_*`` namespace.
"""

from __future__ import annotations

import os


def snapshot(prefix: str = "CLIPX_") -> dict:
    """Capture the current values of every env var with ``prefix``."""
    return {k: v for k, v in os.environ.items() if k.startswith(prefix)}


def diff(before: dict, prefix: str = "CLIPX_") -> str:
    """Describe how the ``prefix`` env namespace drifted since
    ``before`` (a ``snapshot()``).  Returns "" when clean; otherwise a
    human-readable summary naming each added/removed/changed key, so a
    test harness can fail the *polluting* test rather than a victim
    nine tests later.
    """
    after = snapshot(prefix)
    parts = []
    for k in sorted(set(before) | set(after)):
        if k not in before:
            parts.append(f"added {k}={after[k]!r}")
        elif k not in after:
            parts.append(f"removed {k} (was {before[k]!r})")
        elif before[k] != after[k]:
            parts.append(f"changed {k}: {before[k]!r} -> {after[k]!r}")
    return "; ".join(parts)


class restoring:
    """Context manager: set env vars for the body, restore exact prior
    state (including absence) on exit.  The canonical way for a tool to
    flip a ``CLIPX_*`` knob temporarily::

        with restoring(CLIPX_CODES="refresh"):
            ...
    """

    def __init__(self, **kv):
        self._kv = kv
        self._prev = {}

    def __enter__(self):
        for k, v in self._kv.items():
            self._prev[k] = os.environ.get(k)
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, old in self._prev.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
        return False
