"""Job parameter helpers — the ``ParameterTool`` analogue.

A copy of ``flink_parameter_server_tpu/utils/config.py``, which imports
no JAX: the port imports nothing of the JAX package, whose ``__init__``
imports JAX.  Modules it names that the port does not have yet are the
reference's.

Reference parity (SURVEY.md §2 #11, §5 "Config / flag system"): the
reference has no config system beyond constructor args; its examples parse
``ParameterTool``-style ``--key value`` argv and environment settings.
This is that surface for our examples/jobs: argv + env parsing into one
typed lookup, no third-party flag library.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence


def _norm(key: str) -> str:
    """``use_ring`` ≡ ``use-ring`` ≡ ``FPS_USE_RING`` — one key space
    regardless of spelling or source."""
    return key.replace("_", "-")


class Parameters:
    """Typed key/value lookup over ``--key value`` / ``--key=value`` argv
    pairs and (optionally) prefixed environment variables."""

    def __init__(self, values: Dict[str, str]):
        self._values = dict(values)

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_args(cls, argv: Sequence[str]) -> "Parameters":
        values: Dict[str, str] = {}
        i = 0
        args = list(argv)
        while i < len(args):
            arg = args[i]
            if not arg.startswith("--"):
                raise ValueError(f"expected --key, got {arg!r}")
            key = arg[2:]
            if "=" in key:
                # split BEFORE normalising so underscores in the value
                # (paths, run names) are untouched
                key, _, val = key.partition("=")
                values[_norm(key)] = val
            elif i + 1 < len(args) and not args[i + 1].startswith("--"):
                values[_norm(key)] = args[i + 1]
                i += 1
            else:
                values[_norm(key)] = "true"  # bare flag
            i += 1
        return cls(values)

    @classmethod
    def from_env(cls, prefix: str = "FPS_") -> "Parameters":
        # FPS_USE_RING → "use-ring": env underscores normalise to the
        # argv dash convention so the two sources share one key space
        return cls(
            {
                k[len(prefix):].lower().replace("_", "-"): v
                for k, v in os.environ.items()
                if k.startswith(prefix)
            }
        )

    def merged_with(self, other: "Parameters") -> "Parameters":
        """Right-hand side wins (e.g. env defaults overridden by argv)."""
        out = dict(self._values)
        out.update(other._values)
        return Parameters(out)

    # -- lookups ----------------------------------------------------------
    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self._values.get(_norm(key), default)

    def required(self, key: str) -> str:
        k = _norm(key)
        if k not in self._values:
            raise KeyError(f"missing required parameter --{key}")
        return self._values[k]

    def get_int(self, key: str, default: Optional[int] = None) -> Optional[int]:
        v = self._values.get(_norm(key))
        if v is None:
            return default
        try:
            return int(v)
        except ValueError as e:
            raise ValueError(f"--{key}: expected an integer, got {v!r}") from e

    def get_float(
        self, key: str, default: Optional[float] = None
    ) -> Optional[float]:
        v = self._values.get(_norm(key))
        if v is None:
            return default
        try:
            return float(v)
        except ValueError as e:
            raise ValueError(f"--{key}: expected a number, got {v!r}") from e

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self._values.get(_norm(key))
        if v is None:
            return default
        return v.strip().lower() in ("1", "true", "yes", "on")

    def keys(self) -> List[str]:
        return sorted(self._values)

    def __contains__(self, key: str) -> bool:
        return _norm(key) in self._values

    def __repr__(self) -> str:
        return f"Parameters({self._values!r})"


__all__ = ["Parameters"]
