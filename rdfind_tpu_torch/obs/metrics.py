"""The stats publish shims the port's pipeline calls.

Each shim applies one mutation to the caller's ``stats`` dict, with the key names
and value semantics of the JAX package's shims, and does nothing when ``stats`` is
None.  There is no process-wide registry: a run's statistics belong to the dict its
caller passed.
"""

from __future__ import annotations


def gauge_set(stats: dict | None, key: str, v) -> None:
    if stats is not None:
        stats[key] = v


def set_many(stats: dict | None, **kv) -> None:
    if stats is not None:
        stats.update(kv)


def struct_set(stats: dict | None, key: str, value) -> None:
    if stats is not None:
        stats[key] = value


def struct_update(stats: dict | None, key: str, **kv) -> None:
    if stats is not None:
        stats.setdefault(key, {}).update(kv)


def mapping_set(stats: dict | None, key: str, subkey, value) -> None:
    if stats is not None:
        stats.setdefault(key, {})[subkey] = value
