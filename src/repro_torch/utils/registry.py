"""Tiny string -> factory registry used for policies, archs and kernels."""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator


class Registry:
    """A named mapping from string keys to factories.

    Used for scheduler policies (``POLICIES``), architecture configs
    (``ARCHS``) and benchmark tables so CLIs can select them by name.
    """

    def __init__(self, name: str):
        self.name = name
        self._items: Dict[str, Any] = {}

    def register(self, key: str, obj: Any = None) -> Callable[[Any], Any]:
        if obj is not None:
            self._register(key, obj)
            return obj

        def deco(fn: Any) -> Any:
            self._register(key, fn)
            return fn

        return deco

    def _register(self, key: str, obj: Any) -> None:
        if key in self._items:
            raise KeyError(f"{self.name}: duplicate key {key!r}")
        self._items[key] = obj

    def __getitem__(self, key: str) -> Any:
        try:
            return self._items[key]
        except KeyError:
            raise KeyError(
                f"{self.name}: unknown key {key!r}. "
                f"Available: {sorted(self._items)}"
            ) from None

    def __contains__(self, key: str) -> bool:
        return key in self._items

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._items))

    def keys(self):
        return sorted(self._items)

    def items(self):
        return sorted(self._items.items())
