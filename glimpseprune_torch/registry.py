"""Generic named-component registries.

A copy of glimpseprune_tpu/registry.py, kept in the port so that the port
imports nothing of the JAX package; tests/test_torch_config.py holds the
two equal.

The reference wires its pluggable pieces (attention fusers, losses, dataset
mappers, score functions) through per-file decorator registries
(e.g. reference transformers_gp/models/qwen2_5_vl/model_gp.py:90-101,
train_qwen_gp.py:224-344).  We centralize that pattern in one small class so
every subsystem (fusers, compressors, losses, scorers, mappers) shares the
same semantics: register by name, optional base-class check, helpful errors.
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, Iterator, Optional, Type, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    """A string -> object registry with decorator-style registration."""

    def __init__(self, kind: str, base_cls: Optional[type] = None):
        self._kind = kind
        self._base_cls = base_cls
        self._items: Dict[str, T] = {}

    def register(self, name: Optional[str] = None) -> Callable[[T], T]:
        def decorator(obj: T) -> T:
            key = name if name is not None else getattr(obj, "__name__", None)
            if key is None:
                raise ValueError(f"Cannot infer a name for {obj!r}; pass one explicitly.")
            if key in self._items:
                raise ValueError(f"{self._kind} {key!r} already registered.")
            if self._base_cls is not None and isinstance(obj, type):
                if not issubclass(obj, self._base_cls):
                    raise TypeError(
                        f"{self._kind} {key!r} must subclass {self._base_cls.__name__}."
                    )
            self._items[key] = obj
            return obj

        return decorator

    def get(self, name: str) -> T:
        try:
            return self._items[name]
        except KeyError:
            raise KeyError(
                f"Unknown {self._kind} {name!r}. Available: {sorted(self._items)}"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def __iter__(self) -> Iterator[str]:
        return iter(self._items)

    def names(self):
        return sorted(self._items)

    def items(self):
        return self._items.items()
