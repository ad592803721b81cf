"""Base class of the port's containers: dataclasses of tensors that move
between devices as a whole, and that can be read from a gfxexp_tpu object
with the same class name and fields."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_REGISTRY: dict = {}


def _move(v, device):
    if isinstance(v, (torch.Tensor, TensorData)):
        return v.to(device)
    if isinstance(v, tuple):
        return tuple(_move(x, device) for x in v)
    return v


class TensorData:
    """Mixin for `@dataclass` containers whose fields are tensors, nested
    containers (alone or in tuples), None, or plain Python metadata
    (ints)."""

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        _REGISTRY[cls.__name__] = cls

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: _move(getattr(self, f.name), device)
            for f in dataclasses.fields(self)})

    @property
    def device(self) -> torch.device:
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, TensorData)):
                return v.device
        raise ValueError(f"{type(self).__name__} holds no tensor")

    @classmethod
    def _adapt(cls, fields: dict) -> dict:
        """Hook for from_numpy: reshape fields whose layout differs from the
        JAX object's."""
        return fields


def from_numpy(obj):
    """Convert a gfxexp_tpu container (or any object whose class name
    matches a port container) into the port's container on the CPU, reading
    each field by attribute name. Arrays are copied; Python metadata (ints)
    is kept; fields the JAX object lacks become None."""
    if obj is None:
        return None
    if isinstance(obj, (bool, int, float, str)):
        return obj
    cls = _REGISTRY.get(type(obj).__name__)
    if cls is None:
        return torch.from_numpy(np.array(obj))
    fields = {f.name: from_numpy(getattr(obj, f.name, None))
              for f in dataclasses.fields(cls)}
    return cls(**cls._adapt(fields))
