"""Validity-guarded transform composition.

Role of the reference ``CustomCompose`` (``pctl/transforms/compose.py``):
chain sample transforms and propagate ``None`` as soon as a sample dies
(a transform returned None or emptied the point set). Implemented as a
per-item fold — equivalent for the pure per-sample transforms used here,
and list inputs are normalized up front instead of re-checked at every
stage.

Copied from ``myria3d_tpu/pctl/transforms/compose.py``; imports point at the port.
"""

from typing import Callable, Sequence


def _alive(data) -> bool:
    return data is not None and data["pos"].shape[0] > 0


class CustomCompose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def _fold(self, data):
        for transform in self.transforms:
            data = transform(data)
            if not _alive(data):
                return None
        return data

    def __call__(self, data):
        if not isinstance(data, (list, tuple)):
            return self._fold(data)
        survivors = [out for out in map(self._fold, data) if out is not None]
        return survivors or None
