"""Faults planted in the timed path, for the tests that see ``correct`` come
out false and for reading a fault's numbers on the card
(``control.py --fault``). Each takes a ``monkeypatch``-like object with
``setattr(owner, name, value)``; none is used by a benchmark run.

- ``altered_answer``: the predict step's full-cloud logits altered where
  they are produced (the first class's logit of one point a quarter
  into the first cloud's full-cloud rows, which is real and inside its
  subtile, moved by half the largest logit);
- ``unchanged_state``: a train step that leaves the model's parameters as
  they were;
- ``half_batch``: a train step on the first half of the batch, its mean
  taken over those rows only.
"""

from __future__ import annotations

import torch


def altered_answer(patch) -> None:
    from myria3d_tpu_torch.models.model import Model

    step = Model.interp_step

    def altered(self, *a, **k):
        out = step(self, *a, **k).clone()
        out[0, out.shape[1] // 4, 0] += 0.5 * out.abs().max()
        return out

    patch.setattr(Model, "interp_step", altered)


def unchanged_state(patch) -> None:
    from myria3d_tpu_torch.models.model import Model

    step = Model.train_step

    def frozen(self, *a, **k):
        before = {n: p.detach().clone() for n, p in self.net.named_parameters()}
        out = step(self, *a, **k)
        with torch.no_grad():
            for n, p in self.net.named_parameters():
                p.copy_(before[n])
        return out

    patch.setattr(Model, "train_step", frozen)


def half_batch(patch) -> None:
    from myria3d_tpu_torch.models.model import Model

    step = Model.train_step

    def half(self, x, pos, y, mask, generator=None):
        h = x.shape[0] // 2
        return step(self, x[:h], pos[:h], y[:h], mask[:h], generator)

    patch.setattr(Model, "train_step", half)


class Patch:
    """``setattr`` that lasts for the process (``control.py``)."""

    @staticmethod
    def setattr(owner, name, value) -> None:
        setattr(owner, name, value)
