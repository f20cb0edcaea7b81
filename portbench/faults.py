"""Faults planted in the program, for the readings that set the check's
limits and for the tests that show the check catches them. None is ever
planted in a measured run: only `run.py --fault <name>` and the tests
plant one.

  * frozen_step: the train step computes its loss and leaves the head as
    it was (a step that returns its state unchanged);
  * frozen_masks: the flush writes its signals and leaves the supervision
    masks as they were (the same, for the flush);
  * half_batch: the train step takes half of the sampled nodes, its mean
    over the rest;
  * half_cameras: image_batch_callback runs the first half of its cameras
    twice, in place of all of them;
  * altered_answer: a frame's traversability map is altered where the
    runtime hands it to the host (a 4 x 4 block at its centre moved by
    0.5, modulo 1);
  * stale_swap: the hot swap publishes the learner's parameters and
    confidence state as the previous swap found them.
"""

from __future__ import annotations

import numpy as np

NAMES = ("frozen_step", "frozen_masks", "half_batch", "half_cameras", "altered_answer", "stale_swap")


def plant(name: str) -> list:
    """Patch the port's classes; returns the handles `unplant` restores."""
    from wild_visual_navigation_tpu_torch.runtime.runtime import InferenceResult, WVNRuntime
    from wild_visual_navigation_tpu_torch.traversability.estimator import TraversabilityEstimator as TE

    if name == "frozen_step":
        step = TE._train_step

        def fault(self, idx):
            keep = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
            out = step(self, idx)
            self.model.load_state_dict(keep)
            return out

        target = (TE, "_train_step")
    elif name == "frozen_masks":
        reproject = TE._reproject_update

        def fault(self, idx, footprint, trav):
            masks = self.buffer.supervision_mask.clone()
            out = reproject(self, idx, footprint, trav)
            self.buffer.supervision_mask.copy_(masks)
            return out

        target = (TE, "_reproject_update")
    elif name == "half_batch":
        batch = TE._batch

        def fault(self, idx, split=True):
            return batch(self, np.asarray(idx)[: max(1, len(idx) // 2)], split)

        target = (TE, "_batch")
    elif name == "half_cameras":
        body = WVNRuntime._image_batch_callback_body

        def fault(self, imgs, *a):
            return body(self, np.concatenate([imgs[: len(imgs) // 2]] * 2), *a)

        target = (WVNRuntime, "_image_batch_callback_body")
    elif name == "altered_answer":
        to_numpy = InferenceResult.to_numpy

        def fault(self, *a, **k):
            trav, conf = to_numpy(self, *a, **k)
            trav = trav.copy()
            r, c = trav.shape[0] // 2, trav.shape[1] // 2
            trav[r:r + 4, c:c + 4] = (trav[r:r + 4, c:c + 4] + 0.5) % 1.0
            return trav, conf

        target = (InferenceResult, "to_numpy")
    elif name == "stale_swap":
        snapshot = TE.state_dict_for_hot_swap

        def fault(self):
            new = snapshot(self)
            old = getattr(self, "_stale_swap_previous", new)
            self._stale_swap_previous = new
            return old

        target = (TE, "state_dict_for_hot_swap")
    else:
        raise ValueError(f"unknown fault {name!r}; have {NAMES}")
    original = getattr(*target)
    setattr(*target, fault)
    return [(target, original)]


def unplant(handles: list) -> None:
    for (owner, attr), original in handles:
        setattr(owner, attr, original)
