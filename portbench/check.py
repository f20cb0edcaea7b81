"""The comparison that decides `correct`.

The plain reference (`reference.py`) recomputes, from the benchmark's own
inputs and weights, what the timed calls drawn from the seed produced:

  * a camera frame: its traversability map as it reached the host
    (`trav_gap`, the widest absolute gap over pixels), its confidence map
    (`conf_gap`, the mean absolute gap over pixels: the confidence map's
    widest gap swings with the width of its interval, which the last train
    step sets), the segment ids it wrote to the mission buffer
    (`seg_diff`, the share of pixels whose id differs), the pooled segment
    features it wrote (`feat_rel`, relative L2 over the segments both
    hold), and the head and confidence state it read (`swap_gap`, the
    widest gap to the learner's parameters and confidence state at the
    publish that made them; exact);
  * a supervision flush: the fused masks of its fan-out rows (`mask_diff`,
    the share of pixels that differ) and their per-segment signals
    (`signal_gap`, the widest absolute gap);
  * a train step: its loss (`loss_rel`, relative), each head leaf's
    change (`step_gap`: the worst leaf's gap between the two changes'
    norms, against the larger of the reference leaf's norm and the
    median leaf's; leaves whose reference gradient is under a thousandth
    of the median leaf's are left out) and the confidence state it left
    (`cg_gap`, the larger relative gap of its mean and its std).

The frame follows from the inputs and the head the frame read. That head
and its confidence state are tied to the learner by `swap_gap`: to the
seeded head and the initial confidence state before the first train step,
to the learner's state at each later publish, whose steps the sampled
ticks check. A flush's rows before it and a step's head, Adam moments,
confidence state and batch rows are the program's state, taken as the
calls found it (the reference follows the program step by step from
there).

Each number is the worst over the sampled calls, held against its limit
in `limits/<cell>.json`. A run with no sampled frame, or (with the
learner) no sampled flush or step, is not correct.
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference as ref

FRAME_NUMBERS = ("trav_gap", "conf_gap", "seg_diff", "feat_rel", "swap_gap")
LEARNER_NUMBERS = ("mask_diff", "signal_gap", "loss_rel", "step_gap", "cg_gap")


def _frame_numbers(out: dict, want: dict) -> dict:
    """out: maps (numpy) and a buffer row (or None); want: the reference's frame."""
    trav = torch.as_tensor(out["trav"], device=want["trav"].device).float()
    conf = torch.as_tensor(out["conf"], device=want["trav"].device).float()
    res = {"trav_gap": float((trav - want["trav"]).abs().max()),
           "conf_gap": float((conf - want["conf"]).abs().mean())}
    row = out.get("row")
    if row is not None:
        res["seg_diff"] = float((row["seg"].long() != want["seg"].long()).float().mean())
        both = row["feat_valid"] & want["feat_valid"]
        a, b = row["features"][both].float(), want["features"][both].float()
        res["feat_rel"] = float((a - b).norm() / b.norm().clamp_min(1e-30))
    return res


def _swap_gap(f: dict) -> float:
    """The widest gap between the head and confidence state a frame read
    and the learner's at the publish that made them (BIG where the head is
    none that the learner published)."""
    pub = f["pub"]
    if pub is None:
        return ref.BIG
    head = f["head"].state_dict()
    if set(head) != set(pub["params"]):
        return ref.BIG
    gaps = [float((head[k].float() - v.float()).abs().max()) for k, v in pub["params"].items()]
    return max(gaps + [float((a - b).abs().max()) for a, b in zip(f["cg"], pub["cg"])])


def _flush_numbers(out: dict, want: dict) -> dict:
    a, b = out["mask"], want["mask"]
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    differ = (fa != fb) | (fa & fb & (a != b))
    return {"mask_diff": float(differ.float().mean()),
            "signal_gap": float((out["signal"] - want["signal"]).abs().max()) if out["signal"].numel() else 0.0}


def _step_numbers(prog_loss, prog_change: dict, prog_cg, want: dict) -> dict:
    g = {k: float(v.norm()) for k, v in want["grads"].items()}
    med_g = float(np.median(list(g.values())))
    keep = [k for k in g if g[k] >= 1e-3 * med_g]
    ref_n = {k: float(want["change"][k].norm()) for k in keep}
    med = float(np.median(list(ref_n.values()))) if ref_n else 0.0
    gap = max((abs(float(prog_change[k].norm()) - ref_n[k]) / max(ref_n[k], med, 1e-30) for k in keep), default=0.0)
    lr = float(want["loss"])
    cg = max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
             for a, b in zip(prog_cg, (want["cg_mean"], want["cg_std"])))
    return {"loss_rel": abs(float(prog_loss) - lr) / max(abs(lr), 1e-30), "step_gap": gap, "cg_gap": cg}


def _worst(into: dict, new: dict) -> None:
    for k, v in new.items():
        into[k] = max(into.get(k, 0.0), v)


def compare(rec, cfg: dict, pipe, weights: dict, traffic, control: bool = False) -> tuple[dict, dict, dict]:
    """(numbers, counts, control numbers) over the recorder's samples, the
    frame's reference from the configuration's pipeline `pipe` with its
    `weights`. The control numbers put the reference in low precision in
    the program's place (empty unless `control`)."""
    hi, lo = ref.Prec(False), ref.Prec(True)
    dev = next(iter(weights["head"].values())).device
    nums, ctl = {}, {}
    for f in rec.frames:
        img = torch.as_tensor(traffic.event(f["event"]).images[f["camera"]], device=dev)
        head = {k: v.detach() for k, v in f["head"].state_dict().items()}
        want = pipe.frame(cfg, weights, head, f["cg"][0], f["cg"][1], img, hi)
        _worst(nums, {**_frame_numbers(f, want), "swap_gap": _swap_gap(f)})
        if control:
            low = pipe.frame(cfg, weights, head, f["cg"][0], f["cg"][1], img, lo)
            _worst(ctl, _frame_numbers({"trav": low["trav"].cpu().numpy(), "conf": low["conf"].cpu().numpy(),
                                        "row": low}, want))
        del want
    S, H = pipe.num_segments(cfg), cfg["image_size"]
    for fl in rec.flushes:
        r = fl["rows"]
        b = {k: v[torch.as_tensor(r, dtype=torch.long, device=v.device)] for k, v in fl["before"].items()}
        fp = torch.as_tensor(fl["footprint"], device=dev)
        want = ref.flush(b["mask"], b["K"], b["pose"], b["seg"], fp, fl["trav"], S, H, H, hi)
        _worst(nums, _flush_numbers(fl["after"], want))
        if control:
            _worst(ctl, _flush_numbers(ref.flush(b["mask"], b["K"], b["pose"], b["seg"], fp, fl["trav"], S, H, H, lo),
                                       want))
    for st in rec.steps:
        want = ref.train_step(cfg, st["before"], st["adam"], st["cg"][0], st["cg"][1], st["rows"], hi)
        change = {k: st["after"][k] - st["before"][k] for k in st["before"]}
        _worst(nums, _step_numbers(st["loss"], change, st["cg_after"], want))
        if control:
            low = ref.train_step(cfg, st["before"], st["adam"], st["cg"][0], st["cg"][1], st["rows"], lo)
            _worst(ctl, _step_numbers(low["loss"], low["change"], (low["cg_mean"], low["cg_std"]), want))
    counts = {"frames": len(rec.frames), "frames_with_row": sum(f["row"] is not None for f in rec.frames),
              "flushes": len(rec.flushes), "steps": len(rec.steps)}
    return nums, counts, ctl


def verdict(nums: dict, counts: dict, limits: dict, learner: bool) -> bool:
    """Every limited number read and within its limit, from at least one
    frame with a buffer row and (with the learner) one flush and one step."""
    if counts["frames_with_row"] == 0 or (learner and (counts["flushes"] == 0 or counts["steps"] == 0)):
        return False
    return all(name in nums and nums[name] <= limit for name, limit in limits.items())
