"""The numbers that decide `correct`, each against a limit of its own
(the cell's workload file states the limits and the readings they were
set from)."""
from __future__ import annotations

import torch


def image_gaps(program: dict, reference: dict) -> dict:
    """Widest and largest mean absolute gap over the compared frames."""
    widest, mean = 0.0, 0.0
    for k, ref in reference.items():
        d = (program[k].to(ref.device, torch.float32) - ref).abs()
        widest = max(widest, float(d.max()))
        mean = max(mean, float(d.mean()))
    return dict(image_max_gap=widest, image_mean_gap=mean)


def candidate_gaps(program: dict, reference: dict, preds: dict,
                   classes) -> dict:
    """cand_conf_gap: the widest gap between the two top-K confidence
    lists, each sorted; cand_box_gap: for each of the program's
    candidates, the reference's nearest prediction of the same class by
    the widest of |dx|, |dy|, |dw|, |dh| (pixels), and the widest of
    those over all candidates."""
    conf_gap, box_gap = 0.0, 0.0
    for k, ref in reference.items():
        cand = torch.as_tensor(program[k], dtype=torch.float32,
                               device=ref.device)
        pc = torch.sort(cand[:, 4], descending=True).values
        rc = torch.sort(ref[:, 4], descending=True).values
        conf_gap = max(conf_gap, float((pc - rc).abs().max()))
        pred = preds[k]
        scores = pred[:, 5:] * pred[:, 4:5]
        cls = scores.argmax(1).to(torch.float32)
        d = (cand[:, None, :4] - pred[None, :, :4]).abs().amax(2)
        d = torch.where(cand[:, None, 5] == cls[None, :], d,
                        torch.full_like(d, float("inf")))
        box_gap = max(box_gap, float(d.amin(1).max()))
    return dict(cand_conf_gap=conf_gap, cand_box_gap=box_gap)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}})."""
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in numbers.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
