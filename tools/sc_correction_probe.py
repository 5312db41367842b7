#!/usr/bin/env python3
"""Where a chip-bound SC lane's corrected forward leaves the finite range,
at qwen2.5-3b full width on the card:

  python3 tools/sc_correction_probe.py [--chips 0,1] [--out FILE]

Builds the model's random weights (seed 0, as chip_smoke.py does) and a
fleet engine (``Fleet(2, seed=0)``, 2 slots), binds an SC lane to each
chip named (the bind fits its correction: a calibration pass on the
engine's probe batch against the exact matmul), then runs the corrected
probe forward with every corrected projection recorded in call order:
its site, the fitted ``scale`` and ``mean`` coefficients, max |x| of its
input, max |y| of its output before the correction, max |y| / scale,
max |correction| and whether the corrected output is finite.  Prints,
per chip, the sites fitted at the scale floor, the raw and corrected
probe losses and the first projections whose corrected output is not
finite; writes every record as JSON to ``--out``.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))


def _max(t) -> float:
    return float(t.detach().float().abs().nan_to_num(nan=float("inf")).max())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chips", default="0,1")
    ap.add_argument("--out", default="build/sc_correction_probe.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sc_correction_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ApproxConfig
    from repro_torch.core import approx_linear, calibration
    from repro_torch.hw import Fleet
    from repro_torch.models import build_model
    from repro_torch.runtime.engine import Engine, Request, resolve_approx

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = get_config("qwen2.5-3b")
    model = build_model(cfg)
    params = model.init(0, device=dev)
    approx = resolve_approx(Request(rid=0, prompt=(1,), backend="sc"), ApproxConfig())
    records, site = [], {}
    branch, predict = approx_linear._approx_branch, calibration.predict_mean

    def recording_branch(x, w, s, backend, ctx):
        site.update(name=s, x=_max(x))
        return branch(x, w, s, backend, ctx)

    def recording_predict(stats, y):
        m = predict(stats, y)
        scale = float(stats["scale"])
        corrected = y - m.to(y.dtype)
        records.append({
            "site": site["name"], "scale": scale,
            "mean": [float(c) for c in stats["mean"]], "max_x": site["x"], "max_y": _max(y),
            "max_t": _max(y) / scale, "max_correction": _max(m),
            "finite": bool(torch.isfinite(corrected).all()),
        })
        return m

    out = {}
    for chip_id in (int(c) for c in args.chips.split(",")):
        eng = Engine(model, params, n_slots=2, max_seq=256, fused=True, device=dev, seed=0,
                     fleet=Fleet(2, seed=0), probe_corrected=False)
        for i in range(chip_id + 1):
            lane = eng._new_lane(approx, i)  # binds chip i, fits its correction
        raw = lane.probe_losses[-1][1]
        records.clear()
        approx_linear._approx_branch = recording_branch
        calibration.predict_mean = recording_predict
        try:
            corrected = float(eng._probe_pass(lane, eng._next_rng(), True))
        finally:
            approx_linear._approx_branch = branch
            calibration.predict_mean = predict
        floor = sorted({r["site"] for r in records if r["scale"] <= calibration.SCALE_EPS})
        first_bad = [dict(r, index=i) for i, r in enumerate(records) if not r["finite"]][:3]
        print(json.dumps({"chip": chip_id, "raw_probe_loss": raw, "corrected_probe_loss":
                          corrected, "projections": len(records), "at_scale_floor":
                          sum(r["scale"] <= calibration.SCALE_EPS for r in records),
                          "floor_sites": floor, "first_not_finite": first_bad}), flush=True)
        if first_bad:
            i = first_bad[0]["index"]
            for r in records[max(0, i - 8):i]:
                print("  before:", json.dumps(r), flush=True)
        out[chip_id] = list(records)
        del eng, lane
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
