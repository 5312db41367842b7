"""Quickstart: the paper's technique end to end (port of
``examples/quickstart.py``).

Trains an LM for approximate hardware (analog arrays of 16 with a 4-bit
ADC) with the paper's pipeline: error injection with a calibration batch
every ``calibrate_every`` steps, then a short bit-accurate fine-tune; then
compares the hardware-eval loss against deploying a model trained in
float directly.

  PYTHONPATH=src python -m repro_torch.launch.quickstart --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.quickstart --smoke   # on the card
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import AnalogParams, ApproxConfig, Backend, TrainConfig, TrainMode
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model
from repro_torch.models.model import resolve_device
from repro_torch.training import steps as step_lib


def step_key(s: int):
    """The reference's ``fold_in(PRNGKey(1), s)`` as a key path."""
    return (1, s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced smoke config")
    ap.add_argument("--steps", type=int, default=40, help="INJECT steps")
    ap.add_argument("--finetune-steps", type=int, default=8, help="MODEL steps")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    model = build_model(cfg)
    data = SyntheticLM(cfg.vocab_size, seq_len=args.seq_len, global_batch=args.batch, seed=0)
    steps, ft_steps = args.steps, args.finetune_steps

    approx = ApproxConfig(
        backend=Backend.ANALOG, mode=TrainMode.INJECT,
        analog=AnalogParams(array_size=16, adc_bits=4), calibrate_every=10,
    )
    tcfg = TrainConfig(total_steps=steps + ft_steps, warmup_steps=2, learning_rate=2e-3)

    # --- the paper's pipeline -------------------------------------------
    t0 = time.perf_counter()
    state = step_lib.init_train_state(model, 0, approx, tcfg, device=device)
    inject = step_lib.make_train_step(model, approx, tcfg, TrainMode.INJECT)
    finetune = step_lib.make_train_step(model, approx, tcfg, TrainMode.MODEL)
    calibrate = step_lib.make_calibration_step(model, approx, tcfg)
    for s in range(steps):
        if s % approx.calibrate_every == 0:
            state, _ = calibrate(state, data.batch_at(s), step_key(s))  # refresh error stats
        state, m = inject(state, data.batch_at(s), step_key(s))          # cheap forward
        if s % 10 == 0:
            print(f"[inject]   step {s:3d} loss {float(m['loss']):.4f}", flush=True)
    for s in range(steps, steps + ft_steps):
        state, m = finetune(state, data.batch_at(s), step_key(s))        # accurate forward
        print(f"[finetune] step {s:3d} loss {float(m['loss']):.4f}", flush=True)

    hw_eval = step_lib.make_eval_step(model, approx)
    ours = float(hw_eval(state, data.batch_at(999), (2,))["loss"])
    del state  # the baseline below needs the optimizer's memory

    # --- against deploying a float-trained model on the hardware ---------
    exact_state = step_lib.init_train_state(model, 0, approx, tcfg, device=device)
    exact = step_lib.make_train_step(model, ApproxConfig(), tcfg)
    for s in range(steps + ft_steps):
        exact_state, _ = exact(exact_state, data.batch_at(s), step_key(s))
    base = float(hw_eval(exact_state, data.batch_at(999), (2,))["loss"])
    print(f"\nhardware-eval loss — paper pipeline: {ours:.4f}  "
          f"float-then-deploy: {base:.4f}  ({time.perf_counter() - t0:.1f}s on {device})",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
