"""Host cost of the logistic loss's ``log(1 + exp(z))`` through
``ops/losses._Log1pExp`` (the autograd Function that gives JAX's
derivatives) against the same ops run directly, which is what
``_log1p_exp`` does for a tensor that does not require grad.

Prints one JSON line per measurement: the microseconds a call at
``--entries`` entries, and the milliseconds of an eager L-BFGS and an
eager TRON solve of a seeded logistic problem (rows x columns), each
with the loss run directly and forced through the Function. Best of
``--repeats`` timings; one torch thread.

    python -m photon_ml_tpu_torch.dev_scripts.loss_host_cost
    python -m photon_ml_tpu_torch.dev_scripts.loss_host_cost --device cuda
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from photon_ml_tpu_torch.ops import DenseFeatures, GLMObjective, losses
from photon_ml_tpu_torch.ops.glm_objective import make_batch
from photon_ml_tpu_torch.optimization import minimize_lbfgs, minimize_tron


def _best_ms(fn, repeats: int, device) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cpu")
    p.add_argument("--entries", type=int, default=64)
    p.add_argument("--calls", type=int, default=20000)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--shapes", default="200x8,5000x50")
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    device = torch.device(args.device)
    direct, function = losses._log1p_exp_value, losses._Log1pExp.apply
    z = torch.randn(args.entries, dtype=torch.float64, device=device)
    for name, fn in (("direct", direct), ("function", function)):
        ms = _best_ms(lambda: [fn(z) for _ in range(args.calls)],
                      args.repeats, device)
        print(json.dumps({"log1p_exp": name, "entries": args.entries,
                          "us_per_call": 1e3 * ms / args.calls}))
    rng = np.random.default_rng(0)
    obj = GLMObjective(losses.LogisticLoss)
    saved = losses._log1p_exp
    for shape in args.shapes.split(","):
        n, d = (int(v) for v in shape.split("x"))
        x = torch.as_tensor(rng.normal(size=(n, d)), device=device)
        y = torch.as_tensor((rng.random(n) < 0.5).astype(float),
                            device=device)
        batch = make_batch(DenseFeatures(x), y)
        x0 = torch.zeros(d, dtype=torch.float64, device=device)
        solves = {
            "lbfgs": lambda: minimize_lbfgs(
                obj.value_and_grad, x0, args=(batch, 1.0), tol=1e-9,
                max_iter=100),
            "tron": lambda: minimize_tron(
                obj.value_and_grad, x0, args=(batch, 1.0), tol=1e-9,
                max_iter=50, make_hvp=obj.make_tron_hvp)}
        for solver, solve in solves.items():
            row = {"solver": solver, "rows": n, "columns": d}
            for name, fn in (("direct", direct), ("function", function)):
                losses._log1p_exp = fn
                try:
                    row[f"{name}_ms"] = _best_ms(solve, args.repeats, device)
                finally:
                    losses._log1p_exp = saved
            print(json.dumps(row))


if __name__ == "__main__":
    main()
