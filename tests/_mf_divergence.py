"""How long the train-while-serve job of ``chip_smoke.py`` stays finite.

``phase_serving`` cycles a pool of 32 seeded 65,536-rating Zipf
microbatches through plain SGD at lr 0.01 over 100,000 users x 131,072
items, dim 64.  Duplicate items' deltas are summed, so the hottest rows
take large steps and the job goes non-finite once the pool has been cycled
long enough; the counted run's step count must stay below that.  This
script runs the same job in windows of 50 steps and prints, after each,
the largest |value| of the item table and of the user vectors, and the
first window whose tables are not finite.

    python tests/_mf_divergence.py --steps 900                  # the port, CPU
    python tests/_mf_divergence.py --steps 900 --device cuda    # the port, card
    JAX_PLATFORMS=cpu python tests/_mf_divergence.py --steps 900 --reference

``--reference`` runs the JAX package's job (``scatter_impl="xla"``)
instead of the port's.  Not collected by pytest: a full-width run takes
about a minute on a CPU.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (the job's shapes and its stream)

WINDOW = 50


def _port_job(device):
    import torch

    _, _, drv = cs._driver_parts(torch, torch.device(device))

    def read(result):
        return drv.store.values().double().abs().cpu().numpy(), result.worker_state.double().abs().cpu().numpy()

    return drv, read


def _reference_job():
    from flink_parameter_server_tpu import ShardedParamStore
    from flink_parameter_server_tpu.models.matrix_factorization import OnlineMatrixFactorization, SGDUpdater
    from flink_parameter_server_tpu.training.driver import DriverConfig, StreamingDriver
    from flink_parameter_server_tpu.utils.initializers import ranged_random_factor

    logic = OnlineMatrixFactorization(cs.NUM_USERS, cs.DIM_UNFUSED, updater=SGDUpdater(cs.LEARNING_RATE), seed=0)
    store = ShardedParamStore.create(cs.NUM_ITEMS, (cs.DIM_UNFUSED,),
                                     init_fn=ranged_random_factor(1, (cs.DIM_UNFUSED,)), scatter_impl="xla")
    drv = StreamingDriver(logic, store, config=DriverConfig(dump_model=False))

    def read(result):
        return np.abs(np.asarray(drv.store.values(), np.float64)), np.abs(np.asarray(result.worker_state, np.float64))

    return drv, read


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=900)
    ap.add_argument("--device", default="cpu", help="the port's device (cpu or cuda)")
    ap.add_argument("--reference", action="store_true", help="run the JAX package's job instead")
    args = ap.parse_args()

    drv, read = _reference_job() if args.reference else _port_job(args.device)
    pool = cs.zipf_stream(4, cs.SERVE_POOL)
    label = "reference (jax, xla)" if args.reference else f"port ({args.device}, pallas)"
    t0, step, first_bad = time.perf_counter(), 0, None
    while step < args.steps:
        n = min(WINDOW, args.steps - step)
        result = drv.run(pool[i % cs.SERVE_POOL] for i in range(step, step + n))
        step += n
        table, users = read(result)
        finite = bool(np.isfinite(table).all() and np.isfinite(users).all())
        if not finite and first_bad is None:
            first_bad = step
        print(f"mf_divergence: {label} step {step}: max |item| {table.max():.6g}, max |user| {users.max():.6g}, "
              f"finite {'yes' if finite else 'NO'} ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"mf_divergence: {label}: " + (f"first non-finite after the window ending at step {first_bad}"
                                        if first_bad else f"finite through {args.steps} steps"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
