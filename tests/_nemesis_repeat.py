"""How often one nemesis schedule passes when it is run again and again.

A schedule's faults land at round boundaries, but what they race with
(a resize re-seeding the replica chains, a promotion, a worker's push)
does not: a run can pass many times and fail once.  This script runs one
scenario of the port's corpus ``--runs`` times at the shape
``chip_smoke.py``'s ``phase_nemesis`` gives it (``sketch_full_stack`` at
the elastic phase's count-min width, ``ELASTIC_SKETCH``) and prints each
run's failing verdicts, then the count that passed.

    python tests/_nemesis_repeat.py --runs 15                  # CPU
    python tests/_nemesis_repeat.py --runs 15 --device cuda    # the card

Exits 1 when any run failed.  Not collected by pytest: a run takes about
ten seconds on either device.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (the phase's shape)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="sketch_full_stack")
    ap.add_argument("--runs", type=int, default=15)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)

    from flink_parameter_server_tpu_torch.nemesis import runner

    by_name = {s.name: s for s in runner.load_corpus()}
    s = dataclasses.replace(by_name[args.scenario], **cs.ELASTIC_SKETCH)
    passed = 0
    for i in range(args.runs):
        with tempfile.TemporaryDirectory(prefix="nemesis-repeat-") as tmp:
            t0 = time.perf_counter()
            r = runner.run_scenario(s, wal_root=tmp, device=args.device)
        bad = [(v.name, v.detail) for v in r.verdicts if not v.ok]
        passed += int(r.ok)
        print(f"repeat: {s.name} run {i}: ok {r.ok} in {time.perf_counter() - t0:.1f} s {bad}", flush=True)
    print(f"repeat: {s.name} at {cs.ELASTIC_SKETCH} on {args.device}: {passed} of {args.runs} passed")
    return 0 if passed == args.runs else 1


if __name__ == "__main__":
    sys.exit(main())
