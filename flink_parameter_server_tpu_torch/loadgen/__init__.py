"""loadgen — open-loop million-user traffic + the overload-control plane.

Counterpart of ``flink_parameter_server_tpu/loadgen/``, all of it ported
(docs/loadgen.md):

  * :mod:`.arrivals` — seeded open-loop arrival schedules (Poisson
    thinning over diurnal / ramp / flash-crowd rate curves), so
    coordinated omission cannot hide stalls; bitwise the reference's
    for the same seed;
  * :mod:`.population` — a Zipf user/item population with regional
    train/serve traffic mixes;
  * :mod:`.overload` — the graceful-degradation toolkit: shard- and
    serving-edge load shedding (``err overloaded``), client retry
    budgets, per-shard circuit breakers, and brownout (widened
    hot-cache staleness instead of errors);
  * :mod:`.soak` — the :class:`~.soak.SoakRunner` driving the full
    replicated+elastic stack with the nemesis mesh underneath, plus the
    goodput ledger and the autoscaler-quality score; its shards' slices
    live on ``device=`` (the card unless the caller passes
    ``device="cpu"``).

``soak`` pulls in the whole cluster stack; it is imported lazily so
``from ..loadgen.overload import OverloadedError`` stays cheap inside
``cluster/client.py`` (no import cycle through the package).
"""
from .arrivals import (
    constant_rate,
    diurnal_rate,
    flash_crowds,
    poisson_arrivals,
    ramp_rate,
    split_slots,
)
from .overload import (
    PRIORITY_CRITICAL,
    PRIORITY_NORMAL,
    PRIORITY_SHEDDABLE,
    BreakerBoard,
    BrownoutController,
    CircuitBreaker,
    LoadShedder,
    OverloadedError,
    OverloadGuard,
    RetryBudget,
    RetryBudgetExhausted,
)
from .population import Region, Request, UserPopulation

_LAZY = {
    "GoodputLedger", "SoakConfig", "SoakReport", "SoakRunner",
    "autoscaler_score", "run_soak",
}


def __getattr__(name):
    if name in _LAZY:
        from . import soak

        return getattr(soak, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "BreakerBoard",
    "BrownoutController",
    "CircuitBreaker",
    "GoodputLedger",
    "LoadShedder",
    "OverloadGuard",
    "OverloadedError",
    "PRIORITY_CRITICAL",
    "PRIORITY_NORMAL",
    "PRIORITY_SHEDDABLE",
    "Region",
    "Request",
    "RetryBudget",
    "RetryBudgetExhausted",
    "SoakConfig",
    "SoakReport",
    "SoakRunner",
    "UserPopulation",
    "autoscaler_score",
    "constant_rate",
    "diurnal_rate",
    "flash_crowds",
    "poisson_arrivals",
    "ramp_rate",
    "run_soak",
    "split_slots",
]
