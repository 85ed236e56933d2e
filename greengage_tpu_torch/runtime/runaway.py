"""Runaway statements — the part of greengage_tpu/runtime/runaway.py that
the interrupt registry needs: the typed ``RunawayCancelled``.

The rest of the JAX module is the vmem tracker and the red-zone cleaner
(``TRACKER``): it ledgers every in-flight statement's device bytes and
flags the heaviest one when the total crosses the red zone. It needs the
device memory accounting of ``runtime/memaccount.py`` and waits for it
(ROADMAP Queue 1 item 7). Until then nothing in the port raises
``RunawayCancelled``; a ``runaway`` cause set by hand on a statement's
context (``REGISTRY.cancel(id, "runaway")``) raises it as the JAX package
does.
"""

from __future__ import annotations

from greengage_tpu_torch.runtime.interrupt import StatementCancelled


class RunawayCancelled(StatementCancelled):
    """The statement was chosen by the runaway cleaner. A
    StatementCancelled with cause 'runaway': the cleaner is one producer
    of the unified per-statement interrupt flag (runtime/interrupt.py),
    so sessions count and surface it like every other cancellation."""

    def __init__(self, message: str):
        super().__init__(message, "runaway")
