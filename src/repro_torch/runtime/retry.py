"""Deterministic retry/timeout/backoff for recovery-path I/O.

Every disk touch on the recovery path — checkpoint reads, journal
writes, replica restores — can fail transiently (NFS hiccup, a replica
mid-rebuild, a file being replaced under the reader) or hang.  The
chaos layer demands that all of them be (a) retried under a *bounded*
budget, (b) backed off deterministically so a seeded chaos schedule
replays bit-identically, and (c) reported upward instead of hanging the
punctuation barrier: a per-operation timeout is a *straggler signal*,
fed to the existing ``SpeculationPolicy`` so a slow replica read
triggers the same speculative re-issue a slow stratum does.

Design points:

  * **Seeded jitter.**  Backoff jitter is derived from
    ``crc32(seed, op, attempt)`` — not the process RNG — so two runs of
    the same chaos schedule sleep identically and interleave replays
    identically.  (``hash()`` is salted per process; never use it here.)
  * **Shared budget.**  ``RetryBudget`` caps total retry *attempts* and
    total *recoveries* across one resilient run; exhausting either
    raises :class:`RecoveryExhausted`, the signal the view layer turns
    into graceful degradation (serve the last converged snapshot with
    staleness metadata) instead of an exception to the user.
  * **Injectable clock/sleep.**  Tests and the chaos harness pass
    ``sleep=lambda s: None`` — the schedule of attempts is what matters,
    not wall time.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Callable, Optional, Sequence


class OperationTimeout(TimeoutError):
    """One attempt exceeded the policy's per-operation timeout."""

    def __init__(self, op: str, elapsed: float, timeout: float,
                 shard: Optional[int] = None):
        super().__init__(
            f"operation {op!r} took {elapsed:.3f}s "
            f"(timeout {timeout:.3f}s)")
        self.op = op
        self.elapsed = elapsed
        self.timeout = timeout
        self.shard = shard


class RecoveryExhausted(RuntimeError):
    """The retry/recovery budget ran out before the run could be healed.

    Carries enough context for the caller to degrade gracefully: what
    exhausted (``kind`` is "attempts" or "recoveries"), the per-event
    history, and the last underlying error.
    """

    def __init__(self, kind: str, op: str, attempts: int,
                 last_error: Optional[BaseException] = None,
                 events: Optional[list] = None):
        super().__init__(
            f"recovery budget exhausted ({kind}) during {op!r} "
            f"after {attempts} attempt(s)"
            + (f": {last_error!r}" if last_error else ""))
        self.kind = kind
        self.op = op
        self.attempts = attempts
        self.last_error = last_error
        self.events = events or []


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Budgeted attempts + exponential backoff + seeded jitter + timeout.

    ``backoff(attempt)`` for attempt k (0-based) is
    ``min(base_delay * 2**k, max_delay)`` scaled by a deterministic
    jitter factor in ``[1 - jitter, 1 + jitter]``.
    """

    max_attempts: int = 3         # attempts per operation (>= 1)
    base_delay: float = 0.005     # first backoff, seconds
    max_delay: float = 0.5        # backoff ceiling, seconds
    jitter: float = 0.5           # +/- fraction of the backoff randomized
    timeout: Optional[float] = None   # per-attempt wall budget (None = off)
    seed: int = 0                 # jitter stream seed

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"RetryPolicy.max_attempts must be >= 1, got "
                f"{self.max_attempts}")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(
                f"RetryPolicy.jitter must be in [0, 1), got {self.jitter}")

    def backoff(self, op: str, attempt: int) -> float:
        raw = min(self.base_delay * (2.0 ** attempt), self.max_delay)
        # Deterministic per-(seed, op, attempt) jitter: two processes
        # replaying the same chaos schedule back off identically.
        h = zlib.crc32(f"{self.seed}:{op}:{attempt}".encode())
        unit = (h % 10_000) / 10_000.0               # [0, 1)
        return raw * (1.0 - self.jitter + 2.0 * self.jitter * unit)


class RetryBudget:
    """Run-wide caps shared by every retried operation of one driver.

    ``max_attempts`` bounds total retry attempts (first tries are free —
    only re-attempts draw down); ``max_recoveries`` bounds how many
    recovery actions (shard restores / restarts) one run may perform.
    Either cap set to ``None`` means unbounded.
    """

    def __init__(self, max_attempts: Optional[int] = None,
                 max_recoveries: Optional[int] = None):
        self.max_attempts = max_attempts
        self.max_recoveries = max_recoveries
        self.attempts_used = 0
        self.recoveries_used = 0

    def draw_attempt(self, op: str,
                     last_error: Optional[BaseException] = None) -> None:
        self.attempts_used += 1
        if self.max_attempts is not None \
                and self.attempts_used > self.max_attempts:
            # "budget:" prefix distinguishes the SHARED budget running
            # out (unrecoverable — must propagate to the degradation
            # layer) from one operation's local attempts running out
            # (recoverable — the driver falls back to restart).
            raise RecoveryExhausted("budget:attempts", op,
                                    self.attempts_used,
                                    last_error=last_error)

    def draw_recovery(self, op: str) -> None:
        self.recoveries_used += 1
        if self.max_recoveries is not None \
                and self.recoveries_used > self.max_recoveries:
            raise RecoveryExhausted("budget:recoveries", op,
                                    self.recoveries_used)

    def snapshot(self) -> dict:
        return {"attempts_used": self.attempts_used,
                "recoveries_used": self.recoveries_used,
                "max_attempts": self.max_attempts,
                "max_recoveries": self.max_recoveries}


#: Exceptions worth retrying on the checkpoint I/O path.  ``zipfile``
#: raises ``BadZipFile`` (a subclass of Exception via OSError? no —
#: ValueError) on torn npz reads; numpy re-raises them as ValueError /
#: EOFError depending on where the truncation lands; OSError covers the
#: filesystem class.  KeyError covers an npz missing an expected array
#: (half-written archive).
IO_RETRYABLE: tuple = (OSError, ValueError, EOFError, KeyError,
                      OperationTimeout)


class Retrier:
    """Callable wrapper applying one :class:`RetryPolicy` (plus an
    optional shared :class:`RetryBudget`) to recovery-path operations.

    ``on_event(dict)`` observes every retry/timeout — the resilient
    driver forwards these to its tracer/metrics, and timeout events with
    a ``shard`` feed the straggler speculation policy.
    """

    def __init__(self, policy: Optional[RetryPolicy] = None,
                 budget: Optional[RetryBudget] = None,
                 on_event: Optional[Callable[[dict], None]] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.perf_counter):
        self.policy = policy or RetryPolicy()
        self.budget = budget
        self.on_event = on_event
        self.sleep = sleep
        self.clock = clock
        self.events: list[dict] = []
        self.timeouts: list[dict] = []

    def _emit(self, ev: dict) -> None:
        self.events.append(ev)
        if ev.get("kind") == "timeout":
            self.timeouts.append(ev)
        if self.on_event is not None:
            self.on_event(ev)

    def call(self, fn: Callable, *args, op: str = "io",
             shard: Optional[int] = None,
             retryable: Sequence[type] = IO_RETRYABLE, **kwargs):
        """Run ``fn(*args, **kwargs)`` under the policy.

        Raises :class:`RecoveryExhausted` when per-op attempts or the
        shared budget run out; re-raises non-retryable errors as-is.
        """
        last: Optional[BaseException] = None
        for attempt in range(self.policy.max_attempts):
            t0 = self.clock()
            try:
                out = fn(*args, **kwargs)
            except tuple(retryable) as e:
                last = e
            else:
                elapsed = self.clock() - t0
                if self.policy.timeout is not None \
                        and elapsed > self.policy.timeout:
                    # The attempt *finished* but blew its deadline: the
                    # result is good, but the slowness itself is signal —
                    # report it (speculation feed) and return the value.
                    self._emit({"kind": "timeout", "op": op,
                                "shard": shard, "attempt": attempt,
                                "elapsed_s": elapsed,
                                "timeout_s": self.policy.timeout})
                return out
            # retry path
            if attempt + 1 >= self.policy.max_attempts:
                break
            if self.budget is not None:
                self.budget.draw_attempt(op, last_error=last)
            delay = self.policy.backoff(op, attempt)
            self._emit({"kind": "retry", "op": op, "shard": shard,
                        "attempt": attempt, "delay_s": delay,
                        "error": type(last).__name__})
            self.sleep(delay)
        raise RecoveryExhausted("attempts", op, self.policy.max_attempts,
                                last_error=last, events=self.events[-3:])

    def drain_timeouts(self) -> list[dict]:
        """Return and clear timeout events (the speculation feed)."""
        out = list(self.timeouts)
        self.timeouts.clear()
        return out
