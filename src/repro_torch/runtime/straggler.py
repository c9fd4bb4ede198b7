"""Straggler mitigation: speculative re-execution of slow shards.

REX strata are bulk-synchronous (punctuation barrier), so one slow node
stalls every stratum — the same pathology MapReduce mitigates with
*backup tasks*.  The driver-side policy here: track per-shard stratum
latencies; when a shard's latency exceeds ``threshold ×`` the rolling
median, re-issue its stratum work to the shard's replica (which holds the
replicated mutable Δ state — paper §4.1's replica chain makes speculation
cheap) and take whichever finishes first.

On a cluster of cards the analogue is re-dispatching a shard's stratum to a
hot spare; the policy layer is identical, so it is implemented (and tested)
against the simulated per-shard timing model.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class SpeculationPolicy:
    threshold: float = 2.0        # p_shard > threshold × median ⇒ speculate
    min_history: int = 3          # strata before speculation activates
    max_concurrent: int = 2       # replicas a shard may be speculated on


class StragglerMitigator:
    """Feed per-stratum shard latencies; emits speculation decisions and
    accounts the wall-clock the barrier would have paid vs. did pay."""

    def __init__(self, num_shards: int,
                 policy: Optional[SpeculationPolicy] = None,
                 replicas_of: Optional[Callable[[int], List[int]]] = None):
        self.num_shards = num_shards
        self.policy = policy or SpeculationPolicy()
        self.replicas_of = replicas_of or (
            lambda s: [(s + 1) % num_shards])
        self.history: Dict[int, List[float]] = {s: []
                                                for s in range(num_shards)}
        self.speculated: List[dict] = []
        self.verified: List[dict] = []
        self.saved_time = 0.0
        self.strata = 0
        self.timeouts: Dict[int, int] = {}

    def note_timeout(self, shard: int) -> None:
        """An I/O timeout on this shard's replica path is a straggler
        signal: mark the shard so the next observed stratum treats it as
        over-threshold even when its compute latency alone would not
        trip the policy."""
        self.timeouts[shard] = self.timeouts.get(shard, 0) + 1

    def record_verification(self, shard: int, ok: bool,
                            stratum: int = -1) -> None:
        """Log the outcome of validating a speculation against the shard's
        replica chain: the resilient driver rebuilds the slow shard's
        mutable state from replicas ONLY and checks bit-equality with the
        live shard — the proof that the re-issued stratum work would have
        produced identical results had the replica won the race."""
        self.verified.append({"shard": shard, "ok": ok,
                              "stratum": stratum})

    def observe_stratum(self, latencies: List[float],
                        replica_latency: Optional[Callable[[int], float]]
                        = None) -> dict:
        """latencies[s] = shard s's stratum time.  replica_latency(s) =
        the time the replica would take (defaults to median).  Returns the
        stratum's barrier time with and without speculation."""
        self.strata += 1
        med = statistics.median(latencies)
        # Pending timeout flags (note_timeout) promote their shard to
        # straggler for THIS stratum: its effective latency is lifted
        # just past the speculation threshold, then the flag clears.
        flagged, self.timeouts = self.timeouts, {}
        latencies = [lat if s not in flagged
                     else max(lat, self.policy.threshold * med * 1.001)
                     for s, lat in enumerate(latencies)]
        barrier_without = max(latencies)
        effective = list(latencies)
        decisions = []
        if self.strata > self.policy.min_history:
            for s, lat in enumerate(latencies):
                if lat > self.policy.threshold * med:
                    rep = self.replicas_of(s)[0]
                    rep_lat = (replica_latency(s) if replica_latency
                               else med)
                    # Speculation launches when the threshold trips (at
                    # threshold×med elapsed); winner = min(original,
                    # launch-time + replica run).
                    launch = self.policy.threshold * med
                    effective[s] = min(lat, launch + rep_lat)
                    decisions.append({"shard": s, "replica": rep,
                                      "original": lat,
                                      "effective": effective[s]})
        for s, lat in enumerate(latencies):
            self.history[s].append(lat)
        barrier_with = max(effective)
        self.saved_time += barrier_without - barrier_with
        self.speculated.extend(decisions)
        return {"barrier_without": barrier_without,
                "barrier_with": barrier_with,
                "speculations": decisions}
