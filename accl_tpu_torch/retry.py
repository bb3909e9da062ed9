"""Call-level retry policies: whole calls re-executed when a failure
surfaces.

The port of ``accl_tpu/retry.py``. A policy must be UNIFORM across the
ranks of a communicator, like the collectives themselves: every rank of
a failed collective sees its own failure, retries, and the attempts line
up. The backoff's jitter is a deterministic function of (comm id,
attempt), so every rank computes the same delay; :func:`mix_unit` is a
private copy of the reference's (``accl_tpu/emulator/reliability.py``),
so the delays are bit for bit the reference's.

``CALL_OUTCOME_UNKNOWN`` is not retried by default (the call may have
succeeded); ``PEER_FAILED`` and ``DATA_INTEGRITY_ERROR`` never are.
"""

from __future__ import annotations

import dataclasses

from .constants import ErrorCode

# What a policy retries by default: failures whose cause may pass (a
# peer late to its deadline, backpressure). JOIN_FAILED is included: a
# joiner may still be starting when the first handshake gives up.
DEFAULT_RETRYABLE = (int(ErrorCode.RECEIVE_TIMEOUT_ERROR)
                     | int(ErrorCode.FABRIC_QUEUE_OVERFLOW)
                     | int(ErrorCode.RECEIVE_OFFCHIP_SPARE_BUFF_OVERFLOW)
                     | int(ErrorCode.PACK_TIMEOUT_STS_ERROR)
                     | int(ErrorCode.JOIN_FAILED))


def _mix(*parts: int) -> int:
    """Deterministic 64-bit mix of the parts (the reference's ``_mix``)."""
    h = 0x9E3779B97F4A7C15
    for p in parts:
        h ^= (p & 0xFFFFFFFFFFFFFFFF) + 0x9E3779B97F4A7C15 + (h << 6) + (h >> 2)
        h &= 0xFFFFFFFFFFFFFFFF
        h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
        h = (h ^ (h >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
    return h


def mix_unit(*parts: int) -> float:
    """Deterministic uniform in [0, 1) from the mixed parts."""
    return _mix(*parts) / float(1 << 64)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Immutable retry policy, shareable across calls and ranks.

    ``retries`` is the number of RE-executions (0 = never retry); the
    backoff grows exponentially from ``backoff_s`` with a deterministic
    jitter of +/- ``jitter`` of itself."""

    retries: int = 0
    backoff_s: float = 0.05
    backoff_mult: float = 2.0
    backoff_max_s: float = 2.0
    jitter: float = 0.25           # +/- fraction of the computed backoff
    retryable: int = DEFAULT_RETRYABLE
    retry_unknown: bool = False    # opt-in for CALL_OUTCOME_UNKNOWN

    def should_retry(self, error_word: int, attempt: int) -> bool:
        """``attempt`` is 0-based (the attempt that just failed)."""
        if attempt >= self.retries:
            return False
        word = int(error_word)
        if word & int(ErrorCode.CALL_OUTCOME_UNKNOWN) \
                and not self.retry_unknown:
            return False
        if word & int(ErrorCode.PEER_FAILED):
            return False
        if word & int(ErrorCode.DATA_INTEGRITY_ERROR):
            return False
        mask = self.retryable | (int(ErrorCode.CALL_OUTCOME_UNKNOWN)
                                 if self.retry_unknown else 0)
        return bool(word & mask)

    def backoff(self, attempt: int, comm_id: int = 0) -> float:
        """Delay before re-executing attempt ``attempt + 1``."""
        base = min(self.backoff_s * (self.backoff_mult ** attempt),
                   self.backoff_max_s)
        if not self.jitter:
            return base
        u = mix_unit(comm_id, attempt, 0x52E7)  # the same on every rank
        return base * (1.0 - self.jitter + 2.0 * self.jitter * u)


def resolve_policy(retries, retry_policy,
                   default: "RetryPolicy | None") -> "RetryPolicy | None":
    """An explicit ``retry_policy=`` wins; a bare ``retries=N`` wraps the
    driver default (or a fresh policy) with that count; else the driver
    default."""
    if retry_policy is not None:
        return retry_policy
    if retries is not None:
        base = default if default is not None else RetryPolicy()
        return dataclasses.replace(base, retries=int(retries))
    return default
