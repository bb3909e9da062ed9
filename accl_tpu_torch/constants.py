"""Operation codes, flags and error codes of the ACCL call surface.

The port's own copy of ``accl_tpu/constants.py``, trimmed to what the
dense-collective slice uses. Numeric values are identical, so a
descriptor means the same thing in both packages.
"""

from __future__ import annotations

import enum


class CCLOp(enum.IntEnum):
    """Primitive and collective operations accepted by a device backend."""

    config = 0
    copy = 1
    combine = 2
    send = 3
    recv = 4
    bcast = 5
    scatter = 6
    gather = 7
    reduce = 8
    allgather = 9
    allreduce = 10
    reduce_scatter = 11
    barrier = 12
    alltoall = 13
    put = 14
    get = 15
    alltoallv = 16
    nop = 255


class CfgFunc(enum.IntEnum):
    """Sub-functions of ``CCLOp.config`` (subfunction in ``tag``, value in
    ``count``)."""

    reset_periph = 0
    enable_pkt = 1
    set_timeout = 2
    open_port = 3
    open_con = 4
    set_stack_type = 5
    set_max_segment_size = 6
    close_con = 7
    start_profiling = 8
    end_profiling = 9


class ReduceFunc(enum.IntEnum):
    """Elementwise reduction functions."""

    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3


class Compression(enum.IntFlag):
    """Wire/operand precision-reduction flags. ``BLOCK_SCALED`` is only
    meaningful with ``ETH_COMPRESSED``: the wire then carries per-block
    f32 scales beside fp8/int8 codes."""

    NONE = 0
    OP0_COMPRESSED = 1
    OP1_COMPRESSED = 2
    RES_COMPRESSED = 4
    ETH_COMPRESSED = 8
    BLOCK_SCALED = 16


class StreamFlags(enum.IntFlag):
    """Operand streaming flags: OP0_STREAM takes the first operand from
    the rank's stream-in port, RES_STREAM puts the result on its
    stream-out port (on a send: the peer's stream-in port). Only the
    local and point-to-point ops stream; a streamed collective is
    refused."""

    NO_STREAM = 0
    OP0_STREAM = 1
    RES_STREAM = 2


class CollectiveAlgorithm(enum.IntEnum):
    """Per-call collective algorithm selector."""

    AUTO = 0
    RING = 1
    ROUND_ROBIN = 2
    TREE = 3
    FUSED_RING = 4
    NON_FUSED = 5
    RECURSIVE_DOUBLING = 6
    HIERARCHICAL = 7


# Which algorithms each collective accepts (AUTO is always legal); the
# same table as the reference, so invalid pairs fail identically.
VALID_ALGORITHMS: dict[str, frozenset] = {
    "bcast": frozenset({CollectiveAlgorithm.ROUND_ROBIN,
                        CollectiveAlgorithm.TREE,
                        CollectiveAlgorithm.HIERARCHICAL}),
    "scatter": frozenset({CollectiveAlgorithm.ROUND_ROBIN}),
    "gather": frozenset({CollectiveAlgorithm.RING,
                         CollectiveAlgorithm.ROUND_ROBIN,
                         CollectiveAlgorithm.TREE}),
    "reduce": frozenset({CollectiveAlgorithm.RING,
                         CollectiveAlgorithm.ROUND_ROBIN,
                         CollectiveAlgorithm.TREE}),
    "allgather": frozenset({CollectiveAlgorithm.RING,
                            CollectiveAlgorithm.ROUND_ROBIN,
                            CollectiveAlgorithm.RECURSIVE_DOUBLING,
                            CollectiveAlgorithm.HIERARCHICAL}),
    "allreduce": frozenset({CollectiveAlgorithm.RING,
                            CollectiveAlgorithm.FUSED_RING,
                            CollectiveAlgorithm.NON_FUSED,
                            CollectiveAlgorithm.RECURSIVE_DOUBLING,
                            CollectiveAlgorithm.HIERARCHICAL}),
    "reduce_scatter": frozenset({CollectiveAlgorithm.RING,
                                 CollectiveAlgorithm.RECURSIVE_DOUBLING,
                                 CollectiveAlgorithm.HIERARCHICAL}),
}


def check_algorithm(scenario_name: str, algorithm) -> None:
    """Raise ValueError unless (scenario, algorithm) is a legal pair."""
    if algorithm == CollectiveAlgorithm.AUTO:
        return
    valid = VALID_ALGORITHMS.get(scenario_name)
    if valid is None:
        raise ValueError(
            f"{scenario_name} has no algorithm variants; only "
            f"CollectiveAlgorithm.AUTO is accepted, got "
            f"{CollectiveAlgorithm(algorithm).name}")
    if algorithm not in valid:
        raise ValueError(
            f"{scenario_name} does not support algorithm "
            f"{CollectiveAlgorithm(algorithm).name}; valid: "
            f"{sorted(a.name for a in valid)}")


class ErrorCode(enum.IntFlag):
    """Errors raised by execution engines; OR-able."""

    COLLECTIVE_OP_SUCCESS = 0
    DMA_MISMATCH_ERROR = 1 << 0
    DMA_TRANSACTION_ERROR = 1 << 1
    ARITH_ERROR = 1 << 2
    PACK_TIMEOUT_STS_ERROR = 1 << 3
    PACK_SEQ_NUMBER_ERROR = 1 << 4
    COMPRESSION_ERROR = 1 << 5
    KRNL_TIMEOUT_STS_ERROR = 1 << 6
    KRNL_STS_COUNT_ERROR = 1 << 7
    RECEIVE_TIMEOUT_ERROR = 1 << 8
    RECEIVE_OFFCHIP_SPARE_BUFF_ID_NOT_VALID = 1 << 9
    RECEIVE_SPARE_BUFF_STATUS_ERROR = 1 << 10
    RECEIVE_SPARE_BUFF_DMA_TAG_MISMATCH = 1 << 11
    DMA_SIZE_ERROR = 1 << 12
    OPEN_PORT_NOT_SUCCEEDED = 1 << 13
    OPEN_CON_NOT_SUCCEEDED = 1 << 14
    COMM_NOT_CONFIGURED = 1 << 15
    ARITHCFG_NOT_CONFIGURED = 1 << 16
    COMPRESSION_NOT_SUPPORTED = 1 << 17
    STREAM_NOT_SUPPORTED = 1 << 18
    COLLECTIVE_NOT_IMPLEMENTED = 1 << 19
    RECEIVE_OFFCHIP_SPARE_BUFF_OVERFLOW = 1 << 20
    CONNECTION_CLOSED = 1 << 21
    DEVICE_NOT_READY = 1 << 22
    INVALID_CALL = 1 << 23
    CALL_OUTCOME_UNKNOWN = 1 << 24
    TENANT_QUOTA_EXCEEDED = 1 << 25
    FABRIC_QUEUE_OVERFLOW = 1 << 26
    PEER_FAILED = 1 << 27
    CALL_RETRIES_EXHAUSTED = 1 << 28
    RMA_WINDOW_ERROR = 1 << 29
    JOIN_FAILED = 1 << 30
    DATA_INTEGRITY_ERROR = 1 << 31


class ACCLError(Exception):
    """Host-side exception carrying the OR-ed device error word."""

    def __init__(self, error_word: int, context: str = ""):
        self.error_word = int(error_word)
        self.errors = decode_error(error_word)
        names = " | ".join(e.name for e in self.errors) or hex(self.error_word)
        super().__init__(
            f"ACCL call failed{' in ' + context if context else ''}: {names}")


def decode_error(error_word: int) -> list[ErrorCode]:
    """Split an OR-ed error word into its individual error codes."""
    return [e for e in ErrorCode if e != ErrorCode.COLLECTIVE_OP_SUCCESS
            and error_word & e.value]


DEFAULT_TIMEOUT_S = 30.0
TAG_ANY = 0xFFFFFFFF
