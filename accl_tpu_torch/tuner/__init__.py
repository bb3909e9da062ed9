"""Autotuner: cost-model + measurement-driven algorithm & segment-size
selection. The port of ``accl_tpu/tuner``.

Three layers:

* :mod:`~accl_tpu_torch.tuner.cost` — alpha-beta analytic cost models per
  (collective, algorithm) over a :class:`Topology` descriptor each device
  backend exposes (``Device.topology()``);
* :mod:`~accl_tpu_torch.tuner.tuner` — the thread-safe :class:`Tuner` resolving
  ``AUTO`` per (op, world_size, nbytes-bucket), refined online from
  retire-time measurements, with epsilon-greedy exploration and segment-
  size recommendation;
* :mod:`~accl_tpu_torch.tuner.cache` — versioned JSON tuning tables
  (``ACCL_TPU_TUNING_CACHE``) in the reference's format;
* :mod:`~accl_tpu_torch.tuner.sweep` — their producer on this tier:
  ``run_tune`` forces every legal algorithm over ``cuda_world`` and saves
  the measured table.

Attach with ``ACCL(device, comm, tuner=Tuner())``.
"""

from . import cache, sweep
from .cost import Topology, predict_us, rank_algorithms, \
    recommend_segment_size
from .tuner import Tuner, nbytes_bucket

__all__ = ["Topology", "Tuner", "cache", "nbytes_bucket", "predict_us",
           "rank_algorithms", "recommend_segment_size", "sweep"]
