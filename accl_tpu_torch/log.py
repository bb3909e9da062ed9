"""Package-level logging: one ``accl_tpu_torch`` logger hierarchy,
rank-tagged.

Ranks run as threads of one process, so every library log site goes
through ``get_logger(...)`` and carries the owning rank; embedders
capture or silence the package with one
``logging.getLogger("accl_tpu_torch")`` handle. No handler is installed
at import; ``basic_config()`` opts into a rank-tagged stderr handler.
"""

from __future__ import annotations

import logging

__all__ = ["get_logger", "basic_config", "RankTagFilter"]

ROOT_NAME = "accl_tpu_torch"


def get_logger(subname: str | None = None) -> logging.Logger:
    """The package logger, or the ``accl_tpu_torch.<subname>`` child.
    Accepts a ``__name__`` already under the package unchanged."""
    if not subname:
        return logging.getLogger(ROOT_NAME)
    if subname.startswith(ROOT_NAME):
        return logging.getLogger(subname)
    return logging.getLogger(f"{ROOT_NAME}.{subname}")


class RankTagFilter(logging.Filter):
    """Guarantees every record has a ``rank`` attribute."""

    def filter(self, record: logging.LogRecord) -> bool:
        if not hasattr(record, "rank"):
            record.rank = "-"
        return True


def basic_config(level: int = logging.INFO) -> logging.Logger:
    """Install a rank-tagged stderr handler on the package logger
    (idempotent)."""
    logger = logging.getLogger(ROOT_NAME)
    if not any(getattr(h, "_accl_tagged", False) for h in logger.handlers):
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s accl_tpu_torch r%(rank)s] %(levelname)s "
            "%(name)s: %(message)s"))
        handler.addFilter(RankTagFilter())
        handler._accl_tagged = True
        logger.addHandler(handler)
        logger.propagate = False
    logger.setLevel(level)
    return logger
