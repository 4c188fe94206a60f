"""Scoped logging for the port: the ``gsplat_tpu_torch`` logger gets its own
handler with the reference's ``pathname:lineno`` format, instead of
configuring the root logger. Only rank 0 of a ``torch.distributed`` job
logs below ERROR."""

from __future__ import annotations

import logging

import torch

_FORMAT = "[%(asctime)s] %(levelname)s [%(pathname)s:%(lineno)d] - %(message)s"
_DATEFMT = "%m-%d %H:%M:%S"


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def get_logger(name: str = "gsplat_tpu_torch", level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt=_DATEFMT))
        logger.addHandler(handler)
        logger.propagate = False
    logger.setLevel(level if _rank() == 0 else logging.ERROR)
    return logger


def log_metrics(logger: logging.Logger, step: int, metrics: dict) -> None:
    """One INFO line: ``step=<step>`` then ``key=value`` for each metric,
    keys sorted, values as ``{:.5g}`` (the JAX package's text)."""
    parts = " ".join(f"{k}={float(v):.5g}" for k, v in sorted(metrics.items()))
    logger.info("step=%d %s", step, parts)
