"""Logging set-up for the runners: the console format of the reference's
log4j2 pattern (logger, function and line) through stdlib logging."""

from __future__ import annotations

import logging

_FORMAT = (
    "%(asctime)s %(levelname)-5s [%(name)s.%(funcName)s:%(lineno)d] %(message)s"
)
_configured = False


def configure(level: int | str = "INFO") -> None:
    """Install the format on the root logger, once per process."""
    global _configured
    if _configured:
        return
    logging.basicConfig(level=level, format=_FORMAT)
    _configured = True


def get_logger(name: str) -> logging.Logger:
    configure()
    return logging.getLogger(name)
