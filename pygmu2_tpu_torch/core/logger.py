"""Logging helpers.

Copy of ``pygmu2_tpu.core.logger`` (stdlib only), itself a rebuild of the
logging surface of rdpoor/pygmu2 (reference: src/pygmu2/logger.py:13,55).
The port logs under its own ``pygmu2_tpu_torch`` namespace.
"""

from __future__ import annotations

import logging
import sys

_DEFAULT_FORMAT = "%(levelname)s:%(name)s:%(message)s"
_configured = False


def set_global_logging(level: int | str = logging.WARNING, fmt: str | None = None) -> None:
    """Configure root logging for the whole framework.

    Args:
        level: logging level (int or name, e.g. "DEBUG").
        fmt: optional format string for the handler.
    """
    global _configured
    if isinstance(level, str):
        level = getattr(logging, level.upper())
    root = logging.getLogger("pygmu2_tpu_torch")
    root.setLevel(level)
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(fmt or _DEFAULT_FORMAT))
        root.addHandler(handler)
        root.propagate = False
        _configured = True
    elif fmt is not None:
        for handler in root.handlers:
            handler.setFormatter(logging.Formatter(fmt))


def get_logger(name: str) -> logging.Logger:
    """Return a child logger under the framework's namespace."""
    if not name.startswith("pygmu2_tpu_torch"):
        name = f"pygmu2_tpu_torch.{name}"
    return logging.getLogger(name)
