"""Global configuration: sample rate and error policy.

Copy of ``pygmu2_tpu.core.config`` (stdlib only), itself a rebuild of
rdpoor/pygmu2's config surface (reference: src/pygmu2/config.py:21,32,68).
Same public API:
``set_sample_rate`` must be called before constructing any PE;
``handle_error`` raises in STRICT mode and warns in LENIENT mode.
"""

from __future__ import annotations

import enum
from typing import Type

from pygmu2_tpu_torch.core.logger import get_logger

_log = get_logger(__name__)

_sample_rate: int | None = None


def set_sample_rate(rate: int) -> None:
    """Set the global sample rate in Hz (required before PE construction)."""
    global _sample_rate
    _sample_rate = int(rate)


def get_sample_rate() -> int | None:
    """Return the global sample rate in Hz, or None if unset."""
    return _sample_rate


class ErrorMode(enum.Enum):
    """Framework-wide error policy.

    STRICT (default): every reported error raises.
    LENIENT: non-fatal errors are logged as warnings and execution continues.
    """

    STRICT = "strict"
    LENIENT = "lenient"


_error_mode: ErrorMode = ErrorMode.STRICT


def set_error_mode(mode: ErrorMode) -> None:
    """Set the global error policy."""
    global _error_mode
    _error_mode = mode


def get_error_mode() -> ErrorMode:
    """Return the current global error policy."""
    return _error_mode


def handle_error(
    message: str,
    fatal: bool = False,
    error_mode: ErrorMode | None = None,
    exception_class: Type[Exception] = RuntimeError,
) -> bool:
    """Report an error according to the active error policy.

    Raises ``exception_class`` when ``fatal`` is True or the effective mode is
    STRICT. Otherwise logs a warning and returns True, meaning "continue".
    """
    mode = error_mode if error_mode is not None else _error_mode
    if fatal or mode is ErrorMode.STRICT:
        raise exception_class(message)
    _log.warning(message)
    return True
