"""Logging helpers (own copy of `curobo_tpu/util/logging.py`)."""

from __future__ import annotations

import logging
import warnings
from functools import wraps

_logger = logging.getLogger("curobo_tpu_torch")


def setup_logger(level="info"):
    lv = getattr(logging, level.upper()) if isinstance(level, str) else level
    logging.basicConfig(
        level=lv, format="%(asctime)s [curobo-tpu-torch] %(levelname)s: %(message)s"
    )
    _logger.setLevel(lv)
    return _logger


def log_info(msg, *args):
    _logger.info(msg, *args)


def log_warn(msg, *args):
    _logger.warning(msg, *args)


def log_debug(msg, *args):
    _logger.debug(msg, *args)


def log_error(msg, *args):
    _logger.error(msg, *args)


def log_and_raise(exc_type, msg):
    """Universal error path (parity: `log_and_raise:75`)."""
    _logger.error(msg)
    raise exc_type(msg)


def deprecated(reason: str):
    """Decorator marking deprecated API (parity: `deprecated:109`)."""

    def wrap(fn):
        @wraps(fn)
        def inner(*args, **kwargs):
            warnings.warn(
                f"{fn.__qualname__} is deprecated: {reason}",
                DeprecationWarning,
                stacklevel=2,
            )
            return fn(*args, **kwargs)

        return inner

    return wrap
