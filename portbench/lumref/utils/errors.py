"""Error types for Luminary-TPU.

The reference propagates ``LuminaryResult`` u64 error codes through every call
(reference: include/luminary/error.h:18-80). In Python we use an exception
hierarchy instead; the class names mirror the reference's error categories so
embedders can map between the two.
"""

from __future__ import annotations


class LuminaryError(Exception):
    """Base class for all Luminary-TPU errors."""


class ArgumentNullError(LuminaryError):
    """A required argument was None (reference: LUMINARY_ERROR_ARGUMENT_NULL)."""


class InvalidAPIArgumentError(LuminaryError):
    """An argument had an invalid value (LUMINARY_ERROR_INVALID_API_ARGUMENT)."""


class NotImplementedYetError(LuminaryError):
    """Feature exists in the API surface but is not implemented yet."""


class OutOfMemoryError(LuminaryError):
    """Host or device allocation failed (LUMINARY_ERROR_OUT_OF_MEMORY)."""


class FileIOError(LuminaryError):
    """Scene/asset file could not be read or parsed (LUMINARY_ERROR_C_STD)."""


class PreconditionError(LuminaryError):
    """API call made in a state where it is not legal (LUMINARY_ERROR_PRECONDITION)."""


def check_not_none(value, name: str):
    if value is None:
        raise ArgumentNullError(f"argument '{name}' must not be None")
    return value
