from . import errors, log
from .errors import LuminaryError
from .log import error_message, info_message, log_message, warn_message
