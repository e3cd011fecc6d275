"""The reference's token signatures (``token_api``)."""

from . import token_api  # noqa: F401
