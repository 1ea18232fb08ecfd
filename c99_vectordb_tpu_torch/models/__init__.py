"""Index families of the port."""

from .base import VectorIndex  # noqa: F401
from .flat import FlatIndex  # noqa: F401
from .ivf_flat import IVFFlatIndex  # noqa: F401
