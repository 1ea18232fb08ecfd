from .paths import db_paths  # noqa: F401
from .yaml_store import RecordStore  # noqa: F401
