"""Wire codecs: JSON (reference-compatible) and packed arrays."""
from . import json_codec
