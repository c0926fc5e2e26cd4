"""JSON-line stats logging (ref: detectron/lib/utils/logging.py:35).

A copy of sad_tpu/utils/logging.py.
"""

from __future__ import annotations

import json
import logging
import sys


def log_json_stats(stats: dict, sort_keys: bool = True) -> None:
    print("json_stats: {:s}".format(json.dumps(stats, sort_keys=sort_keys)))
    sys.stdout.flush()


def setup_logging(name: str) -> logging.Logger:
    fmt = "%(levelname)s %(filename)s:%(lineno)4d: %(message)s"
    logging.root.handlers = []
    logging.basicConfig(level=logging.INFO, format=fmt, stream=sys.stdout)
    return logging.getLogger(name)
