"""JSON-line stats logging (ref: detectron/lib/utils/logging.py:35).

A copy of sad_tpu/utils/logging.py. Over W ranks (torchrun's RANK and
WORLD_SIZE) rank 0 logs at INFO and the others at WARNING and above, each
line naming its rank.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import Optional


def log_json_stats(stats: dict, sort_keys: bool = True) -> None:
    print("json_stats: {:s}".format(json.dumps(stats, sort_keys=sort_keys)))
    sys.stdout.flush()


def setup_logging(name: str, rank: Optional[int] = None,
                  world: Optional[int] = None) -> logging.Logger:
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world = int(os.environ.get("WORLD_SIZE", 1)) if world is None else world
    fmt = "%(levelname)s %(filename)s:%(lineno)4d: %(message)s"
    level = logging.INFO
    if world > 1:
        fmt = f"[rank {rank}] " + fmt
        level = logging.INFO if rank == 0 else logging.WARNING
    logging.root.handlers = []
    logging.basicConfig(level=level, format=fmt, stream=sys.stdout)
    return logging.getLogger(name)
