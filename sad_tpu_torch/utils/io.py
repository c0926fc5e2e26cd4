"""Object serialization and weights-URL caching (a copy of
sad_tpu/utils/io.py; ref detectron/lib/utils/io.py:36-144)."""

from __future__ import annotations

import hashlib
import os
import pickle
import re
import shutil
import sys
import urllib.request
from typing import Any

_URL_RE = re.compile(r"^(?:https?)://", re.IGNORECASE)


def save_object(obj: Any, file_name: str) -> None:
    """Pickle to file (io.py save_object)."""
    os.makedirs(os.path.dirname(file_name) or ".", exist_ok=True)
    tmp = file_name + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f, pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, file_name)


def load_object(file_name: str) -> Any:
    with open(file_name, "rb") as f:
        return pickle.load(f, encoding="latin1")


def is_url(path: str) -> bool:
    return bool(_URL_RE.match(path))


def cache_url(url: str, cache_dir: str) -> str:
    """Download-once URL weight caching (io.py cache_url): the cached file
    name embeds a hash of the URL, and a file already there is returned
    without touching the network. On a machine without network access only
    that path can succeed: place the file in ``cache_dir`` first."""
    if not is_url(url):
        return url
    digest = hashlib.md5(url.encode()).hexdigest()[:12]
    base = os.path.basename(url)
    cached = os.path.join(cache_dir, f"{digest}_{base}")
    if os.path.exists(cached):
        return cached
    os.makedirs(cache_dir, exist_ok=True)
    sys.stderr.write(f"Downloading {url} -> {cached}\n")
    with urllib.request.urlopen(url) as r, open(cached + ".tmp", "wb") as f:
        shutil.copyfileobj(r, f)
    os.replace(cached + ".tmp", cached)
    return cached
