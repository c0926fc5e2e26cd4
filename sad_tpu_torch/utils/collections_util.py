"""AttrDict (a copy of sad_tpu/utils/collections_util.py; ref
detectron/lib/utils/collections.py): an attribute-style dict for scripts
ported from the reference; the port's own config is immutable
dataclasses."""

from __future__ import annotations


class AttrDict(dict):
    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value
