"""A list of image paths and labels (a copy of
sad_tpu/data/image_list_dataset.py; ref
detectron/lib/datasets/image_list_dataset.py).

Classification-style entries from a text file of 'relative/path label'
lines: the reference's combined_label_for_traning reads them (roidb.py:
79-87); train_net imports it but the SAD path does not use it."""

from __future__ import annotations

import os
from typing import List


class ImageListDataset:
    def __init__(self, list_file: str, image_directory: str = ""):
        self.list_file = list_file
        self.image_directory = image_directory
        self.entries: List[dict] = []
        with open(list_file) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                rel = parts[0]
                label = int(parts[1]) if len(parts) > 1 else -1
                self.entries.append(
                    {
                        "image": os.path.join(image_directory, rel),
                        "file_name": rel,
                        "label": label,
                    }
                )

    def __len__(self) -> int:
        return len(self.entries)

    def get_roidb(self) -> List[dict]:
        return list(self.entries)
