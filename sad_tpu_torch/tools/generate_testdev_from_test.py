"""Filter the detections of the whole test set down to the test-dev images
(a copy of sad_tpu/tools/generate_testdev_from_test.py; ref
detectron/tools/generate_testdev_from_test.py).

Usage:
  python -m sad_tpu_torch.tools.generate_testdev_from_test \
      --results test_results.json --testdev-ann image_info_test-dev2017.json \
      --output testdev_results.json
"""

from __future__ import annotations

import argparse
import json

from sad_tpu_torch.utils.logging import setup_logging

logger = setup_logging("generate_testdev")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--results", required=True)
    p.add_argument("--testdev-ann", required=True)
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)

    with open(args.results) as f:
        dets = json.load(f)
    with open(args.testdev_ann) as f:
        ids = {im["id"] for im in json.load(f)["images"]}
    out = [d for d in dets if d["image_id"] in ids]
    with open(args.output, "w") as f:
        json.dump(out, f)
    logger.info(
        "%d of %d detections fall in the %d test-dev images -> %s",
        len(out), len(dets), len(ids), args.output,
    )


if __name__ == "__main__":
    main()
