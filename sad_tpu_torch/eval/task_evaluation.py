"""Result aggregation + expected-results assertions.

Capability-equivalent to detectron/lib/datasets/task_evaluation.py: collect
per-task metric dicts keyed by dataset, and check them against
cfg.EXPECTED_RESULTS with rtol/atol (the reference's post-training quality
gate, config.py:966-973 — its only 'test suite' on the Detectron side,
SURVEY.md §4).

A copy of sad_tpu/eval/task_evaluation.py."""

from __future__ import annotations

import logging
from typing import Dict, List

from ..config import Config

logger = logging.getLogger(__name__)

# metric key aliases matching the reference's result naming
_METRIC_ALIASES = {
    "AP": "AP",
    "AP50": "AP50",
    "AP75": "AP75",
    "APs": "APs",
    "APm": "APm",
    "APl": "APl",
    "box_ap": "AP",
    "mask_ap": "AP",
}


def aggregate_results(
    per_dataset: Dict[str, Dict[str, Dict[str, float]]]
) -> Dict[str, Dict[str, Dict[str, float]]]:
    """{dataset: {task: {metric: value}}} passthrough with logging."""
    for ds, tasks in per_dataset.items():
        for task, metrics in tasks.items():
            logger.info("%s / %s: %s", ds, task, metrics)
    return per_dataset


class ExpectedResultsError(AssertionError):
    pass


def check_expected_results(
    cfg: Config,
    results: Dict[str, Dict[str, Dict[str, float]]],
    raise_on_failure: bool = True,
) -> List[str]:
    """Compare results to cfg.EXPECTED_RESULTS tuples
    (dataset, task, metric, expected_value) within EXPECTED_RESULTS_RTOL/
    ATOL (ref: task_evaluation.py check_expected_results). Returns failure
    messages (empty = all pass)."""
    failures = []
    for spec in cfg.EXPECTED_RESULTS:
        dataset, task, metric, expected = spec
        metric = _METRIC_ALIASES.get(metric, metric)
        try:
            actual = results[dataset][task][metric]
        except KeyError:
            failures.append(f"missing result for {dataset}/{task}/{metric}")
            continue
        err = abs(actual - expected)
        tol = cfg.EXPECTED_RESULTS_ATOL + cfg.EXPECTED_RESULTS_RTOL * abs(expected)
        ok = err <= tol
        msg = (
            f"{dataset}/{task}/{metric}: actual {actual:.6f} vs expected "
            f"{expected:.6f} (err {err:.6f}, tol {tol:.6f})"
        )
        if ok:
            logger.info("EXPECTED_RESULTS pass: %s", msg)
        else:
            logger.error("EXPECTED_RESULTS FAIL: %s", msg)
            failures.append(msg)
    if failures and raise_on_failure:
        raise ExpectedResultsError("; ".join(failures))
    return failures
