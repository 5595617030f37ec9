"""Grid sweeps. Reference tramp/experiments/multiple_experiments.py.

The sequential loop is kept for API parity; the vectorized path
(vmapped/sharded sweeps) lives in tramp_tpu.parallel."""
import itertools
import logging

import numpy as np
import pandas as pd

logger = logging.getLogger(__name__)


def log_on_progress(i, total):
    logger.info(f"experiment {i}/{total}")


def as_list(x):
    if isinstance(x, list):
        return x
    if isinstance(x, np.ndarray):
        return list(x)
    return [x]


def get_experiments_from_kwargs(**kwargs):
    coerced = {key: as_list(val) for key, val in kwargs.items()}
    return [
        dict(zip(coerced.keys(), values))
        for values in itertools.product(*coerced.values())
    ]


def run_experiments(run, on_progress=None, **kwargs):
    on_progress = on_progress or log_on_progress
    experiments = get_experiments_from_kwargs(**kwargs)
    records = []
    for idx, experiment in enumerate(experiments):
        record = experiment.copy()
        try:
            results = run(**experiment)
            if isinstance(results, dict):
                results = [results]
            for result in results:
                result.update(record)
            records += results
        except Exception as e:
            logger.error(f"Experiment {experiment} failed\n{e}")
        on_progress(idx + 1, len(experiments))
    return pd.DataFrame(records)


def simple_run_experiments(run, **kwargs):
    "Same as run_experiments but raises on error."
    experiments = get_experiments_from_kwargs(**kwargs)
    records = []
    for experiment in experiments:
        record = experiment.copy()
        results = run(**experiment)
        if isinstance(results, dict):
            results = [results]
        for result in results:
            result.update(record)
        records += results
    return pd.DataFrame(records)


def save_experiments(run, csv_file, on_progress=None, **kwargs):
    df = run_experiments(run, on_progress, **kwargs)
    df.to_csv(csv_file, index=False)
    return df
