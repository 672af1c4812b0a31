"""
The JSON training logs (``training.json`` of a joint run, ``progress.json``
of a NIP's): copy of the writers and readers of
``neural_imaging_tpu/utils/jsonlog.py``. The schema is shared with the JAX
package, whose results tooling and ``test_fan.py`` read the port's logs.
"""
import json
import os

import numpy as np
import torch


def _to_jsonable(obj):
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return obj.tolist()          # a 0-d array or tensor gives its number
    return obj


def save_json(payload, filename):
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    with open(filename, 'w') as f:
        json.dump(_to_jsonable(payload), f, indent=4)


def load_json(filename):
    with open(filename) as f:
        return json.load(f)


def save_progress(model, training_summary, out_directory):
    """Write ``progress.json`` with the reference's schema: {performance,
    args, model, init, summary}; returns what it wrote."""
    payload = {
        'performance': model.performance,
        'args': model.get_hyperparameters(),
        'model': model.class_name,
        'init': repr(model),
        'summary': _to_jsonable(training_summary),
    }
    save_json(payload, os.path.join(out_directory, 'progress.json'))
    return payload


def load_progress(out_directory):
    return load_json(os.path.join(out_directory, 'progress.json'))
