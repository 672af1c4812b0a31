"""
The JSON training logs (``training.json``): copy of the writer and reader of
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
