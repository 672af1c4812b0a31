"""
Hyper-parameters of a model as the JAX package records them
(``neural_imaging_tpu/utils/paramspec.py``): each name has a default and a
type, values are set with ``update`` and cast to that type, and the logs
keep ``to_json()`` (the ``args`` of ``training.json``) and the models'
``repr`` lists ``changed_params()``. The port's constructors validate their
arguments themselves, so the specs here carry no ranges.
"""
import numpy as np

from neural_imaging_tpu_torch.utils.utils import is_number


class ParamSpec:

    def __init__(self, specs):
        """``specs``: {name: (default, type)}."""
        self.__dict__['_specs'] = dict(specs)
        self.__dict__['_values'] = {}

    def add(self, specs):
        """Declare more names: {name: (default, type)}."""
        self._specs.update(specs)

    def __getattr__(self, name):
        if name.startswith('_'):
            raise AttributeError(name)
        if name in self._values:
            return self._values[name]
        if name in self._specs:
            return self._specs[name][0]
        raise KeyError(name)

    def __setattr__(self, key, value):
        raise ValueError('Values cannot be set directly — use update().')

    def update(self, **params):
        """Set values (cast to their type); a value of None keeps the default."""
        for key, value in params.items():
            if key not in self._specs:
                raise ValueError(f'Unexpected parameter: {key}!')
            if value is None:
                continue
            if is_number(value) and np.isnan(value):
                raise ValueError(f'Invalid value {value} for attribute {key}')
            dtype = self._specs[key][1]
            self._values[key] = value if dtype is None else dtype(value)
        return self

    def to_dict(self):
        params = {key: spec[0] for key, spec in self._specs.items()}
        params.update(self._values)
        return params

    def to_json(self):
        """The values, with anything but numbers, bools, strings and None as str."""
        return {k: v if is_number(v) or isinstance(v, (bool, str)) or v is None else str(v)
                for k, v in self.to_dict().items()}

    def changed_params(self):
        return {k: v for k, v in self._values.items() if self._specs[k][0] != v}
